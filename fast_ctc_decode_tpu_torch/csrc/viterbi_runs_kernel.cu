// Viterbi run means in frame order: one thread per (read, run).
//
// No Pallas counterpart: the JAX package leaves this sum to XLA
// (jax.ops.segment_sum in fast_ctc_decode_tpu/ops/viterbi.py::viterbi_device).
// It computes what fast_ctc_decode_tpu_torch/ops/viterbi_cuda.py::
// run_means_plain computes, bit for bit: for run j of a read (the frames
// from its j-th emitting frame up to the next one), the f32 sum of its
// non-blank frames' max probabilities added left to right from 0.0,
// divided (true division) by their count, at least 1; 0 for the runs past
// the read's emit count.  A scatter-add on the card adds with atomics in no
// fixed order, so its last bits, and a phred character, could change from
// call to call; this kernel adds in the CPU's and XLA's order.  Blank
// frames add +0.0 there, which leaves a sum that starts at +0.0 unchanged
// (it is never -0.0), so they are skipped here.
//
// What bounds it on this card: bytes.  The runs are independent, so each
// thread walks one run (a few frames) and the threads of a warp read
// neighbouring frames; every frame is read once, every mean written once.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

// labels [B, T] i32 and pmax [B, T] f32 (frames past a read's length masked
// to label 0 by the caller), path [B, T] i32 (emitting frames,
// front-packed), n [B] i32 (emits per read); mean [B, T] f32.
__global__ void __launch_bounds__(kBlock)
viterbi_run_means_kernel(const int* __restrict__ labels, const float* __restrict__ pmax,
                         const int* __restrict__ path, const int* __restrict__ n,
                         int B, int T, float* __restrict__ mean) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * T) return;
  const int b = (int)(i / T), j = (int)(i % T);
  const size_t off = (size_t)b * (size_t)T;
  const int nb = n[b];
  float out = 0.f;
  if (j < nb) {
    const int end = j + 1 < nb ? path[off + j + 1] : T;
    float sum = 0.f, cnt = 0.f;
    for (int t = path[off + j]; t < end; ++t) {
      if (labels[off + t] != 0) {
        sum = __fadd_rn(sum, pmax[off + t]);
        cnt = __fadd_rn(cnt, 1.f);
      }
    }
    out = __fdiv_rn(sum, cnt < 1.f ? 1.f : cnt);
  }
  mean[i] = out;
}

}  // namespace

extern "C" {

// Launch the run means on `stream`: labels, path [B, T] i32, pmax [B, T]
// f32, n [B] i32, mean [B, T] f32 (device memory allocated by the caller).
// Returns the launch's cudaError_t (0 = launched).
int ctc_viterbi_run_means_launch(const int* labels, const float* pmax, const int* path,
                                 const int* n, int B, int T, float* mean, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const long long threads = (long long)B * T;
  const dim3 grid((unsigned)((threads + kBlock - 1) / kBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  viterbi_run_means_kernel<<<grid, kBlock, 0, s>>>(labels, pmax, path, n, B, T, mean);
  return cudaGetLastError();
}

}  // extern "C"
