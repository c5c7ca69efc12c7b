// Batched 1D CTC prefix beam search: the forward beam over all T steps,
// version 2 (parent-hash identity), the default of the main path.
//
// Replaces: fast_ctc_decode_tpu/ops/beam_pallas.py::_beam_kernel2 (the fused
// T-loop Pallas kernel behind beam_search_pallas_batch(version=2)).  The
// kernel body, its three versions, its design, its bounds on this card and
// its bit-parity rules are in beam_core.cuh, shared with versions 1 and 3
// (beam_v1_kernel.cu, beam_v3_kernel.cu), the ablation kernel and the CRF
// kernel; this file holds the version-2 instances and their C entry point.
//
// Two instances: <5, 4> for the main path (beam 5 over "NACGT") and every
// smaller shape, <16, 7> for the rest up to beam 16 and A+1 = 8.

#include "beam_core.cuh"

extern "C" {

// Launch the forward beam on `stream`.  probs [B, T, A+1] f32, lengths [B],
// ids_log [T, K, B], fin [B], err [B] (i32, device memory, allocated by the
// caller).  Returns the launch's cudaError_t (0 = launched).
int ctc_beam_ids_launch(const float* probs, const int* lengths, float thr,
                        int B, int T, int A, int K, int collapse, int* ids_log,
                        int* fin, int* err, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 5 && A <= 4)
    return launch_beam_ids<5, 4, false, 2>(probs, nullptr, lengths, thr, B, T, 1, 1, A,
                                           K, collapse, ids_log, fin, err, s);
  if (K <= 16 && A <= 7)
    return launch_beam_ids<16, 7, false, 2>(probs, nullptr, lengths, thr, B, T, 1, 1, A,
                                            K, collapse, ids_log, fin, err, s);
  return cudaErrorInvalidValue;
}

const char* ctc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
