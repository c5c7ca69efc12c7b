// Batched traceback of the beam's id log into leaf-first labels and times.
//
// Replaces: fast_ctc_decode_tpu/ops/beam_pallas.py::_traceback_kernel (the
// backward id-log sweep that packs (no-emit, step, label+1) keys) together
// with the key sort that follows it (beam_fast._sort_unpack_keys).  Output
// equals the plain engine's sorted-key form, and its 3-operand stable-sort
// fallback, exactly: labels_rev[b, n] / times_rev[b, n] hold the emits
// leaf-first, the rest of each row is -1, and count[b] is the number of
// emits.
//
// Design: one thread per read.  A node id is t*K*A + k*A + a, so the thread
// jumps from the final id straight to each node's creation step t, emits
// (a, t), and reads its parent, the entry id of slot k at step t:
// ids_log[t, k, b].  The TPU swept every step because it avoids gathers;
// this walk touches one id per emitted node and needs no sort.  A parent is
// always created at a strictly earlier step; the walk stops at the root
// (-1), an empty slot (-2), or a step that does not decrease, which is what
// the sweep form does on any log.
//
// What bounds it on this card: the dependent loads of the walk (each parent
// id is the address of the next load, one uncached global read per emitted
// node) and the row-strided stores of labels_rev / times_rev, which do not
// coalesce across a warp.  The simple design leaves both: the loads of the
// B threads of the grid overlap one another.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
traceback_kernel(const int* __restrict__ fin, const int* __restrict__ ids_log,
                 int B, int T, int K, int A, int* __restrict__ labels_rev,
                 int* __restrict__ times_rev, int* __restrict__ count) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int KA = K * A;
  int* lab_row = labels_rev + (size_t)b * T;
  int* t_row = times_rev + (size_t)b * T;
  int cur = fin[b];
  int prev_t = T;
  int n = 0;
  while (cur >= 0) {
    const int t = cur / KA;
    if (t >= prev_t) break;
    const int r = cur - t * KA;
    const int k = r / A;
    lab_row[n] = r - k * A;
    t_row[n] = t;
    ++n;
    prev_t = t;
    cur = ids_log[((size_t)t * K + k) * B + b];
  }
  count[b] = n;
  for (int i = n; i < T; ++i) {
    lab_row[i] = -1;
    t_row[i] = -1;
  }
}

}  // namespace

extern "C" {

// Launch the traceback on `stream`.  fin [B], ids_log [T, K, B] in; outputs
// labels_rev [B, T], times_rev [B, T], count [B]; all i32 device memory
// allocated by the caller.  Returns the launch's cudaError_t (0 = launched).
int ctc_traceback_launch(const int* fin, const int* ids_log, int B, int T,
                         int K, int A, int* labels_rev, int* times_rev,
                         int* count, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((B + kBlock - 1) / kBlock);
  traceback_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      fin, ids_log, B, T, K, A, labels_rev, times_rev, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
