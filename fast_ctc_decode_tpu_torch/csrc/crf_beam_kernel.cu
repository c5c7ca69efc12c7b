// Batched CRF prefix beam search: the forward beam over all T steps.
//
// Replaces: fast_ctc_decode_tpu/ops/beam_pallas.py::_crf_beam_kernel (behind
// crf_beam_search_pallas_batch).  It computes what the plain engine
// fast_ctc_decode_tpu_torch/ops/beam_fast.py::crf_beam_search_ids_batch
// computes, bit for bit: the CRF instances of the version-1 (own-hash)
// kernel in beam_core.cuh, as _crf_beam_kernel is (its design, bounds and
// bit-parity rules are described there).  Node ids
// are coded as in the 1D kernel, so traceback_kernel.cu walks this id log
// unchanged.
//
// What bounds it beyond the 1D kernel: each tip loads its own row
// probs[b, t, state_k, :], so a step reads K rows of 4*(A+1) bytes, strided
// by T*S*(A+1)*4 bytes between threads (uncoalesced, no reuse across reads).
//
// Two instances: <5, 4> (beam 5 over "NACGT") and every smaller shape,
// <16, 7> up to beam 16 and A+1 = 8.  S is a runtime value with no padding.

#include "beam_core.cuh"

extern "C" {

// Launch the CRF forward beam on `stream`.  probs [B, T, S, A+1] f32,
// init [B, Si] f32, lengths [B] i32; outputs ids_log [T, K, B], fin [B],
// err [B] (i32).  All device memory allocated by the caller.  Returns the
// launch's cudaError_t (0 = launched).
int ctc_crf_beam_ids_launch(const float* probs, const float* init,
                            const int* lengths, float thr, int B, int T, int S,
                            int Si, int A, int K, int* ids_log, int* fin,
                            int* err, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 5 && A <= 4)
    return launch_beam_ids<5, 4, true, 1>(probs, init, lengths, thr, B, T, S, Si, A, K,
                                       0, ids_log, fin, err, s);
  if (K <= 16 && A <= 7)
    return launch_beam_ids<16, 7, true, 1>(probs, init, lengths, thr, B, T, S, Si, A, K,
                                        0, ids_log, fin, err, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
