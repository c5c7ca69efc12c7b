// Batched 1D CTC prefix beam search, version 3 (parent-hash identity,
// candidates enumerated a-major): the A/B variant of beam_kernel.cu.
//
// Replaces: fast_ctc_decode_tpu/ops/beam_pallas.py::_beam_kernel3 (behind
// beam_search_pallas_batch(version=3)).  On the TPU, v3 lays the candidate
// plane out as A tiles of the tip plane so that each per-tip field expands
// with one tile op; on this card the candidates live in per-thread arrays,
// and what carries over is the order: the expansion, the merge and the key
// array run a outer, k inner, so p[a] and its threshold test are loaded once
// per label.  Candidate ids stay t*K*A + k*A + a, so the selection, its ties
// and the outputs equal versions 1 and 2 bit for bit.  beam_core.cuh
// describes the versions, the design and the bounds.
//
// Two instances: <5, 4> and <16, 7>, as beam_kernel.cu.

#include "beam_core.cuh"

extern "C" {

// As ctc_beam_ids_launch (beam_kernel.cu), version 3.
int ctc_beam_ids_v3_launch(const float* probs, const int* lengths, float thr,
                           int B, int T, int A, int K, int collapse, int* ids_log,
                           int* fin, int* err, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 5 && A <= 4)
    return launch_beam_ids<5, 4, 3>(probs, lengths, thr, B, T, A, K, collapse,
                                    ids_log, fin, err, s);
  if (K <= 16 && A <= 7)
    return launch_beam_ids<16, 7, 3>(probs, lengths, thr, B, T, A, K, collapse,
                                     ids_log, fin, err, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
