// Batched 1D CTC prefix beam search, version 1 (own-hash identity): the A/B
// variant of beam_kernel.cu.
//
// Replaces: fast_ctc_decode_tpu/ops/beam_pallas.py::_beam_kernel (behind
// beam_search_pallas_batch(version=1), used by tools/ab_bench.py).  Same
// outputs as version 2, bit for bit.  Each tip carries its own hash pair:
// each tip j tests only the K extensions (k, last(j)), mixing own(k) with
// j's label (K*K pairs a step), and the winners' own hashes are rebuilt
// from their sources after the selection (one mix a fresh winner).  It
// runs row 1's design for the card: one thread per read, frame t+1 loaded
// during step t, and at <5, 4> the one-pass selection; beam_core.cuh
// describes the versions, the design and the bounds.  It is its own
// translation unit so that nvcc builds it beside the others.
//
// Two instances: <5, 4> (one-pass selection) and <16, 7> (K selection
// rounds: its one-pass list would spill, as version 2's did).

#include "beam_core.cuh"

extern "C" {

// As ctc_beam_ids_launch (beam_kernel.cu), version 1.
int ctc_beam_ids_v1_launch(const float* probs, const int* lengths, float thr,
                           int B, int T, int A, int K, int collapse, int* ids_log,
                           int* fin, int* err, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 5 && A <= 4)
    return launch_beam_ids<5, 4, 1>(probs, lengths, thr, B, T, A, K, collapse,
                                    ids_log, fin, err, s);
  if (K <= 16 && A <= 7)
    return launch_beam_ids<16, 7, 1>(probs, lengths, thr, B, T, A, K, collapse,
                                     ids_log, fin, err, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
