// Phase ablation of the version-1 beam kernel: deliberately wrong variants
// with step phases stubbed out, timed against the whole kernel to attribute
// step time to the phases.  Nothing in the library launches it.
//
// Replaces: tools/kernel_ablate.py::_kernel (behind run_ablate).  The body is
// beam_core.cuh's version 1 with a compile-time phase mask (the kAbl* bits
// there): idlog (no id-log store), mix (child hash = own hash), match (no
// matching or arrivals, push = pushed), err (no status flags), rounds (one
// selection round; slots 1..K-1 keep their old state), hpick (new hashes
// sel_id*7, sel_id*13).  Its outputs are fin and err; the plain version is
// fast_ctc_decode_tpu_torch/tools/kernel_ablate.py::ablate_plain.
//
// Instances: exactly the nine sets of the tool (none, idlog, mix, match,
// err, rounds, hpick, match+mix, rounds+err), at <5, 4> only (the tool's
// beam 5 over "NACGT").  Other masks or wider shapes are refused.

#include "beam_core.cuh"

namespace {

template <int ABL>
cudaError_t launch_ablate(const float* probs, const int* lengths, float thr, int B,
                          int T, int A, int K, int* ids_log, int* fin, int* err,
                          cudaStream_t s) {
  return launch_beam_ids<5, 4, 1, ABL>(probs, lengths, thr, B, T, A, K, 1, ids_log, fin,
                                       err, s);
}

}  // namespace

extern "C" {

// Launch the ablated forward beam (collapse_repeats on) on `stream`.  probs
// [B, T, A+1] f32, lengths [B] i32; outputs ids_log [T, K, B], fin [B], err
// [B] (i32, device memory allocated by the caller).  `mask` is a set of
// kAbl* bits.  Returns the launch's cudaError_t (0 = launched).
int ctc_beam_ablate_launch(const float* probs, const int* lengths, float thr, int B,
                           int T, int A, int K, int mask, int* ids_log, int* fin,
                           int* err, void* stream) {
  if (K > 5 || A > 4) return cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mask) {
    case 0: return launch_ablate<0>(probs, lengths, thr, B, T, A, K, ids_log, fin, err, s);
    case kAblIdlog:
      return launch_ablate<kAblIdlog>(probs, lengths, thr, B, T, A, K, ids_log, fin, err, s);
    case kAblMix:
      return launch_ablate<kAblMix>(probs, lengths, thr, B, T, A, K, ids_log, fin, err, s);
    case kAblMatch:
      return launch_ablate<kAblMatch>(probs, lengths, thr, B, T, A, K, ids_log, fin, err, s);
    case kAblErr:
      return launch_ablate<kAblErr>(probs, lengths, thr, B, T, A, K, ids_log, fin, err, s);
    case kAblRounds:
      return launch_ablate<kAblRounds>(probs, lengths, thr, B, T, A, K, ids_log, fin, err, s);
    case kAblHpick:
      return launch_ablate<kAblHpick>(probs, lengths, thr, B, T, A, K, ids_log, fin, err, s);
    case kAblMatch | kAblMix:
      return launch_ablate<kAblMatch | kAblMix>(probs, lengths, thr, B, T, A, K, ids_log,
                                                fin, err, s);
    case kAblRounds | kAblErr:
      return launch_ablate<kAblRounds | kAblErr>(probs, lengths, thr, B, T, A, K, ids_log,
                                                 fin, err, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
