// Batched 1D CTC prefix beam search, hash-identity form, one thread per read:
// the forward beam over all T steps, shared by the 1D kernels (beam_kernel.cu,
// beam_v1_kernel.cu, beam_v3_kernel.cu, beam_ablate_kernel.cu).  The CRF beam
// and the 1D beam at small B run one warp per read (beam_warp_kernel.cu).
//
// It computes what the plain engine fast_ctc_decode_tpu_torch/ops/beam_fast.py
// computes, bit for bit: hash-identity tips, analytic merge (blank + stay +
// one arrival), the top K by (max total, tie -> min id), true-division
// renormalisation, the beam cut, collapse_repeats, per-read lengths and the
// status codes.  Outputs: the [T, K, B] log of entry-tip ids (read-minor),
// the final best id and the status code of every read.
//
// Three versions of the prefix identity, one template parameter V, as the
// TPU kernels of beam_pallas.py (_KERNEL_VARIANTS); all give the same
// outputs:
//  - V = 1 (_beam_kernel): each tip carries its OWN hash pair.  Extension
//    (k, a) matches tip j iff j is valid, a == last(j) and mix(own(k), a)
//    == own(j); so each tip j tests only the K extensions (k, last(j)):
//    K*K pair compares with the label taken at run time, not K*K*A.  The
//    winners' own hashes are rebuilt after the selection from each winner's
//    source: a tip keeps its own, a fresh (k, a) takes mix(own(k), a).
//  - V = 2 (_beam_kernel2, the default): each tip carries its PARENT hash
//    pair.  Own hashes are mixed once per tip per step (the root's is the
//    seed), extension (k, a) matches tip j iff own(k) == parent(j), a ==
//    last(j) and j is valid (mix is a bijection of the hash for a fixed
//    label, so this is exactly V1's test), the selection records only each
//    winner's source, and the new parent hashes are rebuilt after it: a
//    fresh winner (k, a) takes own(k), a tip winner keeps its parent.  No
//    hash travels through the selection.  The TPU kernel's vector tricks
//    (label XOR fold, validity poisoning) are left out: the fields are
//    compared directly.
//  - V = 3 (_beam_kernel3): V2 with the candidates enumerated a-major: the
//    expansion, the merge and the key array run a outer, k inner, so p[a]
//    and its threshold test are loaded once per label.  Candidate ids stay
//    t*K*A + k*A + a, so slot order is not id order: (k=1, a=0) sits in
//    slot 6 of <5, 4>, (k=0, a=1) in slot 10, and a tie between them goes
//    to (0, 1).  The selection ranks fresh candidates by id (below).
// Both matches come out as two bit masks, eqk[k] over the tips (V1: the
// child (k, last(j)) has j's own hash; V2, V3: own(k) == parent(j)) and
// labm[a] (tip j valid with last label a): extension (k, a) targets tip j
// iff both have bit j.  Every version loads frame t+1's row during step t,
// off the step's chain.
// ABL (version 1 only, kernel_ablate): a compile-time mask of step phases
// replaced by stubs, deliberately wrong, to attribute time to the phases:
// it runs the body of version 1 above, one-pass selection included.
//
// Selection.  The narrow instances <5, 4> of every version (and so the
// ablation sets) select in one pass: each candidate goes into a sorted list
// of the KMAX best as one 64-bit word (the key's order-preserving bits, then
// 255 minus a tie rank, then the candidate slot c in the low byte; the tie
// rank orders the tips by id and puts the fresh candidates after them in id
// order: KMAX + k*AMAX + a for (k, a), a constant of the unrolled loop,
// which in the k-major versions 1 and 2 is the slot c itself).  Every slot
// compares with the word at once and a shift by selects follows, so a
// candidate costs a few dependent operations, not K scans.  Valid ids are
// distinct and -inf keys are never inserted, so slot r ends with exactly
// what round r picks; the winners' fields are then taken from their slots
// c, through each version's slot map.  The ablation 'rounds' keeps a list of
// one slot (slots 1..K-1 keep their old state, which stays empty, so only
// slot 0 is ever valid and the ids of valid tips stay distinct under every
// stub).  The wide instances <16, 7> keep K rounds of (max key, tie -> min
// id), each scanning all K + K*A keys and then picking the winner's fields
// in a second pass.  Both selections record each winner's source
// slot, and the hashes and labels are rebuilt from it after the selection
// in every version.  The wide loops are not unrolled, so a
// one-pass list of 16 slots lives in local memory (ptxas: 32 registers and
// ~16 KB spilled, against 255 and ~3.5 KB), and it ran 1.8x slower than
// the rounds at B = 32768, beam 16, A+1 = 8 on an H100 (chip_smoke.py
// --parent).
//
// Design: one thread per read, block 128.  The beam (K tips x lab, gap,
// h1, h2, last label, id, valid) and the K + K*A candidate keys live
// in per-thread arrays whose sizes are template bounds (KMAX, AMAX); every
// loop runs to the bound and is predicated on the runtime K and A, so the
// arrays are indexed by constants after unrolling and can stay in
// registers.  The loop over t runs inside the thread; a read that is past
// its length or has a non-zero status is frozen and only logs its ids from
// then on.
//
// What bounds it on this card: latency and registers.  Each step is a long
// dependent chain of compares and selects per thread, and the per-thread
// state (about 150 live values at K=5, A=4) limits how many warps an SM
// holds; the wide instances spill to local memory.  The simple design
// accepts that: no shared-memory staging, no warp cooperation.  Its loads
// (4*(A+1) bytes per step) are strided by T*(A+1)*4 bytes between threads
// and do not coalesce; only the id-log stores do.  At B = 32768 its 1,024
// warps keep all 32 lanes of each busy on distinct reads; at small B
// (too few warps for 132 SMs) the warp-per-read kernel serves instead.
// Staging tiles through shared memory is left to a measured later change.
//
// Bit-parity rules: arithmetic uses __fmul_rn / __fadd_rn / __fdiv_rn
// (never contracted into FMA; the library is also built with -fmad=false)
// and IEEE division.  Labels pass the cut as !(p < thr), so NaN passes;
// blank passes as p0 > thr, so NaN fails.  The selection key maps NaN to
// +inf and adds +0.0 to canonicalise -0.0.  INCOMPARABLE_VALUES needs a
// NaN total among >= 2 valid candidates; RAN_OUT_OF_BEAM an empty step.
// Inputs holding +-inf follow the plain engine too (the JAX Pallas kernel
// raises one step earlier than its scan engine on them; this kernel and
// the plain engine follow the scan engine): the CPU tests pin the plain
// engine to the JAX scan engine on +-inf/NaN batches, and chip_smoke.py
// holds this kernel to the plain engine on one.
//
// Hashes are uint32 with natural wraparound; >> 16 on uint32 is logical.
// Node ids are t*K*A + k*A + a in int32 (root -1, empty -2); the wrapper
// refuses shapes where T*K*A overflows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;
constexpr uint32_t kMult1 = 0xC2B2AE35u, kAdd1 = 0x165667B1u;
constexpr uint32_t kMult2 = 0x27D4EB2Fu, kAdd2 = 0x9E3779B1u;
constexpr int kRoot = -1;
constexpr int kEmpty = -2;
constexpr int kIncomparable = 2;  // errors.INCOMPARABLE_VALUES
constexpr int kRanOut = 1;  // errors.RAN_OUT_OF_BEAM
constexpr int kBlock = 128;

// Ablation bits (tools/kernel_ablate.py::_kernel); each stubs one phase:
constexpr int kAblIdlog = 1;    // no id-log store
constexpr int kAblMix = 2;      // child hash = the tip's own hash
constexpr int kAblMatch = 4;    // no matching, no arrivals, push = pushed
constexpr int kAblErr = 8;      // no status flags
constexpr int kAblRounds = 16;  // one selection round; slots 1..K-1 left as they were
constexpr int kAblHpick = 32;   // new hashes sel_id*7, sel_id*13

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t x, uint32_t mult,
                                        uint32_t add) {
  uint32_t z = h ^ (x * mult + add);
  z = z * mult;
  return z ^ (z >> 16);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// probs: [B, T, A+1] f32.  init, S and Si are dead: the first design's CRF
// instances read init [B, Si] and rows of S states (they moved to
// beam_warp_kernel.cu), and the 1D instances take S = Si = 1 and no init.
// They stay because taking them out moves the compiled code of the other
// instances: built without them for an H100, version 1's <5, 4> step loop
// grew and the ablation sets 4 and 6 took more registers.
template <int KMAX, int AMAX, int V, int ABL>
__global__ void __launch_bounds__(kBlock)
beam_ids_kernel(const float* __restrict__ probs, const float* __restrict__ init,
                const int* __restrict__ lengths, float thr, int B, int T, int S,
                int Si, int A, int K, int collapse, int* __restrict__ ids_log,
                int* __restrict__ fin, int* __restrict__ err_out) {
  static_assert(V >= 1 && V <= 3, "versions 1, 2, 3");
  static_assert(ABL == 0 || V == 1, "ablation runs on version 1");
  constexpr int CMAX = KMAX + KMAX * AMAX;
  // The (k, a) loops run k outer (V1, V2) or a outer (V3): O x I.
  constexpr int O = V == 3 ? AMAX : KMAX;
  constexpr int I = V == 3 ? KMAX : AMAX;
  // Outer loops unroll only for the narrow instances: unrolling the
  // wide ones (128 candidates x 16 rounds) takes nvcc minutes and spills
  // anyway, so their per-round state lives in local memory.
  constexpr int UK = KMAX * CMAX <= 256 ? KMAX : 1;
  constexpr int UO = KMAX * CMAX <= 256 ? O : 1;
  constexpr bool ONE_PASS = UK == KMAX;  // the selection (above)
  static_assert(ABL == 0 || ONE_PASS, "the phase stubs live in the one-pass body");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int A1 = A + 1;
  const int KA = K * A;
  const int len = lengths[b];
  const float* row = probs + (size_t)b * (size_t)T * (size_t)S * (size_t)A1;
  // candidate slot c >= KMAX <-> fresh extension (k, a), in loop order
#define FK(c) (V == 3 ? ((c) - KMAX) % KMAX : ((c) - KMAX) / AMAX)
#define FA(c) (V == 3 ? ((c) - KMAX) / KMAX : ((c) - KMAX) % AMAX)
// and back: the slot of extension (k, a)
#define SLOT(k, a) (V == 3 ? KMAX + (a) * KMAX + (k) : KMAX + (k) * AMAX + (a))

  // ---- beam state: the root alone in slot 0 ----
  // h1/h2: the tip's own hash (V1) or its parent's hash (V2, V3; the
  // root's is unused: its own hash is the seed)
  float lab[KMAX], gap[KMAX];
  uint32_t h1[KMAX], h2[KMAX];
  int ll[KMAX], id[KMAX];
  bool valid[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    lab[k] = 0.f;
    gap[k] = k == 0 ? 1.f : 0.f;
    h1[k] = (V == 1 && k == 0) ? kSeed1 : 0u;
    h2[k] = (V == 1 && k == 0) ? kSeed2 : 0u;
    ll[k] = -1;
    id[k] = k == 0 ? kRoot : kEmpty;
    valid[k] = k == 0;
  }
  int err = 0;
  // frame t+1's row is loaded during step t
  float pn[AMAX + 1];
#pragma unroll
  for (int a = 0; a <= AMAX; ++a) pn[a] = (a <= A && 0 < len && 0 < T) ? row[a] : 0.f;

  int t = 0;
  for (; t < T; ++t) {
    if (!(ABL & kAblIdlog)) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K) ids_log[((size_t)t * K + k) * B + b] = id[k];
    }
    if (t >= len || err != 0) break;  // frozen from here on

    // frame t's row
    float p[AMAX + 1];
#pragma unroll
    for (int a = 0; a <= AMAX; ++a) {
      p[a] = pn[a];
      pn[a] = (a <= A && t + 1 < len && t + 1 < T) ? row[(size_t)(t + 1) * A1 + a] : 0.f;
    }

    float lg[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) lg[k] = __fadd_rn(lab[k], gap[k]);

    // ---- own hashes (V2, V3: once per tip) and the matches (above) ----
    // V1's branch repeats labm rather than share V2's block: folding them
    // together moved V2's and V3's SASS (chip_smoke.py --parent).
    uint32_t oh1[KMAX], oh2[KMAX];
    uint32_t eqk[KMAX];  // V1: child (k, last(j)) has own(j); V2, V3: own(k) == parent(j)
    uint32_t labm[AMAX];  // bit j iff tip j is valid with last label a
    if (V != 1) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        oh1[k] = ll[k] < 0 ? kSeed1 : mix(h1[k], (uint32_t)ll[k], kMult1, kAdd1);
        oh2[k] = ll[k] < 0 ? kSeed2 : mix(h2[k], (uint32_t)ll[k], kMult2, kAdd2);
      }
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        uint32_t m = 0u;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < K && oh1[k] == h1[j] && oh2[k] == h2[j]) m |= 1u << j;
        eqk[k] = m;
      }
#pragma unroll
      for (int a = 0; a < AMAX; ++a) {
        uint32_t m = 0u;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < K && valid[j] && ll[j] == a) m |= 1u << j;
        labm[a] = m;
      }
    } else if (!(ABL & kAblMatch)) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        uint32_t m = 0u;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          const uint32_t c1 =
              (ABL & kAblMix) ? h1[k] : mix(h1[k], (uint32_t)ll[j], kMult1, kAdd1);
          const uint32_t c2 =
              (ABL & kAblMix) ? h2[k] : mix(h2[k], (uint32_t)ll[j], kMult2, kAdd2);
          if (j < K && c1 == h1[j] && c2 == h2[j]) m |= 1u << j;
        }
        eqk[k] = m;
      }
#pragma unroll
      for (int a = 0; a < AMAX; ++a) {
        uint32_t m = 0u;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < K && valid[j] && ll[j] == a) m |= 1u << j;
        labm[a] = m;
      }
    }

    // ---- expand: extension (k, a) -> mass, push flag, matched tips ----
    float mext[KMAX][AMAX];
    bool push[KMAX][AMAX];
    uint32_t hits[KMAX][AMAX];  // bit j: extension (k, a) targets tip j
#pragma unroll(UO)
    for (int o = 0; o < O; ++o) {
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const int k = V == 3 ? i : o, a = V == 3 ? o : i;
        uint32_t m = 0u;
        bool pu = false;
        float me = 0.f;
        if (k < K && a < A) {
          if (!(ABL & kAblMatch)) m = eqk[k] & labm[a];
          const float pa = p[1 + a];
          const bool is_rep = collapse && ll[k] == a;
          const bool pushed = valid[k] && !(pa < thr);
          me = __fmul_rn(is_rep ? gap[k] : lg[k], pa);
          pu = (ABL & kAblMatch) ? pushed
                                 : pushed && (!is_rep || m != 0u || gap[k] > 0.f);
        }
        mext[k][a] = me;
        push[k][a] = pu;
        hits[k][a] = m;
      }
    }

    // ---- analytic merge: blank + stay + arrivals per tip ----
    float tip_lab[KMAX], tip_gap[KMAX];
    bool tip_valid[KMAX];
#pragma unroll(UK)
    for (int j = 0; j < KMAX; ++j) {
      float recv = 0.f;
      bool recv_any = false;
#pragma unroll
      for (int o = 0; o < O; ++o)
#pragma unroll
        for (int i = 0; i < I; ++i) {
          const int k = V == 3 ? i : o, a = V == 3 ? o : i;
          if (push[k][a] && ((hits[k][a] >> j) & 1u)) {
            recv = __fadd_rn(recv, mext[k][a]);
            recv_any = true;
          }
        }
      const int safe_last = ll[j] < 0 ? 0 : (ll[j] > A - 1 ? A - 1 : ll[j]);
      float p_stay = 0.f;
#pragma unroll
      for (int a = 0; a < AMAX; ++a)
        if (a == safe_last) p_stay = p[1 + a];
      const bool stay_push =
          collapse && valid[j] && ll[j] >= 0 && ll[j] < A && !(p_stay < thr);
      const float stay_lab = stay_push ? __fmul_rn(lab[j], p_stay) : 0.f;
      const float p0 = j < K ? p[0] : 0.f;
      const bool blank_push = valid[j] && (p0 > thr);
      tip_gap[j] = blank_push ? __fmul_rn(lg[j], p0) : 0.f;
      tip_lab[j] = __fadd_rn(stay_lab, recv);
      tip_valid[j] = j < K && (blank_push || stay_push || recv_any);
    }

    // ---- candidate keys: K tips then K*A fresh extensions ----
    float key[CMAX];
    int cnt = 0;
    bool any_nan = false;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      bool v;
      float total;
      if (c < KMAX) {
        v = tip_valid[c];
        total = __fadd_rn(tip_lab[c], tip_gap[c]);
      } else {
        const int k = FK(c), a = FA(c);
        v = push[k][a] && hits[k][a] == 0u;
        total = __fadd_rn(mext[k][a], 0.f);  // c_lab + c_gap with c_gap = 0
      }
      cnt += v ? 1 : 0;
      any_nan = any_nan || (v && isnan(total));
      key[c] = v ? (isnan(total) ? pos_inf() : __fadd_rn(total, 0.f)) : neg_inf();
    }

    // ---- top-K by (max key, tie -> min id) ----
    // The narrow instances select in one pass, the wide ones in K rounds.
    // Both record each winner's source slot (nsrc); the hashes and labels
    // are rebuilt after.  The ablation 'rounds' selects slot 0 alone (R = 1).
    constexpr int R = (ABL & kAblRounds) ? 1 : KMAX;
    float top = 0.f;
    float nlab[KMAX], ngap[KMAX];
    uint32_t nh1[KMAX], nh2[KMAX];
    int nll[KMAX], nid[KMAX], nsrc[KMAX];
    bool nvalid[KMAX];
    if constexpr (ONE_PASS) {
      // a tip's tie rank: the number of tips with a smaller id
      int tie[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        int n = 0;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) n += (i < K && id[i] < id[j]) ? 1 : 0;
        tie[j] = n;
      }
      // the sorted list of the R best words, larger first; 0 = empty
      unsigned long long best[R];
#pragma unroll
      for (int r = 0; r < R; ++r) best[r] = 0ull;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        const uint32_t kb = __float_as_uint(key[c]);
        const uint32_t ord = kb ^ ((kb >> 31) ? 0xffffffffu : 0x80000000u);
        // a fresh candidate's rank is its id order, (k, a) lexicographic:
        // a constant of the unrolled loop (V1, V2: the slot c itself)
        const uint32_t rank = c < KMAX ? (uint32_t)tie[c]
                                       : (uint32_t)(V == 3 ? KMAX + FK(c) * AMAX + FA(c) : c);
        const uint32_t lo = ((255u - rank) << 8) | (uint32_t)c;
        const unsigned long long x =
            key[c] > neg_inf() ? ((unsigned long long)ord << 32) | lo : 0ull;
        bool gt[R];
#pragma unroll
        for (int r = 0; r < R; ++r) gt[r] = x > best[r];
#pragma unroll
        for (int r = R - 1; r >= 0; --r)
          best[r] = (r > 0 && gt[r > 0 ? r - 1 : 0]) ? best[r > 0 ? r - 1 : 0]
                                                     : (gt[r] ? x : best[r]);
      }
      // slot r: the winner's fields from its candidate slot c, selected
      // over the register arrays
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool v = r < K && best[r] != 0ull;
        const int c = v ? (int)(best[r] & 0xffu) : 0;
        float sel_lab = 0.f, sel_gap = 0.f;
        int sel_id = c >= KMAX ? t * KA + FK(c) * A + FA(c) : 0;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (c != j) continue;
          sel_lab = tip_lab[j];
          sel_gap = tip_gap[j];
          sel_id = id[j];
        }
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
          for (int a = 0; a < AMAX; ++a)
            if (c == SLOT(k, a)) sel_lab = mext[k][a];
        // the masked sums of the plain engine add +0.0: canonical -0.0
        sel_lab = __fadd_rn(sel_lab, 0.f);
        sel_gap = __fadd_rn(sel_gap, 0.f);
        if (r == 0 && v) top = __fadd_rn(sel_lab, sel_gap);  // raw total, NaN kept
        nlab[r] = v ? sel_lab : 0.f;
        ngap[r] = v ? sel_gap : 0.f;
        nh1[r] = 0u;
        nh2[r] = 0u;
        nll[r] = -1;
        nid[r] = v ? sel_id : kEmpty;
        nsrc[r] = v ? c : -1;
        nvalid[r] = v;
      }
    } else {
#pragma unroll(UK)
    for (int r = 0; r < R; ++r) {
      nlab[r] = 0.f;
      ngap[r] = 0.f;
      nh1[r] = 0u;
      nh2[r] = 0u;
      nll[r] = -1;
      nid[r] = kEmpty;
      nsrc[r] = -1;
      nvalid[r] = false;
      if (r >= K) continue;
      float mx = neg_inf();
      int best = -1, best_id = 0x7fffffff;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        const int cid = c < KMAX ? id[c] : t * KA + FK(c) * A + FA(c);
        if (key[c] > mx || (key[c] == mx && key[c] > neg_inf() && cid < best_id)) {
          mx = key[c];
          best = c;
          best_id = cid;
        }
      }
      if (!(mx > neg_inf())) continue;  // no candidate left: slot stays empty
      float sel_lab = 0.f, sel_gap = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c != best) continue;
        key[c] = neg_inf();
        if (c < KMAX) {
          sel_lab = tip_lab[c];
          sel_gap = tip_gap[c];
        } else {
          const int k = FK(c), a = FA(c);
          sel_lab = mext[k][a];
          sel_gap = 0.f;
        }
      }
      // the masked sums of the plain engine add +0.0: canonical -0.0
      sel_lab = __fadd_rn(sel_lab, 0.f);
      sel_gap = __fadd_rn(sel_gap, 0.f);
      if (r == 0) top = __fadd_rn(sel_lab, sel_gap);  // raw total, NaN kept
      nlab[r] = sel_lab;
      ngap[r] = sel_gap;
      nid[r] = best_id;
      nsrc[r] = best;
      nvalid[r] = true;
    }
    }
    if (V != 1) {
      // new parent hashes from each winner's source: a tip keeps its
      // parent, a fresh (k, a) takes own(k); labels likewise
#pragma unroll(UK)
      for (int r = 0; r < KMAX; ++r) {
        const int c = nsrc[r];
        const bool fresh = c >= KMAX;
        const int src = fresh ? FK(c) : c;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j != src) continue;
          nh1[r] = fresh ? oh1[j] : h1[j];
          nh2[r] = fresh ? oh2[j] : h2[j];
          nll[r] = fresh ? FA(c) : ll[j];
        }
      }
    } else {
      // new own hashes from each winner's source: a tip keeps its own, a
      // fresh (k, a) takes mix(own(k), a), one mix per slot; labels likewise
#pragma unroll(UK)
      for (int r = 0; r < R; ++r) {
        const int c = nsrc[r];
        const bool fresh = c >= KMAX;
        const int src = fresh ? FK(c) : c;
        uint32_t s1 = 0u, s2 = 0u;
        int sl = -1;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j != src) continue;
          s1 = h1[j];
          s2 = h2[j];
          sl = ll[j];
        }
        const bool remix = fresh && !(ABL & kAblMix);
        nh1[r] = remix ? mix(s1, (uint32_t)FA(c), kMult1, kAdd1) : s1;
        nh2[r] = remix ? mix(s2, (uint32_t)FA(c), kMult2, kAdd2) : s2;
        nll[r] = fresh ? FA(c) : sl;
        if (ABL & kAblHpick) {
          nh1[r] = (uint32_t)nid[r] * 7u;
          nh2[r] = (uint32_t)nid[r] * 13u;
        }
      }
    }

    // ---- status, then the renormalised next beam (true division) ----
    if (!(ABL & kAblErr)) {
      if (cnt >= 2 && any_nan)
        err = kIncomparable;
      else if (cnt == 0)
        err = kRanOut;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      lab[r] = nvalid[r] ? __fdiv_rn(nlab[r], top) : 0.f;
      gap[r] = nvalid[r] ? __fdiv_rn(ngap[r], top) : 0.f;
      h1[r] = nh1[r];
      h2[r] = nh2[r];
      ll[r] = nll[r];
      id[r] = nid[r];
      valid[r] = nvalid[r];
    }
  }
#undef FK
#undef FA
#undef SLOT
  // a frozen read logs the same entry ids for every remaining step
  if (!(ABL & kAblIdlog)) {
    for (int tt = t + 1; tt < T; ++tt) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K) ids_log[((size_t)tt * K + k) * B + b] = id[k];
    }
  }
  fin[b] = id[0];
  err_out[b] = err;
}

template <int KMAX, int AMAX, int V, int ABL = 0>
cudaError_t launch_beam_ids(const float* probs, const int* lengths, float thr, int B,
                            int T, int A, int K, int collapse, int* ids_log, int* fin,
                            int* err, cudaStream_t stream) {
  const dim3 grid((B + kBlock - 1) / kBlock);
  beam_ids_kernel<KMAX, AMAX, V, ABL><<<grid, kBlock, 0, stream>>>(
      probs, nullptr, lengths, thr, B, T, 1, 1, A, K, collapse, ids_log, fin, err);
  return cudaGetLastError();
}

}  // namespace
