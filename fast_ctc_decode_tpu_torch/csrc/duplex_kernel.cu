// Batched duplex pair-consensus beam search, slot-band form: the forward
// beam over all T1 steps of network_1, one block per read pair.
//
// Replaces: fast_ctc_decode_tpu/ops/duplex_pallas.py::_duplex_kernel (behind
// duplex_pallas_batch).  It computes what the plain engine
// fast_ctc_decode_tpu_torch/ops/duplex_fast.py::duplex_fast_ids computes
// (crf=False), bit for bit: hash-identity tips that carry their own band and
// a copy of their parent's band, band extension in node-id order (parents
// before children, each slot from its own end to the upper bound) with the
// parent-copy refresh, the analytic merge (blank + stay + one arrival), band
// cells built one after another in the reference's order (two logsumexps
// per cell, duplex.rs:229-247), K rounds of (max score, tie -> min id) with
// explicit validity, the status codes.  Outputs: the [T1, K, B] log of
// entry-tip ids (t*K*A + k*A + a coded, so traceback_kernel.cu walks it),
// the final best id and the status code of every pair.
//
// Design, for this card.  One block of kThreads = 128 threads (four warps)
// per pair.  Warp 0 holds the beam: lane c = k*A + a is fresh candidate
// (k, a) and lane k is tip k, so K*A <= 32.  Slot scalars live in shared
// arrays; the bands live in dynamic shared memory, two sets (current /
// next) of four [K, Wk] rows per slot set: own label, own gap, parent-copy
// label, parent-copy gap.  A band row is a ring over network_2 cells
// (column t2 mod Wk, kept as a running column with a wrap, never a division
// per cell).  The kernel covers envelopes with non-decreasing lower bounds
// (the full range included): then every band's live cells [off, end) and
// every cell a step reads lie within [lo - 1, hi) of width < Wk =
// max(hi - lo) + 2, so the ring never aliases a live cell and needs no
// slides (the TPU kernel shifts its window-relative rows instead).  The
// wrapper refuses other envelopes.
//
// What bounds it: the band-cell recurrence, a serial chain per candidate
// that no f32-exact rewrite can spread over lanes (a blocked scan reorders
// the sums).  What the design does about it:
//   - the chain carries one logsumexp per cell, not three: base =
//     ls_add(par_lab, par_gap) depends on the tip's band only, so all
//     threads compute it for the K tips and the whole window ahead of the
//     chains ("stage" rows: the tips' totals, then their gaps for repeats);
//     the rest is duplex_core.cuh's cell_chain, whose lab and tot
//     recurrences overlap;
//   - every candidate's band is built once: the chain stores its cells in a
//     global scratch slab (cell-major, [Wk][2][K*A], so the warp's store is
//     one short line; 20.6 MB for 256 pairs at T2 = 500, inside the L2, and
//     the stores are off the chain), and the chosen candidates' rows are
//     copied from there into the next set by the whole block.  The TPU
//     kernel rebuilds instead ("select first, rebuild after") because its
//     fast memory cannot hold K*A bands;
//   - the hoisted rows, the window max of an extension, the copies between
//     sets and the parent-copy refresh run over all four warps;
//     __syncthreads only at phase boundaries;
//   - the extension runs the live slots by dependency level, one warp per
//     slot: a slot waits only for the slot whose band it reads (its parent,
//     if that is live and earlier in node-id order) and reads that slot's
//     own rows directly; the parent-copy refresh is one block-wide copy
//     after the last level.
// Four warps: the block-wide phases are short beside the chains, so more
// warps would idle; two blocks fit an SM at the full range of T2 = 500
// (100 KB of bands and stage rows each), i.e. eight warps, and ptxas stays
// at 72 registers a thread (a 24-byte stack frame, nothing in the chains).
// Splitting a chain over two warps (lab chain and tot chain, handed over
// through shared memory under named barriers) was measured and bought
// nothing: the two logsumexps of a cell already overlap on one lane.  The stage rows live in shared memory when
// 10*K*Wk floats fit and in the slab otherwise, decided in the launch; the
// bound on the bands themselves (8*K*Wk floats) is the one the kernel
// always had.
//
// Bit-parity rules: duplex_core.cuh's ls_add / ls_max; sums with __fadd_rn;
// labels pass the cut as !(p < thr) and blanks as p0 > thr; the selection
// key maps NaN to +inf and adds +0.0; picked probabilities add +0.0;
// INCOMPARABLE_VALUES needs a NaN score among >= 2 valid candidates.

#include "duplex_core.cuh"

namespace {

using namespace duplex;

constexpr int kLanes = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kLanes * kWarps;
constexpr int kSmemLimit = 224 * 1024;  // dynamic shared memory of one block

struct Slots {
  int id[kLanes], ll[kLanes], pll[kLanes];
  int boff[kLanes], bend[kLanes], pboff[kLanes], pbend[kLanes];
  int valid[kLanes], proot[kLanes];
  uint32_t h1[kLanes], h2[kLanes], ph1[kLanes], ph2[kLanes];
  float p1l[kLanes], p1g[kLanes], p2m[kLanes];
  int choice[kLanes];  // new slot r: tip j (0..K-1), fresh K + c, or -1
  // the extension's plan, per slot (order: per rank)
  signed char order[kLanes], pos[kLanes], act[kLanes], dep[kLanes], fin[kLanes], lev[kLanes];
  int n_lev, err;
};

__device__ __forceinline__ int ring(int t2, int Wk) {
  const int c = t2 % Wk;
  return c < 0 ? c + Wk : c;
}

__global__ void __launch_bounds__(kThreads)
duplex_slot_kernel(const float* __restrict__ l1, const float* __restrict__ l2,
                   const float* __restrict__ root_gap_all, const int* __restrict__ lo_all,
                   const int* __restrict__ hi_all, const int* __restrict__ lengths,
                   float thr, int B, int T1, int T2, int A, int K, int Wr, int Wk,
                   int needs_ext, int collapse, float* __restrict__ slab_all,
                   long long slab_stride, int stage_in_smem, int* __restrict__ ids_log,
                   int* __restrict__ fin, int* __restrict__ err_out) {
  extern __shared__ float bands[];  // [2][4][K][Wk] (+ stage [2][K][Wk])
  __shared__ Slots s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & (kLanes - 1);
  const int warp = tid / kLanes;
  const int A1 = A + 1;
  const int KA = K * A;
  const float* l1b = l1 + (size_t)b * T1 * A1;
  const float* __restrict__ l2b = l2 + (size_t)b * T2 * A1;
  const float* root_gap = root_gap_all + (size_t)b * Wr;
  const int* lo_b = lo_all + (size_t)b * T1;
  const int* hi_b = hi_all + (size_t)b * T1;
  // this pair's slab: the fresh candidates' cells [Wk][2][KA], then room
  // for the stage rows
  float* __restrict__ cells = slab_all + (size_t)b * (size_t)slab_stride;
  // stage rows [2][K][Wk]: row k the hoisted totals of tip k (or the bases of
  // slot k's extension), row K + k the hoisted gaps of tip k
  float* stage = stage_in_smem ? bands + (size_t)8 * K * Wk : cells + (size_t)2 * KA * Wk;
  auto row = [&](int set, int arr, int k) -> float* {
    return bands + ((size_t)(set * 4 + arr) * K + k) * Wk;
  };

  if (tid < K) {
    const bool r0 = tid == 0;
    s.id[tid] = r0 ? -1 : -2;
    s.h1[tid] = r0 ? kSeed1 : 0u;
    s.h2[tid] = r0 ? kSeed2 : 0u;
    s.ph1[tid] = 0u;
    s.ph2[tid] = 0u;
    s.ll[tid] = -1;
    s.pll[tid] = -2;
    s.valid[tid] = r0;
    s.proot[tid] = 0;
    s.p1l[tid] = neg_inf();
    s.p1g[tid] = r0 ? 0.f : neg_inf();
    s.p2m[tid] = r0 ? 0.f : neg_inf();
    s.boff[tid] = s.bend[tid] = s.pboff[tid] = s.pbend[tid] = 0;
  }
  __syncthreads();
  const int len = lengths[b];
  int err = 0, last_upper = 0, cur = 0;

  for (int t = 0; t < T1; ++t) {
    if (tid < K) ids_log[((size_t)t * K + tid) * B + b] = s.id[tid];
    const int lo = lo_b[t], hi = hi_b[t];
    const bool in_range = t < len;
    const bool env_bad = in_range && (lo >= hi || lo > last_upper);
    if (err == 0 && env_bad) err = kInvalidEnvelope;
    if (!(err == 0 && in_range)) {
      // frozen from here on: only the id log grows
      for (int u = t + 1; u < T1; ++u)
        if (tid < K) ids_log[((size_t)u * K + tid) * B + b] = s.id[tid];
      break;
    }

    // ---- band extension, parents before children in node-id order ----
    if (needs_ext && hi > last_upper) {
      // the plan (warp 0): node-id order; which slots extend; for each slot
      // the last extending slot before it in that order whose band it reads
      // (dep: it is its parent, by hash), the last such slot of all (fin:
      // the parent-copy refresh that stands at the end), and its level
      if (warp == 0) {
        if (lane < K) {
          const int key = (s.valid[lane] && s.id[lane] >= 0) ? s.id[lane] : 0x7fffffff;
          int rank = 0;
          for (int j = 0; j < K; ++j) {
            const int kj = (s.valid[j] && s.id[j] >= 0) ? s.id[j] : 0x7fffffff;
            rank += (kj < key || (kj == key && j < lane)) ? 1 : 0;
          }
          s.order[rank] = (signed char)lane;
          s.pos[lane] = (signed char)rank;
          s.act[lane] = s.valid[lane] && s.id[lane] >= 0 && s.bend[lane] < hi;
        }
        __syncwarp();
        if (lane < K) {
          int dep = -1, last = -1;
          for (int r = 0; r < K; ++r) {
            const int sl = s.order[r];
            if (!(s.act[sl] && s.valid[lane] && s.ph1[lane] == s.h1[sl] &&
                  s.ph2[lane] == s.h2[sl] && !s.proot[lane]))
              continue;
            last = sl;
            if (r < s.pos[lane]) dep = sl;
          }
          s.dep[lane] = (signed char)dep;
          s.fin[lane] = (signed char)last;
        }
        __syncwarp();
        if (lane == 0) {
          int n_lev = 0;
          for (int r = 0; r < K; ++r) {
            const int sl = s.order[r];
            const int lv = s.dep[sl] < 0 ? 0 : s.lev[s.dep[sl]] + 1;
            s.lev[sl] = (signed char)lv;
            if (s.act[sl] && lv + 1 > n_lev) n_lev = lv + 1;
          }
          s.n_lev = n_lev;
        }
      }
      __syncthreads();
      const int n_lev = s.n_lev;
      for (int lv = 0; lv < n_lev; ++lv) {
        for (int sl = warp; sl < K; sl += kWarps) {  // one warp per slot of this level
          if (!(s.act[sl] && s.lev[sl] == lv)) continue;
          const int off = s.boff[sl], end = s.bend[sl];
          const bool do_discard = lo > off;
          const bool emptied = end <= lo - 1;
          const int off2 = do_discard ? (emptied ? lo : lo - 1) : off;
          const int end2 = (do_discard && emptied) ? lo : end;
          float* lab = row(cur, 0, sl);
          float* gap = row(cur, 1, sl);
          float p2m = s.p2m[sl];
          if (do_discard) {  // update_max(lo, hi) over the kept window
            const int c0 = lo > off2 ? lo : off2;
            const int c1 = hi < end2 ? hi : end2;
            float v = neg_inf();
            if (c0 < c1) {
              int col = wrap(ring(c0, Wk) + lane, Wk);
              for (int t2 = c0 + lane; t2 < c1; t2 += kLanes) {
                v = ls_max(v, ls_add(lab[col], gap[col]));
                col = wrap(col + kLanes, Wk);
              }
            }
            p2m = warp_max(v);
          }
          // the bases of the appended cells [end2, hi), ahead of the chain:
          // the parent's band at the cell before (the slot it waits for has
          // it in its own rows; otherwise the parent copy)
          const int dep = s.dep[sl];
          const float* plab = dep >= 0 ? row(cur, 0, dep) : row(cur, 2, sl);
          const float* pgap = dep >= 0 ? row(cur, 1, dep) : row(cur, 3, sl);
          const int pboff = dep >= 0 ? s.boff[dep] : s.pboff[sl];
          const int pbend = dep >= 0 ? s.bend[dep] : s.pbend[sl];
          const bool is_rep = s.pll[sl] == s.ll[sl];
          const bool proot = s.proot[sl] != 0;
          const int n_new = hi - end2;
          float* bases = stage + (size_t)sl * Wk;
          if (n_new > 0) {
            int pc = wrap(ring(end2 - 1, Wk) + lane, Wk);
            for (int j = lane; j < n_new; j += kLanes) {
              const int pv = end2 - 1 + j;
              const bool p_ok = pv >= pboff && pv < pbend && !proot;
              const float ppl = p_ok ? plab[pc] : neg_inf();
              const float ppg =
                  proot ? root_read(root_gap, Wr, pv) : (p_ok ? pgap[pc] : neg_inf());
              bases[j] = is_rep ? ppg : ls_add(ppl, ppg);
              pc = wrap(pc + kLanes, Wk);
            }
          }
          __syncwarp();
          if (lane == 0) {
            float last_lab = neg_inf(), last_gap = neg_inf();
            if (end2 > off2) {
              const int col = ring(end2 - 1, Wk);
              last_lab = lab[col];
              last_gap = gap[col];
            }
            float last_tot = ls_add(last_lab, last_gap);
            const int li = 1 + (s.ll[sl] < 0 ? 0 : (s.ll[sl] > A - 1 ? A - 1 : s.ll[sl]));
            const float* __restrict__ r2 = l2b + (size_t)end2 * A1;
            const float* __restrict__ bs = bases;
            int col = n_new > 0 ? ring(end2, Wk) : 0;
            cell_chain(
                n_new, last_lab, last_tot, p2m,
                [&](int j, float& base, float& r0, float& ra) {
                  base = bs[j];
                  r0 = r2[j * A1];
                  ra = r2[j * A1 + li];
                },
                [&](int, float lab_n, float gap_n) {
                  lab[col] = lab_n;
                  gap[col] = gap_n;
                  col = col + 1 == Wk ? 0 : col + 1;
                });
            s.boff[sl] = off2;
            s.bend[sl] = hi;
            s.p2m[sl] = p2m;
          }
        }
        __syncthreads();
      }
      // refresh the parent copies: each slot takes the rows of the last
      // extended slot that is its parent
      for (int k = 0; k < K; ++k) {
        const int src = s.fin[k];
        if (src < 0) continue;
        const float* sl_ = row(cur, 0, src);
        const float* sg_ = row(cur, 1, src);
        float* dl = row(cur, 2, k);
        float* dg = row(cur, 3, k);
        for (int c = tid; c < Wk; c += kThreads) {
          dl[c] = sl_[c];
          dg[c] = sg_[c];
        }
        if (tid == 0) {
          s.pboff[k] = s.boff[src];
          s.pbend[k] = hi;
        }
      }
      __syncthreads();
    }
    last_upper = hi;

    // ---- the tips' bands at the cell before, for the whole window: the
    // chains' bases, by all threads ----
    const int n_win = hi - lo;
    {
      const int c_lo = ring(lo - 1, Wk);
      for (int k = 0; k < K; ++k) {
        if (!s.valid[k]) continue;  // no candidate of an empty slot is built
        const float* own_lab = row(cur, 0, k);
        const float* own_gap = row(cur, 1, k);
        const bool root = s.id[k] == -1;
        const int boff = s.boff[k], bend = s.bend[k];
        float* tot_row = stage + (size_t)k * Wk;
        float* gap_row = stage + (size_t)(K + k) * Wk;
        for (int j = tid; j < n_win; j += kThreads) {
          const int pv = lo - 1 + j;
          int col = c_lo + j;  // below 2 * Wk
          col = col >= Wk ? col - Wk : col;
          const bool t_ok = pv >= boff && pv < bend;
          const float par_lab = (t_ok && !root) ? own_lab[col] : neg_inf();
          const float par_gap =
              root ? root_read(root_gap, Wr, pv) : (t_ok ? own_gap[col] : neg_inf());
          tot_row[j] = ls_add(par_lab, par_gap);
          gap_row[j] = par_gap;
        }
      }
    }
    __syncthreads();

    if (warp == 0) {
      // ---- expansion: candidate (k, a) on lane k*A + a, tip j on lane j ----
      const float* r1 = l1b + (size_t)t * A1;
      const float p0 = r1[0];
      const bool is_cand = lane < KA;
      const int k = is_cand ? lane / A : 0;
      const int a = is_cand ? lane - k * A : 0;
      bool push_ext = false, fvalid = false, is_rep = false;
      int tgt = -1;
      float m_ext = neg_inf();
      uint32_t th1 = 0u, th2 = 0u;
      if (is_cand) {
        const float plab = r1[1 + a];
        const bool pushed = s.valid[k] && !(plab < thr);
        is_rep = collapse && s.ll[k] == a;
        th1 = mix(s.h1[k], (uint32_t)a, kMult1, kAdd1);
        th2 = mix(s.h2[k], (uint32_t)a, kMult2, kAdd2);
        for (int j = 0; j < K; ++j)
          if (th1 == s.h1[j] && th2 == s.h2[j] && a == s.ll[j] && s.valid[j]) tgt = j;
        const bool matched = tgt >= 0;
        const float p1tot = ls_add(s.p1l[k], s.p1g[k]);
        m_ext = __fadd_rn(is_rep ? s.p1g[k] : p1tot, plab);
        push_ext = pushed && (!is_rep || matched || s.p1g[k] > neg_inf());
        fvalid = push_ext && !matched;
      }
      // analytic merge on the tips: blank + stay + at most one arrival
      float recv = neg_inf();
      bool recv_any = false;
      for (int j = 0; j < K; ++j) {
        const unsigned bal = __ballot_sync(kFull, push_ext && tgt == j);
        const float v = __shfl_sync(kFull, m_ext, bal ? __ffs(bal) - 1 : 0);
        if (lane == j && bal) {
          recv = v;
          recv_any = true;
        }
      }
      bool tvalid = false;
      float tip_lab = neg_inf(), tip_gap = neg_inf(), tscore = neg_inf();
      if (lane < K) {
        const bool vj = s.valid[lane];
        const float p1tot = ls_add(s.p1l[lane], s.p1g[lane]);
        bool stay_push = false;
        float stay_lab = neg_inf();
        if (collapse) {
          const int ll = s.ll[lane];
          const float p_stay = r1[1 + (ll < 0 ? 0 : (ll > A - 1 ? A - 1 : ll))];
          stay_push = vj && ll >= 0 && !(p_stay < thr);
          if (stay_push) stay_lab = __fadd_rn(s.p1l[lane], p_stay);
        }
        const bool blank_push = vj && p0 > thr;
        if (blank_push) tip_gap = __fadd_rn(p1tot, p0);
        tip_lab = ls_add(stay_lab, recv);
        tvalid = blank_push || stay_push || recv_any;
        tscore = __fadd_rn(ls_add(tip_lab, tip_gap), s.p2m[lane]);
      }

      // ---- every fresh candidate's band over [lo, hi), built once: the
      // cells go to the slab, the running max stays on the lane ----
      float p2new = neg_inf();
      if (fvalid) {
        const float* __restrict__ bs = stage + (size_t)((is_rep ? K : 0) + k) * Wk;
        const float* __restrict__ r2 = l2b + (size_t)lo * A1;
        float* __restrict__ out = cells + lane;
        float last_lab = neg_inf(), last_tot = neg_inf();
        cell_chain(
            n_win, last_lab, last_tot, p2new,
            [&](int j, float& base, float& r0, float& ra) {
              base = bs[j];
              r0 = r2[j * A1];
              ra = r2[j * A1 + 1 + a];
            },
            [&](int j, float lab_n, float gap_n) {
              out[2 * j * KA] = lab_n;
              out[(2 * j + 1) * KA] = gap_n;
            });
      }
      const float fscore = __fadd_rn(ls_add(fvalid ? m_ext : neg_inf(), neg_inf()), p2new);

      // ---- selection: K rounds of (max key, tie -> min id) ----
      const int cnt =
          __popc(__ballot_sync(kFull, tvalid)) + __popc(__ballot_sync(kFull, fvalid));
      const bool any_nan =
          __ballot_sync(kFull, (tvalid && isnan(tscore)) || (fvalid && isnan(fscore))) != 0;
      const float tkey = isnan(tscore) ? pos_inf() : __fadd_rn(tscore, 0.f);
      const float fkey = isnan(fscore) ? pos_inf() : __fadd_rn(fscore, 0.f);
      const int tid_ = lane < K ? s.id[lane] : 0;
      const int fid = t * KA + lane;
      bool trem = tvalid, frem = fvalid;
      int my_pick = -1;  // lane r < K: the candidate of new slot r
      for (int r = 0; r < K; ++r) {
        // this lane's best remaining candidate, then the warp's
        bool have = false;
        float key = neg_inf();
        int id = 0x7fffffff, which = 0;
        if (trem) {
          have = true;
          key = tkey;
          id = tid_;
          which = lane;
        }
        if (frem && (!have || fkey > key || (fkey == key && fid < id))) {
          have = true;
          key = fkey;
          id = fid;
          which = K + lane;
        }
        for (int o = 16; o > 0; o >>= 1) {
          const bool oh = __shfl_xor_sync(kFull, have, o);
          const float ok = __shfl_xor_sync(kFull, key, o);
          const int oi = __shfl_xor_sync(kFull, id, o);
          const int ow = __shfl_xor_sync(kFull, which, o);
          if (oh && (!have || ok > key || (ok == key && oi < id))) {
            have = true;
            key = ok;
            id = oi;
            which = ow;
          }
        }
        const int pick = have ? which : -1;
        if (lane == r) my_pick = pick;
        if (pick >= 0 && pick < K && lane == pick) trem = false;
        if (pick >= K && lane == pick - K) frem = false;
      }

      // ---- the next slots' scalars: lane r gathers those of its pick ----
      const bool from_tip = my_pick >= 0 && my_pick < K;
      const bool from_fresh = my_pick >= K;
      const int c = from_fresh ? my_pick - K : 0;
      const int j = from_tip ? my_pick : 0;
      const float g_tlab = __shfl_sync(kFull, tip_lab, j);
      const float g_tgap = __shfl_sync(kFull, tip_gap, j);
      const float g_mext = __shfl_sync(kFull, m_ext, c);
      const float g_p2new = __shfl_sync(kFull, p2new, c);
      const uint32_t g_th1 = __shfl_sync(kFull, th1, c);
      const uint32_t g_th2 = __shfl_sync(kFull, th2, c);
      int n_id = -2, n_ll = 0, n_pll = 0, n_boff = 0, n_bend = 0, n_pboff = 0, n_pbend = 0;
      int n_valid = 0, n_proot = 0;
      uint32_t n_h1 = 0u, n_h2 = 0u, n_ph1 = 0u, n_ph2 = 0u;
      float n_p1l = neg_inf(), n_p1g = neg_inf(), n_p2m = neg_inf();
      if (from_tip) {
        n_id = s.id[j];
        n_h1 = s.h1[j];
        n_h2 = s.h2[j];
        n_ph1 = s.ph1[j];
        n_ph2 = s.ph2[j];
        n_ll = s.ll[j];
        n_pll = s.pll[j];
        n_p1l = __fadd_rn(g_tlab, 0.f);
        n_p1g = __fadd_rn(g_tgap, 0.f);
        n_p2m = __fadd_rn(s.p2m[j], 0.f);
        n_boff = s.boff[j];
        n_bend = s.bend[j];
        n_pboff = s.pboff[j];
        n_pbend = s.pbend[j];
        n_proot = s.proot[j];
        n_valid = 1;
      } else if (from_fresh) {
        const int kk = c / A, aa = c - kk * A;
        n_id = t * KA + c;
        n_h1 = g_th1;
        n_h2 = g_th2;
        n_ph1 = s.h1[kk];
        n_ph2 = s.h2[kk];
        n_ll = aa;
        n_pll = s.ll[kk];
        n_p1l = __fadd_rn(g_mext, 0.f);
        n_p2m = __fadd_rn(g_p2new, 0.f);
        n_boff = lo;
        n_bend = hi;
        n_pboff = s.boff[kk];
        n_pbend = s.bend[kk];
        n_proot = s.id[kk] == -1;
        n_valid = 1;
      }
      __syncwarp();
      if (lane < K) {
        s.choice[lane] = my_pick;
        s.id[lane] = n_id;
        s.h1[lane] = n_h1;
        s.h2[lane] = n_h2;
        s.ph1[lane] = n_ph1;
        s.ph2[lane] = n_ph2;
        s.ll[lane] = n_ll;
        s.pll[lane] = n_pll;
        s.p1l[lane] = n_p1l;
        s.p1g[lane] = n_p1g;
        s.p2m[lane] = n_p2m;
        s.boff[lane] = n_boff;
        s.bend[lane] = n_bend;
        s.pboff[lane] = n_pboff;
        s.pbend[lane] = n_pbend;
        s.proot[lane] = n_proot;
        s.valid[lane] = n_valid;
      }
      if (lane == 0)
        s.err = (cnt >= 2 && any_nan) ? kIncomparable : (cnt == 0 ? kRanOut : 0);
    }
    __syncthreads();

    // ---- the next set's rows, by all threads: a chosen tip keeps its four
    // rows; a chosen fresh candidate takes its tip's own rows as its parent
    // copy and its own cells from the slab ----
    const int nxt = cur ^ 1;
    const int c_lo = ring(lo, Wk);
    for (int r = 0; r < K; ++r) {
      const int pick = s.choice[r];
      if (pick < 0) continue;
      const int src = pick < K ? pick : (pick - K) / A;
      if (pick < K) {
        for (int c = tid; c < Wk; c += kThreads) {
          row(nxt, 0, r)[c] = row(cur, 0, src)[c];
          row(nxt, 1, r)[c] = row(cur, 1, src)[c];
          row(nxt, 2, r)[c] = row(cur, 2, src)[c];
          row(nxt, 3, r)[c] = row(cur, 3, src)[c];
        }
      } else {
        for (int c = tid; c < Wk; c += kThreads) {
          row(nxt, 2, r)[c] = row(cur, 0, src)[c];
          row(nxt, 3, r)[c] = row(cur, 1, src)[c];
        }
        const float* from = cells + (pick - K);
        float* dl = row(nxt, 0, r);
        float* dg = row(nxt, 1, r);
        for (int j = tid; j < n_win; j += kThreads) {
          int col = c_lo + j;  // below 2 * Wk
          col = col >= Wk ? col - Wk : col;
          dl[col] = from[(size_t)(2 * j) * KA];
          dg[col] = from[(size_t)(2 * j + 1) * KA];
        }
      }
    }
    __syncthreads();
    cur = nxt;
    err = s.err;
  }
  if (tid == 0) {
    fin[b] = s.id[0];
    err_out[b] = err;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one pair's bands: two sets of four [K, Wk] rows.
// This is what bounds the band width the kernel takes.
long long ctc_duplex_slot_smem_bytes(int K, int Wk) {
  return 8LL * K * Wk * (long long)sizeof(float);
}

// f32 words of one pair's scratch slab: the fresh candidates' cells
// [Wk][2][K*A] and room for the stage rows [2][K][Wk].
long long ctc_duplex_slot_slab_words(int K, int A, int Wk) {
  return 2LL * K * A * Wk + 2LL * K * Wk;
}

// Dynamic shared memory the launch asks for: the stage rows go beside the
// bands when both fit, else into the slab.
static size_t slot_launch_smem(int K, int Wk, int* stage_in_smem) {
  const long long with_stage = 10LL * K * Wk * (long long)sizeof(float);
  *stage_in_smem = with_stage <= kSmemLimit;
  return *stage_in_smem ? (size_t)with_stage : (size_t)ctc_duplex_slot_smem_bytes(K, Wk);
}

// Threads of a block of either duplex kernel.
int ctc_duplex_block_threads() { return kThreads; }

// Blocks of the slot kernel that one SM holds at (K, Wk), by the runtime's
// occupancy calculation; negative: minus the cudaError_t.
int ctc_duplex_slot_blocks_per_sm(int K, int Wk) {
  int stage_in_smem = 0, blocks = 0;
  const size_t smem = slot_launch_smem(K, Wk, &stage_in_smem);
  cudaError_t rc = cudaFuncSetAttribute(
      duplex_slot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, duplex_slot_kernel, kThreads,
                                                       smem);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

// Launch the slot-band duplex forward beam on `stream`.  l1 [B, T1, A+1],
// l2 [B, T2, A+1], root_gap [B, Wr] f32; lo, hi [B, T1], lengths [B] i32
// (lower bounds non-decreasing per pair, Wk = max(hi - lo) + 2, K*A <= 32);
// slab [B, slab_stride] f32 scratch (slab_stride >=
// ctc_duplex_slot_slab_words(K, A, Wk), contents ignored); outputs ids_log
// [T1, K, B], fin [B], err [B] (i32).  All device memory allocated by the
// caller.  Returns the launch's cudaError_t (0 = launched).
int ctc_duplex_slot_launch(const float* l1, const float* l2, const float* root_gap,
                           const int* lo, const int* hi, const int* lengths, float thr,
                           int B, int T1, int T2, int A, int K, int Wr, int Wk,
                           int needs_ext, int collapse, float* slab, long long slab_stride,
                           int* ids_log, int* fin, int* err, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || A < 1 || K * A > kLanes || Wk < 2) return cudaErrorInvalidValue;
  if (slab_stride < ctc_duplex_slot_slab_words(K, A, Wk)) return cudaErrorInvalidValue;
  int stage_in_smem = 0;
  const size_t smem = slot_launch_smem(K, Wk, &stage_in_smem);
  cudaError_t rc = cudaFuncSetAttribute(
      duplex_slot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  duplex_slot_kernel<<<B, kThreads, smem, st>>>(
      l1, l2, root_gap, lo, hi, lengths, thr, B, T1, T2, A, K, Wr, Wk, needs_ext, collapse,
      slab, slab_stride, stage_in_smem, ids_log, fin, err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
