// Batched duplex pair-consensus beam search, slot-band form: the forward
// beam over all T1 steps of network_1, one warp per read pair.
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
// Design: one warp (one block of 32 threads) per pair, lane c = k*A + a
// holding fresh candidate (k, a) and lane k holding tip k, so K*A <= 32.
// Slot scalars live in shared arrays; the bands live in dynamic shared
// memory, two sets (current / next) of four [K, Wk] rows per slot set: own
// label, own gap, parent-copy label, parent-copy gap.  A band row is a ring
// over network_2 cells (column t2 mod Wk).  The kernel covers envelopes
// with non-decreasing lower bounds (the full range included): then every
// band's live cells [off, end) and every cell a step reads lie within
// [lo - 1, hi) of width < Wk = max(hi - lo) + 2, so the ring never aliases
// a live cell and needs no slides (the TPU kernel shifts its window-relative
// rows instead).  The wrapper refuses other envelopes.
//
// A step: lanes k < K log the entry ids; the extension (when the upper
// bound grows) runs slot by slot in node-id order, the window max
// warp-parallel over cells and the appended cells on lane 0; the expansion
// computes every candidate on its lane; pass 1 runs each fresh candidate's
// band cells on its lane and keeps only the running max ("select first,
// rebuild after", as the TPU kernel); K rounds of a warp arg-max select the
// beam; the chosen tips' rows are copied and the chosen fresh bands rebuilt
// (lane r rebuilds slot r with the same cell function) into the next set.
//
// What bounds it on this card: the serial cell chain.  Each step runs the
// band cells twice (pass 1 and the rebuild), each cell a dependent chain of
// three expf/log1pf logsumexps per lane; one warp per pair leaves an SM
// with few warps to hide that latency when the bands are wide (the full
// range at T2 = 500 takes 8*K*Wk*4 = 80 KB of shared memory per pair).  The
// simple design accepts that.
//
// Bit-parity rules: duplex_core.cuh's ls_add / ls_max; sums with __fadd_rn;
// labels pass the cut as !(p < thr) and blanks as p0 > thr; the selection
// key maps NaN to +inf and adds +0.0; picked probabilities add +0.0;
// INCOMPARABLE_VALUES needs a NaN score among >= 2 valid candidates.

#include "duplex_core.cuh"

namespace {

using namespace duplex;

constexpr int kLanes = 32;

struct Slots {
  int id[kLanes], ll[kLanes], pll[kLanes];
  int boff[kLanes], bend[kLanes], pboff[kLanes], pbend[kLanes];
  int valid[kLanes], proot[kLanes], order[kLanes];
  uint32_t h1[kLanes], h2[kLanes], ph1[kLanes], ph2[kLanes];
  float p1l[kLanes], p1g[kLanes], p2m[kLanes];
  // per-candidate staging for the selection
  float tlab[kLanes], tgap[kLanes], mext[kLanes], p2new[kLanes];
  uint32_t th1[kLanes], th2[kLanes];
  int choice[kLanes];  // new slot r: tip j (0..K-1), fresh K + c, or -1
};

__device__ __forceinline__ int ring(int t2, int Wk) {
  const int c = t2 % Wk;
  return c < 0 ? c + Wk : c;
}

// One band cell of candidate (tip k, label a) at t2: reads tip k's own band
// at t2 - 1 (the virtual root reads the root band), returns (lab, gap) and
// advances (last_lab, last_tot).
__device__ __forceinline__ void build_cell(const Slots& s, const float* own_lab,
                                           const float* own_gap, const float* l2row,
                                           const float* root_gap, int Wr, int Wk,
                                           int k, int a, bool is_rep, int t2,
                                           float& last_lab, float& last_tot,
                                           float& lab_n, float& gap_n) {
  const int pv = t2 - 1;
  const bool root = s.id[k] == -1;
  const bool t_ok = pv >= s.boff[k] && pv < s.bend[k];
  const int col = ring(pv, Wk);
  const float par_lab = (t_ok && !root) ? own_lab[col] : neg_inf();
  const float par_gap = root ? root_read(root_gap, Wr, pv) : (t_ok ? own_gap[col] : neg_inf());
  const float base = is_rep ? par_gap : ls_add(par_lab, par_gap);
  gap_n = __fadd_rn(last_tot, l2row[0]);
  lab_n = __fadd_rn(l2row[1 + a], ls_add(last_lab, base));
  last_lab = lab_n;
  last_tot = ls_add(lab_n, gap_n);
}

__global__ void __launch_bounds__(kLanes)
duplex_slot_kernel(const float* __restrict__ l1, const float* __restrict__ l2,
                   const float* __restrict__ root_gap_all, const int* __restrict__ lo_all,
                   const int* __restrict__ hi_all, const int* __restrict__ lengths,
                   float thr, int B, int T1, int T2, int A, int K, int Wr, int Wk,
                   int needs_ext, int collapse, int* __restrict__ ids_log,
                   int* __restrict__ fin, int* __restrict__ err_out) {
  extern __shared__ float bands[];  // [2][4][K][Wk]
  __shared__ Slots s;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int A1 = A + 1;
  const int KA = K * A;
  const float* l1b = l1 + (size_t)b * T1 * A1;
  const float* l2b = l2 + (size_t)b * T2 * A1;
  const float* root_gap = root_gap_all + (size_t)b * Wr;
  const int* lo_b = lo_all + (size_t)b * T1;
  const int* hi_b = hi_all + (size_t)b * T1;
  auto row = [&](int set, int arr, int k) -> float* {
    return bands + ((size_t)(set * 4 + arr) * K + k) * Wk;
  };

  if (lane < K) {
    const bool r0 = lane == 0;
    s.id[lane] = r0 ? -1 : -2;
    s.h1[lane] = r0 ? kSeed1 : 0u;
    s.h2[lane] = r0 ? kSeed2 : 0u;
    s.ph1[lane] = 0u;
    s.ph2[lane] = 0u;
    s.ll[lane] = -1;
    s.pll[lane] = -2;
    s.valid[lane] = r0;
    s.proot[lane] = 0;
    s.p1l[lane] = neg_inf();
    s.p1g[lane] = r0 ? 0.f : neg_inf();
    s.p2m[lane] = r0 ? 0.f : neg_inf();
    s.boff[lane] = s.bend[lane] = s.pboff[lane] = s.pbend[lane] = 0;
  }
  __syncwarp();
  const int len = lengths[b];
  int err = 0, last_upper = 0, cur = 0;

  for (int t = 0; t < T1; ++t) {
    if (lane < K) ids_log[((size_t)t * K + lane) * B + b] = s.id[lane];
    const int lo = lo_b[t], hi = hi_b[t];
    const bool in_range = t < len;
    const bool env_bad = in_range && (lo >= hi || lo > last_upper);
    if (err == 0 && env_bad) err = kInvalidEnvelope;
    if (!(err == 0 && in_range)) {
      // frozen from here on: only the id log grows
      for (int u = t + 1; u < T1; ++u)
        if (lane < K) ids_log[((size_t)u * K + lane) * B + b] = s.id[lane];
      break;
    }

    // ---- band extension, parents before children in node-id order ----
    if (needs_ext && hi > last_upper) {
      if (lane < K) {
        const int key = (s.valid[lane] && s.id[lane] >= 0) ? s.id[lane] : 0x7fffffff;
        int rank = 0;
        for (int j = 0; j < K; ++j) {
          const int kj = (s.valid[j] && s.id[j] >= 0) ? s.id[j] : 0x7fffffff;
          rank += (kj < key || (kj == key && j < lane)) ? 1 : 0;
        }
        s.order[rank] = lane;
      }
      __syncwarp();
      for (int r = 0; r < K; ++r) {
        const int sl = s.order[r];
        if (!(s.valid[sl] && s.id[sl] >= 0 && s.bend[sl] < hi)) continue;
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
          for (int t2 = c0 + lane; t2 < c1; t2 += kLanes) {
            const int col = ring(t2, Wk);
            v = ls_max(v, ls_add(lab[col], gap[col]));
          }
          p2m = warp_max(v);
        }
        __syncwarp();
        if (lane == 0) {
          const float* plab = row(cur, 2, sl);
          const float* pgap = row(cur, 3, sl);
          const bool is_rep = s.pll[sl] == s.ll[sl];
          const bool proot = s.proot[sl] != 0;
          float last_lab = neg_inf(), last_gap = neg_inf();
          if (end2 > off2) {
            const int col = ring(end2 - 1, Wk);
            last_lab = lab[col];
            last_gap = gap[col];
          }
          const int li = 1 + (s.ll[sl] < 0 ? 0 : (s.ll[sl] > A - 1 ? A - 1 : s.ll[sl]));
          for (int t2 = end2; t2 < hi; ++t2) {
            const float* r2 = l2b + (size_t)t2 * A1;
            const int pv = t2 - 1;
            const bool p_ok = pv >= s.pboff[sl] && pv < s.pbend[sl] && !proot;
            const int pc = ring(pv, Wk);
            const float ppl = p_ok ? plab[pc] : neg_inf();
            const float ppg = proot ? root_read(root_gap, Wr, pv) : (p_ok ? pgap[pc] : neg_inf());
            const float base = is_rep ? ppg : ls_add(ppl, ppg);
            const float gap_n = __fadd_rn(ls_add(last_lab, last_gap), r2[0]);
            const float lab_n = __fadd_rn(r2[li], ls_add(last_lab, base));
            const int col = ring(t2, Wk);
            lab[col] = lab_n;
            gap[col] = gap_n;
            p2m = ls_max(p2m, ls_add(lab_n, gap_n));
            last_lab = lab_n;
            last_gap = gap_n;
          }
          s.boff[sl] = off2;
          s.bend[sl] = hi;
          s.p2m[sl] = p2m;
        }
        __syncwarp();
        // refresh the parent copies of this slot's children
        for (int k = 0; k < K; ++k) {
          if (!(s.valid[k] && s.ph1[k] == s.h1[sl] && s.ph2[k] == s.h2[sl] && !s.proot[k]))
            continue;
          float* dl = row(cur, 2, k);
          float* dg = row(cur, 3, k);
          for (int c = lane; c < Wk; c += kLanes) {
            dl[c] = lab[c];
            dg[c] = gap[c];
          }
          if (lane == 0) {
            s.pboff[k] = off2;
            s.pbend[k] = hi;
          }
        }
        __syncwarp();
      }
    }
    last_upper = hi;

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

    // ---- pass 1: every fresh candidate's band max over [lo, hi) ----
    float p2new = neg_inf();
    if (is_cand) {
      const float* own_lab = row(cur, 0, k);
      const float* own_gap = row(cur, 1, k);
      float last_lab = neg_inf(), last_tot = neg_inf(), lab_n, gap_n;
      for (int t2 = lo; t2 < hi; ++t2) {
        build_cell(s, own_lab, own_gap, l2b + (size_t)t2 * A1, root_gap, Wr, Wk, k, a,
                   is_rep, t2, last_lab, last_tot, lab_n, gap_n);
        p2new = ls_max(p2new, last_tot);
      }
    }
    const float fscore = __fadd_rn(ls_add(fvalid ? m_ext : neg_inf(), neg_inf()), p2new);

    // ---- selection: K rounds of (max key, tie -> min id) ----
    const int cnt = __popc(__ballot_sync(kFull, tvalid)) + __popc(__ballot_sync(kFull, fvalid));
    const bool any_nan =
        __ballot_sync(kFull, (tvalid && isnan(tscore)) || (fvalid && isnan(fscore))) != 0;
    const float tkey = isnan(tscore) ? pos_inf() : __fadd_rn(tscore, 0.f);
    const float fkey = isnan(fscore) ? pos_inf() : __fadd_rn(fscore, 0.f);
    const int tid = lane < K ? s.id[lane] : 0;
    const int fid = t * KA + lane;
    bool trem = tvalid, frem = fvalid;
    if (lane < K) {
      s.tlab[lane] = tip_lab;
      s.tgap[lane] = tip_gap;
    }
    if (is_cand) {
      s.mext[lane] = m_ext;
      s.p2new[lane] = p2new;
      s.th1[lane] = th1;
      s.th2[lane] = th2;
    }
    for (int r = 0; r < K; ++r) {
      // this lane's best remaining candidate, then the warp's
      bool have = false;
      float key = neg_inf();
      int id = 0x7fffffff, which = 0;
      if (trem) {
        have = true;
        key = tkey;
        id = tid;
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
      if (lane == 0) s.choice[r] = pick;
      if (pick >= 0 && pick < K && lane == pick) trem = false;
      if (pick >= K && lane == pick - K) frem = false;
    }
    __syncwarp();

    // ---- next slots: copy the chosen tips' rows, rebuild chosen fresh bands ----
    const int nxt = cur ^ 1;
    for (int r = 0; r < K; ++r) {
      const int pick = s.choice[r];
      if (pick < 0) continue;
      const int src = pick < K ? pick : (pick - K) / A;
      for (int c = lane; c < Wk; c += kLanes) {
        if (pick < K) {
          row(nxt, 0, r)[c] = row(cur, 0, src)[c];
          row(nxt, 1, r)[c] = row(cur, 1, src)[c];
          row(nxt, 2, r)[c] = row(cur, 2, src)[c];
          row(nxt, 3, r)[c] = row(cur, 3, src)[c];
        } else {
          row(nxt, 2, r)[c] = row(cur, 0, src)[c];
          row(nxt, 3, r)[c] = row(cur, 1, src)[c];
        }
      }
    }
    int n_id = -2, n_ll = 0, n_pll = 0, n_boff = 0, n_bend = 0, n_pboff = 0, n_pbend = 0;
    int n_valid = 0, n_proot = 0;
    uint32_t n_h1 = 0u, n_h2 = 0u, n_ph1 = 0u, n_ph2 = 0u;
    float n_p1l = neg_inf(), n_p1g = neg_inf(), n_p2m = neg_inf();
    if (lane < K) {
      const int pick = s.choice[lane];
      if (pick >= 0 && pick < K) {
        const int j = pick;
        n_id = s.id[j];
        n_h1 = s.h1[j];
        n_h2 = s.h2[j];
        n_ph1 = s.ph1[j];
        n_ph2 = s.ph2[j];
        n_ll = s.ll[j];
        n_pll = s.pll[j];
        n_p1l = __fadd_rn(s.tlab[j], 0.f);
        n_p1g = __fadd_rn(s.tgap[j], 0.f);
        n_p2m = __fadd_rn(s.p2m[j], 0.f);
        n_boff = s.boff[j];
        n_bend = s.bend[j];
        n_pboff = s.pboff[j];
        n_pbend = s.pbend[j];
        n_proot = s.proot[j];
        n_valid = 1;
      } else if (pick >= K) {
        const int c = pick - K, kk = c / A, aa = c - kk * A;
        n_id = t * KA + c;
        n_h1 = s.th1[c];
        n_h2 = s.th2[c];
        n_ph1 = s.h1[kk];
        n_ph2 = s.h2[kk];
        n_ll = aa;
        n_pll = s.ll[kk];
        n_p1l = __fadd_rn(s.mext[c], 0.f);
        n_p2m = __fadd_rn(s.p2new[c], 0.f);
        n_boff = lo;
        n_bend = hi;
        n_pboff = s.boff[kk];
        n_pbend = s.bend[kk];
        n_proot = s.id[kk] == -1;
        n_valid = 1;
        // rebuild the band of candidate (kk, aa) into slot `lane`
        float* dl = row(nxt, 0, lane);
        float* dg = row(nxt, 1, lane);
        const float* own_lab = row(cur, 0, kk);
        const float* own_gap = row(cur, 1, kk);
        const bool rep = collapse && s.ll[kk] == aa;
        float last_lab = neg_inf(), last_tot = neg_inf(), lab_n, gap_n;
        for (int t2 = lo; t2 < hi; ++t2) {
          build_cell(s, own_lab, own_gap, l2b + (size_t)t2 * A1, root_gap, Wr, Wk, kk, aa,
                     rep, t2, last_lab, last_tot, lab_n, gap_n);
          const int col = ring(t2, Wk);
          dl[col] = lab_n;
          dg[col] = gap_n;
        }
      }
    }
    __syncwarp();
    if (lane < K) {
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
    __syncwarp();
    cur = nxt;
    err = (cnt >= 2 && any_nan) ? kIncomparable : (cnt == 0 ? kRanOut : 0);
  }
  if (lane == 0) {
    fin[b] = s.id[0];
    err_out[b] = err;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one pair's bands: two sets of four [K, Wk] rows.
long long ctc_duplex_slot_smem_bytes(int K, int Wk) {
  return 8LL * K * Wk * (long long)sizeof(float);
}

// Launch the slot-band duplex forward beam on `stream`.  l1 [B, T1, A+1],
// l2 [B, T2, A+1], root_gap [B, Wr] f32; lo, hi [B, T1], lengths [B] i32
// (lower bounds non-decreasing per pair, Wk = max(hi - lo) + 2, K*A <= 32);
// outputs ids_log [T1, K, B], fin [B], err [B] (i32).  All device memory
// allocated by the caller.  Returns the launch's cudaError_t (0 = launched).
int ctc_duplex_slot_launch(const float* l1, const float* l2, const float* root_gap,
                           const int* lo, const int* hi, const int* lengths, float thr,
                           int B, int T1, int T2, int A, int K, int Wr, int Wk,
                           int needs_ext, int collapse, int* ids_log, int* fin, int* err,
                           void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || A < 1 || K * A > kLanes || Wk < 2) return cudaErrorInvalidValue;
  const size_t smem = (size_t)ctc_duplex_slot_smem_bytes(K, Wk);
  cudaError_t rc = cudaFuncSetAttribute(
      duplex_slot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  duplex_slot_kernel<<<B, kLanes, smem, st>>>(
      l1, l2, root_gap, lo, hi, lengths, thr, B, T1, T2, A, K, Wr, Wk, needs_ext, collapse,
      ids_log, fin, err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
