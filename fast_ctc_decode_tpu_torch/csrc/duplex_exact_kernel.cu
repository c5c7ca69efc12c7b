// Batched duplex pair-consensus beam search over a per-pair suffix tree with
// reference band reuse, plain and CRF: the exact duplex engine.
//
// Replaces: fast_ctc_decode_tpu/ops/duplex_exact_pallas.py::_exact_duplex_kernel
// (behind duplex_exact_pallas_batch), in both forms.  It computes what the
// plain engine fast_ctc_decode_tpu_torch/ops/duplex.py::duplex_exact_batch
// computes, bit for bit: nodes allocated in the reference's add_node order
// (tip-major, labels ascending); every node's band persists for the whole
// decode and is built once, cell by cell in the reference's order, when the
// node is made; on steps where the envelope's upper bound grows the beam is
// node-sorted (the reference's in-place sort, which that step's expansion
// keeps) and each live node's band is extended in place, parents before
// children (discard below lo - 1, window max, cells [end, hi) reading the
// parent's band as just extended); blank + stay + one arrival per node; K
// rounds of (max score, tie -> min node id) with valid -inf scores keyed
// just above the invalid fill; NODE_OVERFLOW past max_nodes; the traceback
// of slot 0's parent chain, leaf first.
//
// Design, for this card.  One block of kThreads = 128 threads (four warps)
// per pair.  Warp 0 holds the beam: lane c = k*A + a for candidate (tip k,
// label a), so K*A <= 32; the beam lives in shared arrays.  The tree and the
// bands live in uninitialised global scratch, one slab per pair, sized to
// the caller's max_nodes N:
//   parent [N] | label [N] | boff [N] | blen [N] | borg [N] | child
//   [(N+1)*A] (row node+1) | bmax [N] f32 | blab [N*W] f32 | bgap [N*W] f32
//   | stage [2*K*W] f32
// A node's band row is a ring: cell t2 sits in column (borg + t2 - boff)
// mod W, so discard_until moves boff and borg and no cell (the plain engine
// rolls the row; the ring is that roll without the copy).  A child lookup
// is accepted only if the id is below the pair's node count and parent /
// label of that node name the tip and label looked up (children are unique
// per (parent, label), so garbage never passes), as in exact_beam_kernel.cu.
// Node ids are plain int32: no packed words, no node cap of the kernel's own
// and no re-run elsewhere, unlike the TPU kernel.
//
// A step: warp 0 looks the children up and allocates in add_node order (the
// ballot ranks of the lanes that miss their child); all threads read the
// bands of the tips that got a new child at the cell before, for the whole
// window, into the stage rows; each lane of warp 0 that made a node runs
// that node's band (duplex_core.cuh's cell_chain); warp 0 merges and
// selects in K rounds of a warp arg-max.
//
// What bounds it: latency, of the band-cell recurrence (a serial chain per
// new node that no f32-exact rewrite can spread over lanes) and of the
// dependent scattered loads of the tree.  What the design does about it:
//   - the chain carries one logsumexp per cell, not three: base =
//     ls_add(par_lab, par_gap) depends on the tip's band only, so it is
//     computed for the whole window by all threads ahead of the chains and
//     staged (totals, then gaps for repeats) in shared memory, or in the
//     slab's stage rows when 2*K*W floats exceed kStageSmemLimit: one code
//     path, the launch picks the pointer;
//   - a discard moves an index, not the row;
//   - the extension runs the live slots by dependency level, one warp per
//     slot (a slot waits only for its parent, if that is live; parents have
//     the smaller node ids, so the node-sorted beam is a valid order): the
//     window max and the appended cells' bases over the warp's lanes, the
//     appended cells as a cell_chain on lane 0, with the slot's node, its
//     parent and both labels read once into shared memory by the plan.
// Four warps: the block-wide phases are short beside the chains and the
// tree's loads, so more warps would idle; a block's shared memory (the
// stage rows, 3.3 KB on a 40-cell diagonal at beam 5) leaves the SM's limit
// of blocks to the scheduler.
//
// Bit-parity rules: duplex_core.cuh's ls_add (ls_add<true>, expf and log1pf
// correctly rounded, in the CRF instance) / ls_max; sums with __fadd_rn;
// labels pass the cut as !(p < thr) and blanks as p0 > thr; the selection
// key maps NaN to +inf, a valid -inf score to -3e38 and adds +0.0;
// INCOMPARABLE_VALUES needs a NaN score among >= 2 valid candidates; within
// a step the status priority is overflow > NaN > empty beam.

#include "duplex_core.cuh"

namespace {

using namespace duplex;

constexpr int kLanes = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kLanes * kWarps;
constexpr int kStageSmemLimit = 64 * 1024;  // stage rows beyond this go to the slab
constexpr float kNegValid = -3.0e38f;

struct Beam {
  int node[kLanes], state[kLanes], valid[kLanes];
  float p1l[kLanes], p1g[kLanes], p2m[kLanes];
  // the extension's plan, per slot of the node-sorted beam
  int par[kLanes], lbl[kLanes], par_lbl[kLanes];
  signed char live[kLanes], dep[kLanes], lev[kLanes];
  int hoist[kLanes];  // tip k got a new child this step
  int n_lev, err;
};

struct Tree {
  int* parent;
  int* label;
  int* boff;
  int* blen;
  int* borg;
  int* child;
  float* bmax;
  float* blab;
  float* bgap;
};

// Where a node's band stands: cells [off, off + len), cell off in ring
// column org.  The virtual root (node < 0) has none: it reads the root band.
struct Band {
  int off, len, org;
  const float* lab;
  const float* gap;
};

__device__ __forceinline__ Band band_of(const Tree& tr, int W, int node) {
  Band bd = {0, 0, 0, tr.blab, tr.bgap};
  if (node >= 0) {
    bd.off = tr.boff[node];
    bd.len = tr.blen[node];
    bd.org = tr.borg[node];
    bd.lab = tr.blab + (size_t)node * W;
    bd.gap = tr.bgap + (size_t)node * W;
  }
  return bd;
}

// (label, gap) value of a band at cell t2; the virtual root (is_root) reads
// the root band; out of window: -inf.
__device__ __forceinline__ void band_get(const Band& bd, bool is_root, const float* root_gap,
                                         int Wr, int W, int t2, float& lab, float& gap) {
  if (is_root) {
    lab = neg_inf();
    gap = root_read(root_gap, Wr, t2);
    return;
  }
  const int idx = t2 - bd.off;
  if (idx >= 0 && idx < bd.len) {
    int col = bd.org + (idx < W ? idx : W - 1);  // below 2 * W
    col = col >= W ? col - W : col;
    lab = bd.lab[col];
    gap = bd.gap[col];
  } else {
    lab = neg_inf();
    gap = neg_inf();
  }
}

template <bool CRF>
__global__ void __launch_bounds__(kThreads)
duplex_exact_kernel(const float* __restrict__ l1, const float* __restrict__ l2,
                    const float* __restrict__ root_gap_all, const int* __restrict__ lo_all,
                    const int* __restrict__ hi_all, const int* __restrict__ init_states,
                    const int* __restrict__ lengths, float thr, int B, int T1, int T2,
                    int S, int A, int K, int N, int W, int Wr, int needs_ext, int collapse,
                    int* __restrict__ scratch, long long stride, int stage_in_smem,
                    int* __restrict__ labels_rev, int* __restrict__ count_out,
                    int* __restrict__ err_out) {
  extern __shared__ float stage_smem[];  // [2][K][W] when it fits
  __shared__ Beam bm;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & (kLanes - 1);
  const int warp = tid / kLanes;
  const int A1 = A + 1;
  const int KA = K * A;
  const float* l1b = l1 + (size_t)b * T1 * S * A1;
  const float* __restrict__ l2b = l2 + (size_t)b * T2 * S * A1;
  const float* root_gap = root_gap_all + (size_t)b * Wr;
  const int* lo_b = lo_all + (size_t)b * T1;
  const int* hi_b = hi_all + (size_t)b * T1;
  int* base = scratch + (size_t)b * (size_t)stride;
  Tree tr;
  tr.parent = base;
  tr.label = base + N;
  tr.boff = base + 2 * (size_t)N;
  tr.blen = base + 3 * (size_t)N;
  tr.borg = base + 4 * (size_t)N;
  tr.child = base + 5 * (size_t)N;
  tr.bmax = reinterpret_cast<float*>(tr.child + (size_t)(N + 1) * A);
  tr.blab = tr.bmax + N;
  tr.bgap = tr.blab + (size_t)N * W;
  // stage rows [2][K][W]: row k the totals of tip k's band (or the bases of
  // slot k's extension), row K + k the gaps of tip k's band
  float* stage = stage_in_smem ? stage_smem : tr.bgap + (size_t)N * W;
  auto clamp_s = [&](int s) { return s < 0 ? 0 : (s > S - 1 ? S - 1 : s); };
  // network rows: plain [T, A+1]; CRF [T, S, A+1] at the given state
  auto row1 = [&](int t, int st) { return l1b + ((size_t)t * S + (CRF ? clamp_s(st) : 0)) * A1; };
  auto row2 = [&](int t2, int st) {
    const int tc = t2 < 0 ? 0 : (t2 > T2 - 1 ? T2 - 1 : t2);
    return l2b + ((size_t)tc * S + (CRF ? clamp_s(st) : 0)) * A1;
  };

  if (tid < K) {
    const bool r0 = tid == 0;
    bm.node[tid] = r0 ? -1 : -2;
    bm.state[tid] = r0 ? init_states[b] : 0;
    bm.valid[tid] = r0;
    bm.p1l[tid] = neg_inf();
    bm.p1g[tid] = r0 ? 0.f : neg_inf();
    bm.p2m[tid] = r0 ? 0.f : neg_inf();
  }
  __syncthreads();
  const int len = lengths[b];
  int err = 0, last_upper = 0, n_nodes = 0;

  for (int t = 0; t < T1; ++t) {
    const int lo = lo_b[t], hi = hi_b[t];
    const bool in_range = t < len;
    const bool env_bad = in_range && (lo >= hi || lo > last_upper);
    if (err == 0 && env_bad) err = kInvalidEnvelope;
    if (!(err == 0 && in_range)) break;  // frozen from here on

    // ---- node-sorted beam, then band extension, parents before children ----
    if (needs_ext && hi > last_upper) {
      if (warp == 0) {
        int f_node = 0, f_state = 0, f_valid = 0, rank = 0;
        float f_l = 0.f, f_g = 0.f, f_p2 = 0.f;
        if (lane < K) {
          f_node = bm.node[lane];
          f_state = bm.state[lane];
          f_valid = bm.valid[lane];
          f_l = bm.p1l[lane];
          f_g = bm.p1g[lane];
          f_p2 = bm.p2m[lane];
          const int key = f_valid ? f_node : 0x7fffffff;
          for (int j = 0; j < K; ++j) {
            const int kj = bm.valid[j] ? bm.node[j] : 0x7fffffff;
            rank += (kj < key || (kj == key && j < lane)) ? 1 : 0;
          }
        }
        __syncwarp();
        if (lane < K) {
          bm.node[rank] = f_node;
          bm.state[rank] = f_state;
          bm.valid[rank] = f_valid;
          bm.p1l[rank] = f_l;
          bm.p1g[rank] = f_g;
          bm.p2m[rank] = f_p2;
          // the plan: this node's parent and both labels, read once
          const bool live = f_node >= 0 && f_valid;
          const int par = live ? tr.parent[f_node] : -1;
          bm.live[rank] = live;
          bm.par[rank] = par;
          bm.lbl[rank] = live ? tr.label[f_node] : -1;
          bm.par_lbl[rank] = par >= 0 ? tr.label[par] : -1;
        }
        __syncwarp();
        if (lane == 0) {
          // a slot waits for the slot that holds its parent, which stands
          // before it in the node-sorted beam
          int n_lev = 0;
          for (int s = 0; s < K; ++s) {
            int dep = -1;
            if (bm.live[s] && bm.par[s] >= 0)
              for (int j = 0; j < s; ++j)
                if (bm.live[j] && bm.node[j] == bm.par[s]) dep = j;
            const int lv = dep < 0 ? 0 : bm.lev[dep] + 1;
            bm.dep[s] = (signed char)dep;
            bm.lev[s] = (signed char)lv;
            if (bm.live[s] && lv + 1 > n_lev) n_lev = lv + 1;
          }
          bm.n_lev = n_lev;
        }
      }
      __syncthreads();
      const int n_lev = bm.n_lev;
      for (int lv = 0; lv < n_lev; ++lv) {
        for (int s = warp; s < K; s += kWarps) {  // one warp per slot of this level
          if (!(bm.live[s] && bm.lev[s] == lv)) continue;
          const int n = bm.node[s];
          const int off = tr.boff[n], ln = tr.blen[n], org = tr.borg[n];
          const bool do_discard = lo > off;
          const int shift = (lo - 1) - off;
          const bool emptied = ln - shift <= 0;
          const int off2 = do_discard ? (emptied ? lo : lo - 1) : off;
          const int L2 = do_discard ? (emptied ? 0 : ln - shift) : ln;
          // discard_until(lo - 1): the kept cells stay where they are, the
          // ring's origin moves (one division per slot and step)
          const int org2 = do_discard ? (int)(((long long)org + shift) % W) : org;
          float* rl = tr.blab + (size_t)n * W;
          float* rg = tr.bgap + (size_t)n * W;
          float mx = tr.bmax[n];
          if (do_discard) {  // update_max(lo, hi) over the kept window
            float v = neg_inf();
            const int jn = L2 < W ? L2 : W;
            int col = wrap(org2 + lane, W);
            for (int j = lane; j < jn; j += kLanes) {
              const int t2 = off2 + j;
              if (t2 >= lo && t2 < hi) v = ls_max(v, ls_add<CRF>(rl[col], rg[col]));
              col = wrap(col + kLanes, W);
            }
            mx = warp_max(v);
          }
          const int par = bm.par[s];
          const Band pb = band_of(tr, W, par);
          // the CRF extension recurrence has no repeat branch
          const bool prep = !CRF && bm.par_lbl[s] == bm.lbl[s];
          const int lbl = bm.lbl[s];
          const int li = 1 + (lbl < 0 ? 0 : (lbl > A - 1 ? A - 1 : lbl));
          const int st = bm.state[s];
          float last_lab = neg_inf(), last_gap = neg_inf();
          if (L2 > 0) {
            const int c = wrap(org2 + ((L2 - 1) < W ? L2 - 1 : W - 1), W);
            last_lab = rl[c];
            last_gap = rg[c];
          }
          float last_tot = ls_add<CRF>(last_lab, last_gap);
          // appended cells [off2 + L2, hi), a stage row at a time: their
          // bases over the lanes, then the chain on lane 0
          float* bases = stage + (size_t)s * W;
          const int first = off2 + L2;
          for (int c0 = first; c0 < hi; c0 += W) {
            const int n_new = hi - c0 < W ? hi - c0 : W;
            for (int j = lane; j < n_new; j += kLanes) {
              float pvl, pvg;
              band_get(pb, par < 0, root_gap, Wr, W, c0 + j - 1, pvl, pvg);
              bases[j] = prep ? pvg : ls_add<CRF>(pvl, pvg);
            }
            __syncwarp();
            if (lane == 0) {
              int w = c0 - off2;  // the cell's column before the ring, clamped
              cell_chain<CRF>(
                  n_new, last_lab, last_tot, mx,
                  [&](int j, float& bse, float& r0, float& ra) {
                    const float* r2 = row2(c0 + j, st);
                    bse = bases[j];
                    r0 = r2[0];
                    ra = r2[li];
                  },
                  [&](int, float lab_n, float gap_n) {
                    const int wc = w < 0 ? 0 : (w > W - 1 ? W - 1 : w);
                    int col = org2 + wc;  // below 2 * W
                    col = col >= W ? col - W : col;
                    rl[col] = lab_n;
                    rg[col] = gap_n;
                    ++w;
                  });
            }
            __syncwarp();
          }
          if (lane == 0) {
            tr.boff[n] = off2;
            tr.blen[n] = L2 > hi - off2 ? L2 : hi - off2;
            tr.borg[n] = org2;
            tr.bmax[n] = mx;
          }
        }
        __syncthreads();
      }
    }
    last_upper = hi;

    // ---- expansion (warp 0): child lookups, allocation in add_node order ----
    bool pushed = false, is_rep = false, needs_new = false, overflow = false;
    int k = 0, a = 0, nk = -2, nid = -1, new_id = -1;
    float plab = neg_inf();
    if (warp == 0) {
      const bool is_cand = lane < KA;
      k = is_cand ? lane / A : 0;
      a = is_cand ? lane - k * A : 0;
      nk = bm.node[k];
      const bool vk = is_cand && bm.valid[k];
      const float* r1k = row1(t, bm.state[k]);
      plab = r1k[1 + a];
      pushed = vk && !(plab < thr);
      const int tip_lbl_k = nk >= 0 ? tr.label[nk] : -1;
      is_rep = !CRF && collapse && tip_lbl_k == a;
      int ch = -1;
      if (vk) {
        const int e = tr.child[(size_t)(nk + 1) * A + a];
        if (e >= 0 && e < n_nodes && tr.parent[e] == nk && tr.label[e] == a) ch = e;
      }
      needs_new = pushed && ch < 0 && (!is_rep || bm.p1g[k] > neg_inf());
      const unsigned bal = __ballot_sync(kFull, needs_new);
      const int total = __popc(bal);
      const int rank = __popc(bal & ((1u << lane) - 1u));
      overflow = n_nodes + total > N;
      if (needs_new && n_nodes + rank < N) {
        new_id = n_nodes + rank;
        tr.parent[new_id] = nk;
        tr.label[new_id] = a;
        tr.child[(size_t)(nk + 1) * A + a] = new_id;
      }
      n_nodes = n_nodes + total < N ? n_nodes + total : N;
      nid = ch >= 0 ? ch : new_id;
      // which tips' bands the new nodes read
      if (lane < K) bm.hoist[lane] = 0;
      __syncwarp();
      if (new_id >= 0) bm.hoist[k] = 1;
    }
    __syncthreads();

    // ---- the bands of those tips at the cell before, for the whole window:
    // the chains' bases, by all threads ----
    const int n_cells = (hi - lo) < W ? hi - lo : W;
    for (int kk = 0; kk < K; ++kk) {
      if (!bm.hoist[kk]) continue;
      const int node = bm.node[kk];
      const Band tb = band_of(tr, W, node);
      float* tot_row = stage + (size_t)kk * W;
      float* gap_row = stage + (size_t)(K + kk) * W;
      for (int j = tid; j < n_cells; j += kThreads) {
        float pvl, pvg;
        band_get(tb, node < 0, root_gap, Wr, W, lo + j - 1, pvl, pvg);
        tot_row[j] = ls_add<CRF>(pvl, pvg);
        gap_row[j] = pvg;
      }
    }
    __syncthreads();

    if (warp == 0) {
      // ---- a new node's band: the cells of [lo, hi), one chain per lane ----
      if (new_id >= 0) {
        float* dl = tr.blab + (size_t)new_id * W;
        float* dg = tr.bgap + (size_t)new_id * W;
        const float* bs = stage + (size_t)((is_rep ? K : 0) + k) * W;
        const int st = bm.state[k];
        float last_lab = neg_inf(), last_tot = neg_inf(), mx = neg_inf();
        cell_chain<CRF>(
            n_cells, last_lab, last_tot, mx,
            [&](int j, float& bse, float& r0, float& ra) {
              const float* r2 = row2(lo + j, st);
              bse = bs[j];
              r0 = r2[0];
              ra = r2[1 + a];
            },
            [&](int j, float lab_n, float gap_n) {
              dl[j] = lab_n;
              dg[j] = gap_n;
            });
        tr.boff[new_id] = lo;
        tr.blen[new_id] = hi - lo;
        tr.borg[new_id] = 0;
        tr.bmax[new_id] = mx;
      }
      __syncwarp();

      // ---- analytic merge: a node receives blank + stay + ONE nid mass ----
      const float p1tot_k = ls_add<CRF>(bm.p1l[k], bm.p1g[k]);
      float m_nid = __fadd_rn(p1tot_k, plab);
      if (is_rep) m_nid = __fadd_rn(bm.p1g[k], plab);
      const bool push_nid = pushed && nid >= 0;
      bool matched = false;
      for (int j = 0; j < K; ++j)
        matched = matched || (push_nid && bm.valid[j] && bm.node[j] == nid);
      const bool fvalid = push_nid && !matched;
      const int fstate = CRF ? (bm.state[k] * A) % S + a : 0;
      float recv = neg_inf();
      bool recv_any = false;
      for (int j = 0; j < K; ++j) {
        const bool hit = push_nid && bm.valid[j] && bm.node[j] == nid;
        const unsigned hb = __ballot_sync(kFull, hit);
        const float v = __shfl_sync(kFull, m_nid, hb ? __ffs(hb) - 1 : 0);
        if (lane == j && hb) {
          recv = v;
          recv_any = true;
        }
      }
      bool tvalid = false;
      float tlab = neg_inf(), tgap = neg_inf();
      if (lane < K) {
        const bool vj = bm.valid[lane];
        const int nj = bm.node[lane];
        const float* r1j = row1(t, bm.state[lane]);
        const float p0 = r1j[0];
        const float p1tot = ls_add<CRF>(bm.p1l[lane], bm.p1g[lane]);
        const bool push_b = vj && p0 > thr;
        if (push_b) tgap = __fadd_rn(p1tot, p0);
        bool stay_any = false;
        float stay = neg_inf();
        if (!CRF && collapse) {
          const int tl = nj >= 0 ? tr.label[nj] : -1;
          if (vj && tl >= 0 && tl < A && !(r1j[1 + tl] < thr)) {
            stay_any = true;
            stay = __fadd_rn(bm.p1l[lane], r1j[1 + tl]);
          }
        }
        tlab = ls_add<CRF>(stay, recv);
        tvalid = push_b || stay_any || recv_any;
      }

      // ---- selection: K rounds of (max key, tie -> min node) ----
      const int tnode = lane < K ? bm.node[lane] : 0;
      const float tp2 =
          (tvalid && tnode >= 0) ? tr.bmax[tnode] : (lane < K ? bm.p2m[lane] : neg_inf());
      const float fp2 = (fvalid && nid >= 0) ? tr.bmax[nid] : neg_inf();
      const float tscore = __fadd_rn(ls_add<CRF>(tlab, tgap), tp2);
      const float fscore = __fadd_rn(ls_add<CRF>(m_nid, neg_inf()), fp2);
      const int cnt =
          __popc(__ballot_sync(kFull, tvalid)) + __popc(__ballot_sync(kFull, fvalid));
      const bool any_nan =
          __ballot_sync(kFull, (tvalid && isnan(tscore)) || (fvalid && isnan(fscore))) != 0;
      auto keyof = [](bool v, float sc) {
        if (!v) return neg_inf();
        if (isnan(sc)) return pos_inf();
        return sc == neg_inf() ? kNegValid : __fadd_rn(sc, 0.f);
      };
      float tkey = keyof(tvalid, tscore), fkey = keyof(fvalid, fscore);
      int n_node = -2, n_state = 0, n_valid = 0;
      float n_l = neg_inf(), n_g = neg_inf(), n_p2 = neg_inf();
      for (int r = 0; r < K; ++r) {
        float key = tkey;
        int id = tnode, which = 0;  // 0: this lane's tip, 1: its nid candidate
        if (fkey > key || (fkey == key && fkey > neg_inf() && nid < id)) {
          key = fkey;
          id = nid;
          which = 1;
        }
        int src = lane;
        for (int o = 16; o > 0; o >>= 1) {
          const float ok = __shfl_xor_sync(kFull, key, o);
          const int oi = __shfl_xor_sync(kFull, id, o);
          const int ow = __shfl_xor_sync(kFull, which, o);
          const int os = __shfl_xor_sync(kFull, src, o);
          if (ok > key ||
              (ok == key && ok > neg_inf() && (oi < id || (oi == id && os < src)))) {
            key = ok;
            id = oi;
            which = ow;
            src = os;
          }
        }
        if (!(key > neg_inf())) continue;  // no candidate left: slot stays empty
        const float vl = __shfl_sync(kFull, which ? m_nid : tlab, src);
        const float vg = __shfl_sync(kFull, which ? neg_inf() : tgap, src);
        const float vp = __shfl_sync(kFull, which ? fp2 : tp2, src);
        const int vs = __shfl_sync(kFull, which ? fstate : (lane < K ? bm.state[lane] : 0), src);
        if (lane == r) {
          n_node = id;
          n_l = vl;
          n_g = vg;
          n_p2 = vp;
          n_state = vs;
          n_valid = 1;
        }
        if (lane == src) {
          if (which) fkey = neg_inf();
          else tkey = neg_inf();
        }
      }
      __syncwarp();
      if (lane < K) {
        bm.node[lane] = n_node;
        bm.state[lane] = n_state;
        bm.valid[lane] = n_valid;
        bm.p1l[lane] = n_l;
        bm.p1g[lane] = n_g;
        bm.p2m[lane] = n_p2;
      }
      if (lane == 0)
        bm.err = overflow ? kOverflow
                          : ((cnt >= 2 && any_nan) ? kIncomparable : (cnt == 0 ? kRanOut : 0));
    }
    __syncthreads();
    err = bm.err;
  }

  // ---- traceback: slot 0's parent chain, leaf first, -1 padded ----
  if (tid == 0) {
    int* row = labels_rev + (size_t)b * T1;
    int cur = bm.node[0];
    int n = 0;
    while (cur >= 0 && n < T1) {
      row[n++] = tr.label[cur];
      cur = tr.parent[cur];
    }
    count_out[b] = n;
    err_out[b] = err;
    for (int i = n; i < T1; ++i) row[i] = -1;
  }
}

// Bytes of the stage rows when they live in shared memory, else 0.
size_t stage_smem_bytes(int K, int W) {
  const long long bytes = 2LL * K * W * (long long)sizeof(float);
  return bytes <= kStageSmemLimit ? (size_t)bytes : 0;
}

template <bool CRF>
cudaError_t launch(const float* l1, const float* l2, const float* root_gap, const int* lo,
                   const int* hi, const int* init_states, const int* lengths, float thr,
                   int B, int T1, int T2, int S, int A, int K, int N, int W, int Wr,
                   int needs_ext, int collapse, int* scratch, long long stride,
                   int* labels_rev, int* count, int* err, cudaStream_t st) {
  const size_t smem = stage_smem_bytes(K, W);
  cudaError_t rc = cudaFuncSetAttribute(
      duplex_exact_kernel<CRF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  duplex_exact_kernel<CRF><<<B, kThreads, smem, st>>>(
      l1, l2, root_gap, lo, hi, init_states, lengths, thr, B, T1, T2, S, A, K, N, W, Wr,
      needs_ext, collapse, scratch, stride, smem > 0, labels_rev, count, err);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 words of one pair's tree, bands and stage rows (see the layout above).
long long ctc_duplex_exact_stride(int N, int K, int A, int W) {
  return 6LL * N + (long long)(N + 1) * A + 2LL * N * W + 2LL * K * W;
}

// Blocks of the tree kernel (crf: its CRF instance) that one SM holds at
// (K, W), by the runtime's occupancy calculation; negative: minus the
// cudaError_t.
int ctc_duplex_exact_blocks_per_sm(int K, int W, int crf) {
  int blocks = 0;
  const size_t smem = stage_smem_bytes(K, W);
  cudaError_t rc =
      crf ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, duplex_exact_kernel<true>,
                                                          kThreads, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, duplex_exact_kernel<false>,
                                                          kThreads, smem);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

// Launch the exact duplex beam on `stream`.  l1 [B, T1, A+1] / l2 [B, T2,
// A+1] (crf = 0) or [B, T, S, A+1] (crf = 1) f32 log probs, root_gap [B, Wr]
// f32; lo, hi [B, T1], init_states, lengths [B] i32; scratch [B, stride] i32
// (stride >= ctc_duplex_exact_stride(N, K, A, W), contents ignored); outputs
// labels_rev [B, T1], count [B], err [B] (i32).  K*A <= 32.  All device
// memory allocated by the caller.  Returns the launch's cudaError_t.
int ctc_duplex_exact_launch(const float* l1, const float* l2, const float* root_gap,
                            const int* lo, const int* hi, const int* init_states,
                            const int* lengths, float thr, int B, int T1, int T2, int S,
                            int A, int K, int N, int W, int Wr, int needs_ext, int collapse,
                            int crf, int* scratch, long long stride, int* labels_rev,
                            int* count, int* err, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || A < 1 || K * A > kLanes || N < 1 || W < 1) return cudaErrorInvalidValue;
  if (stride < ctc_duplex_exact_stride(N, K, A, W)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (crf)
    return launch<true>(l1, l2, root_gap, lo, hi, init_states, lengths, thr, B, T1, T2, S, A,
                        K, N, W, Wr, needs_ext, 0, scratch, stride, labels_rev, count, err, st);
  return launch<false>(l1, l2, root_gap, lo, hi, init_states, lengths, thr, B, T1, T2, 1, A, K,
                       N, W, Wr, needs_ext, collapse, scratch, stride, labels_rev, count, err,
                       st);
}

}  // extern "C"
