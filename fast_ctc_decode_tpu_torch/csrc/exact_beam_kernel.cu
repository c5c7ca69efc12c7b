// Batched exact CTC prefix beam search over a per-read suffix tree, 1D and CRF.
//
// Replaces: fast_ctc_decode_tpu/ops/beam_exact_pallas.py::_exact_beam_kernel,
// in both forms (crf=False behind beam_search_exact_pallas_batch, crf=True
// behind crf_beam_search_exact_pallas_batch).  It computes what the plain
// engines fast_ctc_decode_tpu_torch/ops/beam.py::beam_search_device_batch and
// ops/crf.py::crf_beam_search_device_batch compute, bit for bit: node ids
// allocated in the reference's add_node order (tip-major, labels
// ascending) with time = t, the analytic merge (blank + stay + one arrival;
// CRF: blank + one arrival), the top K by (max total, tie -> min node id),
// true-division renormalisation, NODE_OVERFLOW past max_nodes, and the
// traceback of node 0's parent chain into labels/times leaf-first.
//
// The tree lives in global scratch, read-major, one slab per read:
//   rec [N] int4 (parent, label, time, 0) | child [(N+1)*A] int32 (row node+1)
// N is the caller's max_nodes (by default the worst case T*K*A+8), so the
// tree never overflows unless the caller asks for fewer nodes, and node ids
// are plain int32.  The tables are never initialised (a memset would write
// the whole slab on every call): a child lookup is accepted only if the id
// is below the read's node count and the record of that node names the tip
// and label looked up.  Children are unique per (parent, label) and every
// record below the count is a real node, so a garbage entry never passes.
//
// What bounds it on this card: latency, not bytes.  A step is a chain of
// dependent global loads (child entry, then the node record) and of the
// warp's collectives (shuffles, ballots), T steps one after another per
// read; at B <= 1024 a few warps per SM cannot hide that.  The first design
// (one thread per read, blocks of 128) ran each step as one thread's serial
// sweep over K*A lookups and K rounds of selection over K + K*A keys, on 8
// of 132 SMs at B = 1024.  This one gives each read a warp and several reads
// a block (reads_per_block, 1..8), so B = 1024 fills every SM:
//  - the K*A (tip, label) pairs lie over the lanes in add_node order
//    (tip-major, labels ascending; <16, 7> takes four chunks of 32), so the
//    lookups of a step are issued together: two dependent loads deep.  Every
//    lookup reads the tree as it was before the step (tips are distinct
//    nodes and a (parent, label) has one child, so no lookup can need a node
//    of the same step), then new nodes are numbered by a lane-ordered prefix
//    count (ballot + popc, carried across chunks): the plain engine's cumsum;
//  - each tip carries its node's label and parent in registers, so the stay
//    mass needs no load and a tip finds the slot of its parent with one
//    broadcast per tip; its one possible arrival (a node has one parent and
//    one label) is then one shuffle from the lane of that pair;
//  - a node's parent, label and time are one int4: a lookup's check is one
//    16-byte load, and so is a traceback hop;
//  - selection ranks every candidate by the valid candidates that beat it
//    (key descending, id ascending; ids of valid candidates are distinct,
//    so ranks are a permutation) in one pass of broadcasts over the valid
//    candidates, and the candidate of rank r < K fills slot r through the
//    warp's shared memory: the K rounds' order without K rounds;
//  - 1D frames are loaded one step ahead, one entry per lane; CRF rows are
//    loaded by the lanes beside the child lookups;
//  - the traceback is walked by the whole warp (one load per hop, broadcast)
//    and written in coalesced rows of 32, the -1 padding by all lanes.
//
// Bit-parity rules are beam_core.cuh's: __fmul_rn / __fadd_rn / __fdiv_rn,
// -fmad=false, NaN passes the label cut (!(p < thr)) and fails the blank
// cut (p0 > thr), NaN keys map to +inf, picks add +0.0, an arrival is added
// to 0.0 first (as the plain engine's sum over arrivals), INCOMPARABLE_VALUES
// needs a NaN among >= 2 valid candidates, and within a step the status
// priority is overflow > NaN > empty beam.  The CRF row probs[b, t, s, :] is
// a plain indexed load, as the plain engine's gather is.
//
// Four instances: <5, 4> and <16, 7>, each plain and CRF.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRoot = -1;
constexpr int kEmpty = -2;
constexpr int kNoParent = -3;  // parent of the root and of empty slots: no node's id
constexpr int kRanOut = 1;  // errors.RAN_OUT_OF_BEAM
constexpr int kIncomparable = 2;  // errors.INCOMPARABLE_VALUES
constexpr int kOverflow = 4;  // errors.NODE_OVERFLOW
constexpr int kWarp = 32;
constexpr int kMaxReadsPerBlock = 8;
constexpr int kRecWords = 4;  // int32 words of one node record (int4)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Selection order: (key descending, id ascending).
__device__ __forceinline__ bool beats(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// The key of a candidate: -inf when invalid, +inf for a NaN total, else the
// total plus +0.0 (canonical -0.0).
__device__ __forceinline__ float cand_key(bool v, float total) {
  return v ? (isnan(total) ? pos_inf() : __fadd_rn(total, 0.f)) : neg_inf();
}

// probs: [B, T, A+1] (plain) or [B, T, S, A+1] (CRF); init: [B, Si] (CRF).
// scratch: [B, stride] i32, stride a multiple of 4 and >= 4*N + (N+1)*A.
// One warp per read, blockDim.x / 32 reads per block.
template <int KMAX, int AMAX, bool CRF>
__global__ void __launch_bounds__(kWarp * kMaxReadsPerBlock)
exact_beam_kernel(const float* __restrict__ probs, const float* __restrict__ init,
                  const int* __restrict__ lengths, float thr, int B, int T, int S,
                  int Si, int A, int K, int N, int collapse,
                  int* __restrict__ scratch, long long stride,
                  int* __restrict__ labels_rev, int* __restrict__ times_rev,
                  int* __restrict__ count_out, int* __restrict__ err_out) {
  constexpr int NCH = (KMAX * AMAX + kWarp - 1) / kWarp;  // lane chunks of pairs
  constexpr int UJ = KMAX <= 8 ? KMAX : 1;  // the wide instance keeps its tip loop rolled
  // the next beam, slot by slot, as the ranked candidates write it
  __shared__ float s_lab[kMaxReadsPerBlock][KMAX], s_gap[kMaxReadsPerBlock][KMAX];
  __shared__ int s_node[kMaxReadsPerBlock][KMAX], s_lbl[kMaxReadsPerBlock][KMAX];
  __shared__ int s_par[kMaxReadsPerBlock][KMAX], s_st[kMaxReadsPerBlock][KMAX];

  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const int b = blockIdx.x * (blockDim.x / kWarp) + w;
  if (b >= B) return;  // the whole warp
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  const int A1 = A + 1;
  const int P = K * A;
  const int len = lengths[b];
  const float* row = probs + (size_t)b * (size_t)T * (size_t)S * (size_t)A1;
  int* slab = scratch + (size_t)b * (size_t)stride;
  int4* rec = reinterpret_cast<int4*>(slab);
  int* child = slab + (size_t)kRecWords * (size_t)N;

  // this lane's pairs: pair q = c*32 + lane is (tip q / A, label q % A)
  int pk[NCH], pa[NCH];
  bool inq[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int q = c * kWarp + lane;
    inq[c] = q < P;
    pk[c] = inq[c] ? q / A : 0;
    pa[c] = inq[c] ? q % A : 0;
  }

  // ---- beam state: tip `lane` (lanes >= K stay empty); the root in slot 0 ----
  int node = lane == 0 ? kRoot : kEmpty;
  int lbl = -1;  // the label of the tip's node (-1: root, empty)
  int par = kNoParent;  // the parent of the tip's node
  int st = 0;
  float lab = 0.f, gap = lane == 0 ? 1.f : 0.f;
  bool valid = lane == 0;
  if (CRF && lane == 0) {
    // (max(init), init[0], argmax(init)): a NaN counts as the maximum and
    // the first maximum wins, as jnp.max / jnp.argmax (and torch) do
    const float* ini = init + (size_t)b * Si;
    lab = ini[0];
    gap = ini[0];
    bool nan_seen = isnan(lab);
    for (int s = 1; s < Si && !nan_seen; ++s) {
      const float v = ini[s];
      if (isnan(v) || v > lab) {
        lab = v;
        st = s;
        nan_seen = isnan(v);
      }
    }
  }
  int n_nodes = 0;
  int err = 0;
  // 1D: frame t's row, one entry per lane, loaded a step ahead
  float pr = (!CRF && lane < A1 && 0 < len && 0 < T) ? row[lane] : 0.f;

  for (int t = 0; t < T; ++t) {
    if (t >= len || err != 0) break;  // frozen from here on (warp-uniform)
    const float pr_t = pr;
    if (!CRF) pr = (lane < A1 && t + 1 < len && t + 1 < T) ? row[(size_t)(t + 1) * A1 + lane] : 0.f;
    const float lg = __fadd_rn(lab, gap);
    // each tip's blank probability (CRF: its own row, loaded beside the lookups)
    float p0;
    if (CRF) {
      const int s = st < 0 ? 0 : (st > S - 1 ? S - 1 : st);
      p0 = valid ? row[((size_t)t * S + s) * A1] : 0.f;
    } else {
      p0 = __shfl_sync(kFull, pr_t, 0);
    }

    // ---- pairs: tip data by shuffle, label probability, child lookup ----
    const int n0 = n_nodes;
    int tn[NCH], tst[NCH], cid[NCH];
    float mext[NCH];
    bool pushed[NCH], need[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int k = pk[c], a = pa[c];
      tn[c] = __shfl_sync(kFull, node, k);
      const int tl = __shfl_sync(kFull, lbl, k);
      const float tg = __shfl_sync(kFull, gap, k);
      const float tlg = __shfl_sync(kFull, lg, k);
      const bool tv = __shfl_sync(kFull, (int)valid, k) != 0 && inq[c];
      tst[c] = CRF ? __shfl_sync(kFull, st, k) : 0;
      float pl = CRF ? 0.f : __shfl_sync(kFull, pr_t, 1 + a);
      if (CRF && tv) {
        const int s = tst[c] < 0 ? 0 : (tst[c] > S - 1 ? S - 1 : tst[c]);
        pl = row[((size_t)t * S + s) * A1 + 1 + a];
      }
      int e = -1;
      if (tv) e = child[(size_t)(tn[c] + 1) * A + a];
      int found = -1;
      if (tv && e >= 0 && e < n0) {
        const int4 r = rec[e];
        if (r.x == tn[c] && r.y == a) found = e;
      }
      cid[c] = found;
      pushed[c] = tv && !(pl < thr);
      const bool is_rep = !CRF && collapse && tl == a;
      need[c] = pushed[c] && found < 0 && (!is_rep || tg > 0.f);
      mext[c] = inq[c] ? __fmul_rn(is_rep ? tg : tlg, pl) : 0.f;
    }

    // ---- allocation: lane-ordered prefix count, carried across chunks ----
    long long next = n0;
    bool ovf_lane = false;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const unsigned m = __ballot_sync(kFull, need[c]);
      if (need[c]) {
        const long long id = next + __popc(m & lower);
        if (id < N) {
          rec[id] = make_int4(tn[c], pa[c], t, 0);
          child[(size_t)(tn[c] + 1) * A + pa[c]] = (int)id;
          cid[c] = (int)id;
        } else {
          ovf_lane = true;
        }
      }
      next += __popc(m);
    }
    n_nodes = next < N ? (int)next : N;
    const bool ovf = __any_sync(kFull, ovf_lane);
    __syncwarp();  // the new nodes are seen by every lane from the next step on

    // ---- which extensions land on a tip, and each tip's parent slot ----
    bool matched[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) matched[c] = false;
    int pslot = -1;
#pragma unroll(UJ)
    for (int j = 0; j < KMAX; ++j) {
      if (j >= K) break;
      const int nj = __shfl_sync(kFull, node, j);  // kEmpty for empty slots
#pragma unroll
      for (int c = 0; c < NCH; ++c) matched[c] = matched[c] || (cid[c] >= 0 && cid[c] == nj);
      if (par == nj) pslot = j;
    }
    bool vext[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) vext[c] = pushed[c] && cid[c] >= 0 && !matched[c];

    // ---- analytic merge on the tips: blank + stay + one arrival ----
    const int qa = pslot >= 0 ? pslot * A + lbl : 0;  // the pair that may arrive here
    float recv = 0.f;
    bool recv_any = false;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float m = __shfl_sync(kFull, mext[c], qa & (kWarp - 1));
      const int ci = __shfl_sync(kFull, cid[c], qa & (kWarp - 1));
      const bool pu = __shfl_sync(kFull, (int)pushed[c], qa & (kWarp - 1)) != 0;
      if (pslot >= 0 && qa / kWarp == c && pu && ci == node) {
        recv = __fadd_rn(0.f, m);
        recv_any = true;
      }
    }
    const float p_stay = CRF ? 0.f : __shfl_sync(kFull, pr_t, 1 + (lbl < 0 ? 0 : lbl));
    bool push_stay = false;
    float stay = 0.f;
    if (!CRF && collapse && lbl >= 0) {
      push_stay = valid && !(p_stay < thr);
      stay = push_stay ? __fmul_rn(lab, p_stay) : 0.f;
    }
    const bool push_b = valid && (p0 > thr);
    const float tip_gap = push_b ? __fmul_rn(lg, p0) : 0.f;
    const float tip_lab = __fadd_rn(stay, recv);
    const bool tip_valid = push_b || push_stay || recv_any;

    // ---- keys, counts and NaN flag over K tips and K*A extensions ----
    const float tip_total = __fadd_rn(tip_lab, tip_gap);
    const float tip_key = cand_key(tip_valid, tip_total);
    int cnt = __popc(__ballot_sync(kFull, tip_valid));
    bool any_nan = __any_sync(kFull, tip_valid && isnan(tip_total));
    float ext_key[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float total = __fadd_rn(mext[c], 0.f);  // lab + gap with gap = 0
      ext_key[c] = cand_key(vext[c], total);
      cnt += __popc(__ballot_sync(kFull, vext[c]));
      any_nan = __any_sync(kFull, vext[c] && isnan(total)) || any_nan;
    }

    // ---- selection by rank: count the valid candidates that beat each ----
    const unsigned tip_m = __ballot_sync(kFull, tip_key > neg_inf());
    unsigned ext_m[NCH];
    int n_live = __popc(tip_m);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      ext_m[c] = __ballot_sync(kFull, ext_key[c] > neg_inf());
      n_live += __popc(ext_m[c]);
    }
    int tip_rank = 0;
    int ext_rank[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) ext_rank[c] = 0;
    if constexpr (NCH == 1) {
      // narrow instance: every candidate lane, unrolled, so the broadcasts
      // issue back to back (a -inf key beats no live candidate)
#pragma unroll
      for (int src = 0; src < KMAX; ++src) {
        const float ky = __shfl_sync(kFull, tip_key, src);
        const int iy = __shfl_sync(kFull, node, src);
        tip_rank += beats(ky, iy, tip_key, node);
        ext_rank[0] += beats(ky, iy, ext_key[0], cid[0]);
      }
#pragma unroll
      for (int src = 0; src < KMAX * AMAX; ++src) {
        const float ky = __shfl_sync(kFull, ext_key[0], src);
        const int iy = __shfl_sync(kFull, cid[0], src);
        tip_rank += beats(ky, iy, tip_key, node);
        ext_rank[0] += beats(ky, iy, ext_key[0], cid[0]);
      }
    } else {
      // wide instance: only the live candidates, lowest lane first
      for (unsigned m = tip_m; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const float ky = __shfl_sync(kFull, tip_key, src);
        const int iy = __shfl_sync(kFull, node, src);
        tip_rank += beats(ky, iy, tip_key, node);
#pragma unroll
        for (int c = 0; c < NCH; ++c) ext_rank[c] += beats(ky, iy, ext_key[c], cid[c]);
      }
#pragma unroll
      for (int d = 0; d < NCH; ++d) {
        for (unsigned m = ext_m[d]; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          const float ky = __shfl_sync(kFull, ext_key[d], src);
          const int iy = __shfl_sync(kFull, cid[d], src);
          tip_rank += beats(ky, iy, tip_key, node);
#pragma unroll
          for (int c = 0; c < NCH; ++c) ext_rank[c] += beats(ky, iy, ext_key[c], cid[c]);
        }
      }
    }
    // the candidate of rank r < K fills slot r; picks add +0.0
    if (tip_key > neg_inf() && tip_rank < K) {
      s_lab[w][tip_rank] = __fadd_rn(tip_lab, 0.f);
      s_gap[w][tip_rank] = __fadd_rn(tip_gap, 0.f);
      s_node[w][tip_rank] = node;
      s_lbl[w][tip_rank] = lbl;
      s_par[w][tip_rank] = par;
      s_st[w][tip_rank] = st;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int r = ext_rank[c];
      if (ext_key[c] > neg_inf() && r < K) {
        s_lab[w][r] = __fadd_rn(mext[c], 0.f);
        s_gap[w][r] = __fadd_rn(0.f, 0.f);
        s_node[w][r] = cid[c];
        s_lbl[w][r] = pa[c];
        s_par[w][r] = tn[c];
        s_st[w][r] = CRF ? (tst[c] * A) % S + pa[c] : 0;
      }
    }
    __syncwarp();
    const int n_fill = n_live < K ? n_live : K;
    // the raw total of rank 0, NaN kept
    const float top = n_fill > 0 ? __fadd_rn(s_lab[w][0], s_gap[w][0]) : 0.f;

    // ---- status (overflow > NaN > empty), then the renormalised beam ----
    if (ovf)
      err = kOverflow;
    else if (cnt >= 2 && any_nan)
      err = kIncomparable;
    else if (cnt == 0)
      err = kRanOut;
    if (lane < n_fill) {
      lab = __fdiv_rn(s_lab[w][lane], top);
      gap = __fdiv_rn(s_gap[w][lane], top);
      node = s_node[w][lane];
      lbl = s_lbl[w][lane];
      par = s_par[w][lane];
      st = s_st[w][lane];
      valid = true;
    } else {
      lab = 0.f;
      gap = 0.f;
      node = kEmpty;
      lbl = -1;
      par = kNoParent;
      st = 0;
      valid = false;
    }
    __syncwarp();  // every lane has read its slot before the next step writes
  }

  // ---- traceback: node 0's parent chain, leaf first, -1 padded ----
  // The warp walks the chain together (one broadcast load a hop); lane i
  // keeps hop i of each run of 32, and the warp writes the run as one row.
  int* lab_row = labels_rev + (size_t)b * T;
  int* t_row = times_rev + (size_t)b * T;
  int cur = __shfl_sync(kFull, node, 0);
  int n = 0;
  int my_l = -1, my_t = -1;
  while (cur >= 0 && n < T) {
    const int4 r = rec[cur];
    if ((n & (kWarp - 1)) == lane) {
      my_l = r.y;
      my_t = r.z;
    }
    cur = r.x;
    ++n;
    if ((n & (kWarp - 1)) == 0) {
      lab_row[n - kWarp + lane] = my_l;
      t_row[n - kWarp + lane] = my_t;
    }
  }
  const int done = n & ~(kWarp - 1);
  if (lane < n - done) {
    lab_row[done + lane] = my_l;
    t_row[done + lane] = my_t;
  }
  for (int i = n + lane; i < T; i += kWarp) {
    lab_row[i] = -1;
    t_row[i] = -1;
  }
  if (lane == 0) {
    count_out[b] = n;
    err_out[b] = err;
  }
}

template <int KMAX, int AMAX, bool CRF>
cudaError_t launch(const float* probs, const float* init, const int* lengths,
                   float thr, int B, int T, int S, int Si, int A, int K, int N,
                   int collapse, int* scratch, long long stride, int* labels_rev,
                   int* times_rev, int* count, int* err, int rpb, cudaStream_t stream) {
  const dim3 grid((B + rpb - 1) / rpb);
  exact_beam_kernel<KMAX, AMAX, CRF><<<grid, kWarp * rpb, 0, stream>>>(
      probs, init, lengths, thr, B, T, S, Si, A, K, N, collapse, scratch, stride,
      labels_rev, times_rev, count, err);
  return cudaGetLastError();
}

template <int KMAX, int AMAX, bool CRF>
int blocks_per_sm(int rpb) {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, exact_beam_kernel<KMAX, AMAX, CRF>, kWarp * rpb, 0);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

}  // namespace

extern "C" {

// Launch the exact beam on `stream`: one warp per read, `reads_per_block`
// (1..8) reads a block.  probs [B, T, A+1] (crf = 0) or [B, T, S, A+1]
// (crf = 1) f32, init [B, Si] f32 (CRF only), lengths [B]; scratch [B,
// stride] i32 (16-byte aligned, stride a multiple of 4 and >= 4*N +
// (N+1)*A, contents ignored); outputs labels_rev [B, T], times_rev [B, T],
// count [B], err [B] (i32).  All device memory allocated by the caller.
// Returns the launch's cudaError_t (0 = launched).
int ctc_exact_beam_launch(const float* probs, const float* init,
                          const int* lengths, float thr, int B, int T, int S,
                          int Si, int A, int K, int N, int collapse, int crf,
                          int* scratch, long long stride, int* labels_rev,
                          int* times_rev, int* count, int* err, int reads_per_block,
                          void* stream) {
  if (B <= 0) return 0;
  if (reads_per_block < 1 || reads_per_block > kMaxReadsPerBlock || stride % kRecWords != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % (kRecWords * sizeof(int)) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpb = reads_per_block;
  if (K <= 5 && A <= 4) {
    if (crf)
      return launch<5, 4, true>(probs, init, lengths, thr, B, T, S, Si, A, K, N, 0,
                                scratch, stride, labels_rev, times_rev, count, err, rpb, s);
    return launch<5, 4, false>(probs, init, lengths, thr, B, T, 1, 1, A, K, N,
                               collapse, scratch, stride, labels_rev, times_rev,
                               count, err, rpb, s);
  }
  if (K <= 16 && A <= 7) {
    if (crf)
      return launch<16, 7, true>(probs, init, lengths, thr, B, T, S, Si, A, K, N, 0,
                                 scratch, stride, labels_rev, times_rev, count, err, rpb, s);
    return launch<16, 7, false>(probs, init, lengths, thr, B, T, 1, 1, A, K, N,
                                collapse, scratch, stride, labels_rev, times_rev,
                                count, err, rpb, s);
  }
  return cudaErrorInvalidValue;
}

// Blocks of `reads_per_block` warps that one SM holds at once, for the
// instance that (K, A, crf) launches (CUDA occupancy calculation); a
// negative value is minus the cudaError_t.
int ctc_exact_beam_blocks_per_sm(int K, int A, int crf, int reads_per_block) {
  if (K <= 5 && A <= 4)
    return crf ? blocks_per_sm<5, 4, true>(reads_per_block)
               : blocks_per_sm<5, 4, false>(reads_per_block);
  return crf ? blocks_per_sm<16, 7, true>(reads_per_block)
             : blocks_per_sm<16, 7, false>(reads_per_block);
}

}  // extern "C"
