// Batched exact CTC prefix beam search over a per-read suffix tree, 1D and CRF.
//
// Replaces: fast_ctc_decode_tpu/ops/beam_exact_pallas.py::_exact_beam_kernel,
// in both forms (crf=False behind beam_search_exact_pallas_batch, crf=True
// behind crf_beam_search_exact_pallas_batch).  It computes what the plain
// engines fast_ctc_decode_tpu_torch/ops/beam.py::beam_search_device_batch and
// ops/crf.py::crf_beam_search_device_batch compute, bit for bit: node ids
// allocated in the reference's add_node order (tip-major, labels
// ascending) with time = t, the analytic merge (blank + stay + one arrival;
// CRF: blank + one arrival), K rounds of (max total, tie -> min node id),
// true-division renormalisation, NODE_OVERFLOW past max_nodes, and the
// traceback of node 0's parent chain into labels/times leaf-first.
//
// Design: one thread per read, block 128.  The beam (K tips: node, state,
// lab, gap, valid) lives in per-thread arrays sized by the template bounds;
// the tree lives in global scratch, read-major, one slab per read:
//   parent [N] | label [N] | time [N] | child [(N+1)*A] (row node+1).
// N is the caller's max_nodes (by default the worst case T*K*A+8), so the
// tree never overflows unless the caller asks for fewer nodes, and node ids
// are plain int32: there is no packed beam word, no node cap and no re-run
// of overflowing reads on another engine, unlike the TPU kernel.
//
// The tables are never initialised (a memset would write the whole slab,
// 575 MB at B=1024, T=1000, on every call): a child lookup is accepted
// only if the id is below the read's node count and parent/label of that
// node name the tip and label looked up.  Children are unique per (parent,
// label), so a garbage entry can never pass.
//
// What bounds it on this card: latency.  Each step is one thread's serial
// sweep (K*A child lookups, each a dependent chain of three global loads,
// plus up to K*A allocations of four stores) followed by the register merge
// and selection.  The tree traffic is scattered and uncoalesced (each
// thread's slab is ~28*N bytes apart from its neighbour's), and the
// traceback is a chain of dependent loads.  The simple design accepts that;
// the beam itself stays in registers (the narrow instances) or spills (the
// wide ones).
//
// Bit-parity rules are beam_core.cuh's: __fmul_rn / __fadd_rn / __fdiv_rn,
// -fmad=false, NaN passes the label cut (!(p < thr)) and fails the blank
// cut (p0 > thr), NaN keys map to +inf, picks add +0.0, INCOMPARABLE_VALUES
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
constexpr int kRanOut = 1;  // errors.RAN_OUT_OF_BEAM
constexpr int kIncomparable = 2;  // errors.INCOMPARABLE_VALUES
constexpr int kOverflow = 4;  // errors.NODE_OVERFLOW
constexpr int kBlock = 128;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// probs: [B, T, A+1] (plain) or [B, T, S, A+1] (CRF); init: [B, Si] (CRF).
// scratch: [B, stride] i32 with stride >= 3*N + (N+1)*A.
template <int KMAX, int AMAX, bool CRF>
__global__ void __launch_bounds__(kBlock)
exact_beam_kernel(const float* __restrict__ probs, const float* __restrict__ init,
                  const int* __restrict__ lengths, float thr, int B, int T, int S,
                  int Si, int A, int K, int N, int collapse,
                  int* __restrict__ scratch, long long stride,
                  int* __restrict__ labels_rev, int* __restrict__ times_rev,
                  int* __restrict__ count_out, int* __restrict__ err_out) {
  constexpr int CMAX = KMAX + KMAX * AMAX;
  // Outer loops over K unroll only for the narrow instances (see
  // beam_core.cuh): the wide ones keep them rolled, in local memory.
  constexpr int UK = KMAX * CMAX <= 256 ? KMAX : 1;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int A1 = A + 1;
  const int len = lengths[b];
  const float* row = probs + (size_t)b * (size_t)T * (size_t)S * (size_t)A1;
  int* par = scratch + (size_t)b * (size_t)stride;
  int* lbl = par + N;
  int* tim = lbl + N;
  int* child = tim + N;

  // ---- beam state: the root alone in slot 0 ----
  float lab0 = 0.f, gap0 = 1.f;
  int st0 = 0;
  if (CRF) {
    // (max(init), init[0], argmax(init)): a NaN counts as the maximum and
    // the first maximum wins, as jnp.max / jnp.argmax (and torch) do
    const float* ini = init + (size_t)b * Si;
    lab0 = ini[0];
    gap0 = ini[0];
    bool nan_seen = isnan(lab0);
    for (int s = 1; s < Si && !nan_seen; ++s) {
      const float v = ini[s];
      if (isnan(v) || v > lab0) {
        lab0 = v;
        st0 = s;
        nan_seen = isnan(v);
      }
    }
  }
  int node[KMAX], st[KMAX];
  float lab[KMAX], gap[KMAX];
  bool valid[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    node[k] = k == 0 ? kRoot : kEmpty;
    st[k] = k == 0 ? st0 : 0;
    lab[k] = k == 0 ? lab0 : 0.f;
    gap[k] = k == 0 ? gap0 : 0.f;
    valid[k] = k == 0;
  }
  int n_nodes = 0;
  int err = 0;

  for (int t = 0; t < T; ++t) {
    if (t >= len || err != 0) break;  // frozen from here on

    // p[a] (plain: one row) or pk[k][a] (CRF: each tip's row)
    float p[AMAX + 1];
    float pk[KMAX][AMAX + 1];
#pragma unroll
    for (int a = 0; a <= AMAX; ++a)
      p[a] = (!CRF && a <= A) ? row[(size_t)t * A1 + a] : 0.f;
    if (CRF) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int s = st[k] < 0 ? 0 : (st[k] > S - 1 ? S - 1 : st[k]);
        const float* r = row + ((size_t)t * S + s) * A1;
#pragma unroll
        for (int a = 0; a <= AMAX; ++a) pk[k][a] = (k < K && a <= A) ? r[a] : 0.f;
      }
    }
#define P0(k) (CRF ? pk[(k)][0] : p[0])
#define PL(k, a) (CRF ? pk[(k)][1 + (a)] : p[1 + (a)])

    // the label of each tip's node (-1 for the root and empty slots)
    int tip_lbl[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) tip_lbl[k] = (k < K && node[k] >= 0) ? lbl[node[k]] : -1;

    // ---- sweep: child lookups and allocation in add_node order ----
    const int n0 = n_nodes;
    bool ovf = false;
    int cid[KMAX][AMAX];  // the (tip, label) child's node id, -1 = none
    bool push_lab[KMAX][AMAX];
#pragma unroll(UK)
    for (int k = 0; k < KMAX; ++k) {
#pragma unroll
      for (int a = 0; a < AMAX; ++a) {
        int c = -1;
        bool pushed = false;
        if (k < K && a < A && valid[k]) {
          const int n = node[k];
          pushed = !(PL(k, a) < thr);
          const int e = child[(size_t)(n + 1) * A + a];
          if (e >= 0 && e < n0 && par[e] == n && lbl[e] == a) c = e;
          const bool is_rep = !CRF && collapse && tip_lbl[k] == a;
          if (pushed && c < 0 && (!is_rep || gap[k] > 0.f)) {
            if (n_nodes < N) {
              par[n_nodes] = n;
              lbl[n_nodes] = a;
              tim[n_nodes] = t;
              child[(size_t)(n + 1) * A + a] = n_nodes;
              c = n_nodes++;
            } else {
              ovf = true;
            }
          }
        }
        cid[k][a] = c;
        push_lab[k][a] = pushed;
      }
    }

    // ---- candidate masses (fork of a repeat keeps gap; arrival lab+gap) ----
    float lg[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) lg[k] = __fadd_rn(lab[k], gap[k]);
    float mext[KMAX][AMAX];
    bool push_nid[KMAX][AMAX];
    bool matched[KMAX][AMAX];
#pragma unroll(UK)
    for (int k = 0; k < KMAX; ++k) {
#pragma unroll
      for (int a = 0; a < AMAX; ++a) {
        const bool is_rep = !CRF && collapse && tip_lbl[k] == a;
        mext[k][a] = (k < K && a < A) ? __fmul_rn(is_rep ? gap[k] : lg[k], PL(k, a)) : 0.f;
        push_nid[k][a] = push_lab[k][a] && cid[k][a] >= 0;
        bool m = false;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          m = m || (j < K && valid[j] && node[j] == cid[k][a]);
        matched[k][a] = push_nid[k][a] && m;
      }
    }

    // ---- analytic merge on the tips: blank + stay + one arrival ----
    float tip_lab[KMAX], tip_gap[KMAX];
    bool tip_valid[KMAX];
#pragma unroll(UK)
    for (int j = 0; j < KMAX; ++j) {
      float recv = 0.f;
      bool recv_any = false;
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
#pragma unroll
        for (int a = 0; a < AMAX; ++a)
          if (push_nid[k][a] && j < K && valid[j] && cid[k][a] == node[j]) {
            recv = __fadd_rn(recv, mext[k][a]);
            recv_any = true;
          }
      float stay = 0.f;
      bool push_stay = false;
      if (!CRF && collapse && j < K && tip_lbl[j] >= 0) {
        float p_stay = 0.f;
#pragma unroll
        for (int a = 0; a < AMAX; ++a)
          if (a == tip_lbl[j]) p_stay = p[1 + a];
        push_stay = valid[j] && !(p_stay < thr);
        stay = push_stay ? __fmul_rn(lab[j], p_stay) : 0.f;
      }
      const float p0 = j < K ? P0(j) : 0.f;
      const bool push_b = j < K && valid[j] && (p0 > thr);
      tip_gap[j] = push_b ? __fmul_rn(lg[j], p0) : 0.f;
      tip_lab[j] = __fadd_rn(stay, recv);
      tip_valid[j] = push_b || push_stay || recv_any;
    }
#undef P0
#undef PL

    // ---- candidate keys: K tips then K*A extensions ----
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
        const int k = (c - KMAX) / AMAX, a = (c - KMAX) % AMAX;
        v = push_nid[k][a] && !matched[k][a];
        total = __fadd_rn(mext[k][a], 0.f);  // lab + gap with gap = 0
      }
      cnt += v ? 1 : 0;
      any_nan = any_nan || (v && isnan(total));
      key[c] = v ? (isnan(total) ? pos_inf() : __fadd_rn(total, 0.f)) : neg_inf();
    }

    // ---- top-K: K rounds of (max key, tie -> min node id) ----
    float top = 0.f;
    float nlab[KMAX], ngap[KMAX];
    int nnode[KMAX], nst[KMAX];
    bool nvalid[KMAX];
#pragma unroll(UK)
    for (int r = 0; r < KMAX; ++r) {
      nlab[r] = 0.f;
      ngap[r] = 0.f;
      nnode[r] = kEmpty;
      nst[r] = 0;
      nvalid[r] = false;
      if (r >= K) continue;
      float mx = neg_inf();
      int best = -1, best_id = 0x7fffffff;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        const int id = c < KMAX ? node[c] : cid[(c - KMAX) / AMAX][(c - KMAX) % AMAX];
        if (key[c] > mx || (key[c] == mx && key[c] > neg_inf() && id < best_id)) {
          mx = key[c];
          best = c;
          best_id = id;
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
          nst[r] = st[c];
        } else {
          const int k = (c - KMAX) / AMAX, a = (c - KMAX) % AMAX;
          sel_lab = mext[k][a];
          nst[r] = CRF ? (st[k] * A) % S + a : 0;
        }
      }
      // the plain engine's picks add +0.0: canonical -0.0
      sel_lab = __fadd_rn(sel_lab, 0.f);
      sel_gap = __fadd_rn(sel_gap, 0.f);
      if (r == 0) top = __fadd_rn(sel_lab, sel_gap);  // raw total, NaN kept
      nlab[r] = sel_lab;
      ngap[r] = sel_gap;
      nnode[r] = best_id;
      nvalid[r] = true;
    }

    // ---- status (overflow > NaN > empty), then the renormalised beam ----
    if (ovf)
      err = kOverflow;
    else if (cnt >= 2 && any_nan)
      err = kIncomparable;
    else if (cnt == 0)
      err = kRanOut;
#pragma unroll
    for (int r = 0; r < KMAX; ++r) {
      lab[r] = nvalid[r] ? __fdiv_rn(nlab[r], top) : 0.f;
      gap[r] = nvalid[r] ? __fdiv_rn(ngap[r], top) : 0.f;
      node[r] = nnode[r];
      st[r] = nst[r];
      valid[r] = nvalid[r];
    }
  }

  // ---- traceback: node 0's parent chain, leaf first, -1 padded ----
  int* lab_row = labels_rev + (size_t)b * T;
  int* t_row = times_rev + (size_t)b * T;
  int cur = node[0];
  int n = 0;
  while (cur >= 0 && n < T) {
    lab_row[n] = lbl[cur];
    t_row[n] = tim[cur];
    cur = par[cur];
    ++n;
  }
  count_out[b] = n;
  err_out[b] = err;
  for (int i = n; i < T; ++i) {
    lab_row[i] = -1;
    t_row[i] = -1;
  }
}

template <int KMAX, int AMAX, bool CRF>
cudaError_t launch(const float* probs, const float* init, const int* lengths,
                   float thr, int B, int T, int S, int Si, int A, int K, int N,
                   int collapse, int* scratch, long long stride, int* labels_rev,
                   int* times_rev, int* count, int* err, cudaStream_t stream) {
  const dim3 grid((B + kBlock - 1) / kBlock);
  exact_beam_kernel<KMAX, AMAX, CRF><<<grid, kBlock, 0, stream>>>(
      probs, init, lengths, thr, B, T, S, Si, A, K, N, collapse, scratch, stride,
      labels_rev, times_rev, count, err);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the exact beam on `stream`.  probs [B, T, A+1] (crf = 0) or
// [B, T, S, A+1] (crf = 1) f32, init [B, Si] f32 (CRF only), lengths [B];
// scratch [B, stride] i32 (stride >= 3*N + (N+1)*A, contents ignored);
// outputs labels_rev [B, T], times_rev [B, T], count [B], err [B] (i32).
// All device memory allocated by the caller.  Returns the launch's
// cudaError_t (0 = launched).
int ctc_exact_beam_launch(const float* probs, const float* init,
                          const int* lengths, float thr, int B, int T, int S,
                          int Si, int A, int K, int N, int collapse, int crf,
                          int* scratch, long long stride, int* labels_rev,
                          int* times_rev, int* count, int* err, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 5 && A <= 4) {
    if (crf)
      return launch<5, 4, true>(probs, init, lengths, thr, B, T, S, Si, A, K, N, 0,
                                scratch, stride, labels_rev, times_rev, count, err, s);
    return launch<5, 4, false>(probs, init, lengths, thr, B, T, 1, 1, A, K, N,
                               collapse, scratch, stride, labels_rev, times_rev,
                               count, err, s);
  }
  if (K <= 16 && A <= 7) {
    if (crf)
      return launch<16, 7, true>(probs, init, lengths, thr, B, T, S, Si, A, K, N, 0,
                                 scratch, stride, labels_rev, times_rev, count, err, s);
    return launch<16, 7, false>(probs, init, lengths, thr, B, T, 1, 1, A, K, N,
                                collapse, scratch, stride, labels_rev, times_rev,
                                count, err, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
