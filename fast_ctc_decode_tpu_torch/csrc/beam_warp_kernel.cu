// Batched CTC prefix beam search, hash-identity form, one warp per read: the
// forward beam over all T steps, 1D and CRF.
//
// Replaces: fast_ctc_decode_tpu/ops/beam_pallas.py::_crf_beam_kernel (behind
// crf_beam_search_pallas_batch) in its CRF instances, and serves
// beam_pallas.py::_beam_kernel2 (behind beam_search_pallas_batch, version 2)
// in its 1D instances where a batch is too small to fill the card with one
// thread per read (ops/beam_cuda.py routes by B; beam_core.cuh is the other
// design).  It computes what the plain engines
// fast_ctc_decode_tpu_torch/ops/beam_fast.py::beam_search_ids_batch and
// ::crf_beam_search_ids_batch compute, bit for bit: the [T, K, B] log of
// entry-tip ids (read-minor), the final best id and the status of every
// read.  Node ids are coded as t*K*A + k*A + a (root -1, empty -2), so
// traceback_kernel.cu walks this log unchanged.
//
// Identity: parent hashes (beam_core.cuh's version 2), for CRF too.  Each
// tip carries its parent's hash pair and its last label; its own hash is
// mixed once a step; extension (k, a) lands on tip j iff own(k) == parent(j),
// a == last(j) and j is valid.  The TPU's CRF kernel carries own hashes and
// picks them in its rounds; the outputs are ids, which the identity does
// not change.
//
// What bounds it on this card: latency.  The first design (beam_core.cuh,
// one thread per read in blocks of 128) runs a step as one thread's long
// chain, and the CRF batch of B = 1024 gave it 8 blocks: 8 of 132 SMs did
// all the work, each tip's row load strided by T*S*(A+1)*4 bytes between
// threads.  Here each read has a warp and a block holds 1-8 reads
// (reads_per_block), so B = 1024 puts 1,024 warps over all SMs.  The design
// is exact_beam_kernel.cu's without the tree:
//  - tip j lives on lane j (lab, gap, parent hash, last label, state, id);
//    the K*A (tip, label) pairs lie over the lanes in the order of their
//    candidate ids t*K*A + k*A + a (<16, 7> takes four chunks of 32); a pair
//    lane takes its tip's data by shuffle and its label probability from
//    the lane holding that entry of the frame (1D, loaded a step ahead, one
//    entry a lane) or by its own load of the tip's state row (CRF);
//  - a pair lane finds the tips it lands on with one broadcast of each
//    tip's parent hash and label; a tip lane sums its arrivals over k in
//    candidate order from the pair lanes (k, last label), one shuffle each:
//    at most one of them is pushed unless two live tips' own hashes
//    collide, but the sum keeps the plain engine's terms all the same;
//  - selection ranks every candidate by the live candidates that beat it
//    (key descending, id ascending; the ids of valid candidates are
//    distinct, so ranks are a permutation) in one pass of broadcasts, and
//    the candidate of rank r < K fills slot r through the warp's shared
//    memory: the K rounds' order without K rounds.
// The id log is written by lanes 0..K-1, one scattered 4-byte store each a
// step; a frozen read (past its length or failed) writes its remaining
// steps with all 32 lanes.
//
// Bit-parity rules are beam_core.cuh's: __fmul_rn / __fadd_rn / __fdiv_rn
// and -fmad=false; labels pass the cut as !(p < thr), the blank as
// p0 > thr; NaN keys map to +inf and picks add +0.0; the raw total of slot
// 0 (NaN kept) is the divisor; INCOMPARABLE_VALUES needs a NaN among >= 2
// valid candidates; each CRF row entry gets +0.0 added; the CRF init state
// is (max, first argmax) with a NaN counting as the maximum.
//
// Four instances: <5, 4> and <16, 7>, each 1D and CRF.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;
constexpr uint32_t kMult1 = 0xC2B2AE35u, kAdd1 = 0x165667B1u;
constexpr uint32_t kMult2 = 0x27D4EB2Fu, kAdd2 = 0x9E3779B1u;
constexpr int kRoot = -1;
constexpr int kEmpty = -2;
constexpr int kRanOut = 1;  // errors.RAN_OUT_OF_BEAM
constexpr int kIncomparable = 2;  // errors.INCOMPARABLE_VALUES
constexpr int kWarp = 32;
constexpr int kMaxReadsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t x, uint32_t mult,
                                        uint32_t add) {
  uint32_t z = h ^ (x * mult + add);
  z = z * mult;
  return z ^ (z >> 16);
}

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

// probs: [B, T, A+1] (1D) or [B, T, S, A+1] (CRF) f32; init: [B, Si] f32
// (CRF only).  One warp per read, blockDim.x / 32 reads per block.
template <int KMAX, int AMAX, bool CRF>
__global__ void __launch_bounds__(kWarp * kMaxReadsPerBlock)
beam_warp_kernel(const float* __restrict__ probs, const float* __restrict__ init,
                 const int* __restrict__ lengths, float thr, int B, int T, int S,
                 int Si, int A, int K, int collapse, int* __restrict__ ids_log,
                 int* __restrict__ fin, int* __restrict__ err_out) {
  static_assert(KMAX <= kWarp, "one lane per tip");
  constexpr int NCH = (KMAX * AMAX + kWarp - 1) / kWarp;  // lane chunks of pairs
  constexpr int UJ = KMAX <= 8 ? KMAX : 1;  // the wide instance keeps its tip loops rolled
  // the next beam, slot by slot, as the ranked candidates write it
  __shared__ float s_lab[kMaxReadsPerBlock][KMAX], s_gap[kMaxReadsPerBlock][KMAX];
  __shared__ uint32_t s_h1[kMaxReadsPerBlock][KMAX], s_h2[kMaxReadsPerBlock][KMAX];
  __shared__ int s_id[kMaxReadsPerBlock][KMAX], s_ll[kMaxReadsPerBlock][KMAX];
  __shared__ int s_st[kMaxReadsPerBlock][KMAX];

  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const int b = blockIdx.x * (blockDim.x / kWarp) + w;
  if (b >= B) return;  // the whole warp
  const int A1 = A + 1;
  const int P = K * A;
  const int len = lengths[b];
  const float* row = probs + (size_t)b * (size_t)T * (size_t)S * (size_t)A1;

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
  int id = lane == 0 ? kRoot : kEmpty;
  int ll = -1;  // last label (-1: root, empty)
  uint32_t ph1 = 0u, ph2 = 0u;  // the parent's hash pair (unused for the root)
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
  int err = 0;
  // 1D: frame t's row, one entry per lane, loaded a step ahead
  float pr = (!CRF && lane < A1 && 0 < len && 0 < T) ? row[lane] : 0.f;

  int t = 0;
  for (; t < T; ++t) {
    if (lane < K) ids_log[((size_t)t * K + lane) * B + b] = id;
    if (t >= len || err != 0) break;  // frozen from here on (warp-uniform)
    const float pr_t = pr;
    if (!CRF) pr = (lane < A1 && t + 1 < len && t + 1 < T) ? row[(size_t)(t + 1) * A1 + lane] : 0.f;
    const float lg = __fadd_rn(lab, gap);
    const uint32_t oh1 = ll < 0 ? kSeed1 : mix(ph1, (uint32_t)ll, kMult1, kAdd1);
    const uint32_t oh2 = ll < 0 ? kSeed2 : mix(ph2, (uint32_t)ll, kMult2, kAdd2);
    // each tip's blank probability (CRF: from its own state's row, +0.0)
    float p0;
    if (CRF) {
      const int s = st < 0 ? 0 : (st > S - 1 ? S - 1 : st);
      p0 = valid ? __fadd_rn(row[((size_t)t * S + s) * A1], 0.f) : 0.f;
    } else {
      p0 = __shfl_sync(kFull, pr_t, 0);
    }

    // ---- pairs: tip data by shuffle, label probability, mass ----
    uint32_t kh1[NCH], kh2[NCH];
    int tst[NCH];
    float mext[NCH], pgap[NCH];
    bool pushed[NCH], rep[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int k = pk[c], a = pa[c];
      kh1[c] = __shfl_sync(kFull, oh1, k);
      kh2[c] = __shfl_sync(kFull, oh2, k);
      const int tl = __shfl_sync(kFull, ll, k);
      pgap[c] = __shfl_sync(kFull, gap, k);
      const float tlg = __shfl_sync(kFull, lg, k);
      const bool tv = __shfl_sync(kFull, (int)valid, k) != 0 && inq[c];
      tst[c] = CRF ? __shfl_sync(kFull, st, k) : 0;
      float pl = CRF ? 0.f : __shfl_sync(kFull, pr_t, 1 + a);
      if (CRF && tv) {
        const int s = tst[c] < 0 ? 0 : (tst[c] > S - 1 ? S - 1 : tst[c]);
        pl = __fadd_rn(row[((size_t)t * S + s) * A1 + 1 + a], 0.f);
      }
      pushed[c] = tv && !(pl < thr);
      rep[c] = !CRF && collapse && tl == a;
      mext[c] = __fmul_rn(rep[c] ? pgap[c] : tlg, pl);
    }

    // ---- which tips each pair lands on: own(k) == parent(j), a == last(j) ----
    unsigned hit[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) hit[c] = 0u;
#pragma unroll(UJ)
    for (int j = 0; j < KMAX; ++j) {
      if (j >= K) break;
      const uint32_t jh1 = __shfl_sync(kFull, ph1, j);
      const uint32_t jh2 = __shfl_sync(kFull, ph2, j);
      const int jl = __shfl_sync(kFull, valid ? ll : -2, j);  // -2: no label matches
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        if (inq[c] && jl == pa[c] && jh1 == kh1[c] && jh2 == kh2[c]) hit[c] |= 1u << j;
    }
    // pushed extensions; a collapsed repeat forks only with gap or onto a tip
    unsigned arr[NCH];  // hit mask of a pushed extension (0 when not pushed)
    bool vext[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const bool pu = pushed[c] && (!rep[c] || hit[c] != 0u || pgap[c] > 0.f);
      arr[c] = pu ? hit[c] : 0u;
      vext[c] = pu && hit[c] == 0u;
    }

    // ---- analytic merge on the tips: blank + stay + arrivals ----
    // tip j's arrivals are pairs (k, last(j)), summed in k order from 0.0
    float recv = 0.f;
    bool recv_any = false;
    const int my_a = ll < 0 ? 0 : ll;
#pragma unroll(UJ)
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) break;
      const int q = k * A + my_a;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const unsigned m = __shfl_sync(kFull, arr[c], q & (kWarp - 1));
        const float me = __shfl_sync(kFull, mext[c], q & (kWarp - 1));
        if (q / kWarp == c && ((m >> lane) & 1u)) {
          recv = __fadd_rn(recv, me);
          recv_any = true;
        }
      }
    }
    bool stay_push = false;
    float stay = 0.f;
    if (!CRF) {
      const float p_stay = __shfl_sync(kFull, pr_t, 1 + my_a);
      stay_push = collapse && valid && ll >= 0 && ll < A && !(p_stay < thr);
      stay = stay_push ? __fmul_rn(lab, p_stay) : 0.f;
    }
    const bool push_b = valid && (p0 > thr);
    const float tip_gap = push_b ? __fmul_rn(lg, p0) : 0.f;
    const float tip_lab = __fadd_rn(stay, recv);
    const bool tip_valid = lane < K && (push_b || stay_push || recv_any);

    // ---- keys, counts and NaN flag over K tips and K*A extensions ----
    const float tip_total = __fadd_rn(tip_lab, tip_gap);
    const float tip_key = cand_key(tip_valid, tip_total);
    int cnt = __popc(__ballot_sync(kFull, tip_valid));
    bool any_nan = __any_sync(kFull, tip_valid && isnan(tip_total));
    float ext_key[NCH];
    int cid[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float total = __fadd_rn(mext[c], 0.f);  // lab + gap with gap = 0
      ext_key[c] = cand_key(vext[c], total);
      cid[c] = t * P + c * kWarp + lane;
      cnt += __popc(__ballot_sync(kFull, vext[c]));
      any_nan = __any_sync(kFull, vext[c] && isnan(total)) || any_nan;
    }

    // ---- selection by rank: count the live candidates that beat each ----
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
        const int iy = __shfl_sync(kFull, id, src);
        tip_rank += beats(ky, iy, tip_key, id);
        ext_rank[0] += beats(ky, iy, ext_key[0], cid[0]);
      }
#pragma unroll
      for (int src = 0; src < KMAX * AMAX; ++src) {
        const float ky = __shfl_sync(kFull, ext_key[0], src);
        const int iy = __shfl_sync(kFull, cid[0], src);
        tip_rank += beats(ky, iy, tip_key, id);
        ext_rank[0] += beats(ky, iy, ext_key[0], cid[0]);
      }
    } else {
      // wide instance: only the live candidates, lowest lane first
      for (unsigned m = tip_m; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const float ky = __shfl_sync(kFull, tip_key, src);
        const int iy = __shfl_sync(kFull, id, src);
        tip_rank += beats(ky, iy, tip_key, id);
#pragma unroll
        for (int c = 0; c < NCH; ++c) ext_rank[c] += beats(ky, iy, ext_key[c], cid[c]);
      }
#pragma unroll
      for (int d = 0; d < NCH; ++d) {
        for (unsigned m = ext_m[d]; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          const float ky = __shfl_sync(kFull, ext_key[d], src);
          const int iy = __shfl_sync(kFull, cid[d], src);
          tip_rank += beats(ky, iy, tip_key, id);
#pragma unroll
          for (int c = 0; c < NCH; ++c) ext_rank[c] += beats(ky, iy, ext_key[c], cid[c]);
        }
      }
    }
    // the candidate of rank r < K fills slot r; picks add +0.0.  A tip keeps
    // its parent hash; a fresh (k, a) takes own(k) as its parent hash.
    if (tip_key > neg_inf() && tip_rank < K) {
      s_lab[w][tip_rank] = __fadd_rn(tip_lab, 0.f);
      s_gap[w][tip_rank] = __fadd_rn(tip_gap, 0.f);
      s_h1[w][tip_rank] = ph1;
      s_h2[w][tip_rank] = ph2;
      s_id[w][tip_rank] = id;
      s_ll[w][tip_rank] = ll;
      s_st[w][tip_rank] = st;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int r = ext_rank[c];
      if (ext_key[c] > neg_inf() && r < K) {
        s_lab[w][r] = __fadd_rn(mext[c], 0.f);
        s_gap[w][r] = __fadd_rn(0.f, 0.f);
        s_h1[w][r] = kh1[c];
        s_h2[w][r] = kh2[c];
        s_id[w][r] = cid[c];
        s_ll[w][r] = pa[c];
        s_st[w][r] = CRF ? (tst[c] * A) % S + pa[c] : 0;
      }
    }
    __syncwarp();
    const int n_fill = n_live < K ? n_live : K;
    // the raw total of rank 0, NaN kept
    const float top = n_fill > 0 ? __fadd_rn(s_lab[w][0], s_gap[w][0]) : 0.f;

    // ---- status, then the renormalised next beam (true division) ----
    if (cnt >= 2 && any_nan)
      err = kIncomparable;
    else if (cnt == 0)
      err = kRanOut;
    if (lane < n_fill) {
      lab = __fdiv_rn(s_lab[w][lane], top);
      gap = __fdiv_rn(s_gap[w][lane], top);
      ph1 = s_h1[w][lane];
      ph2 = s_h2[w][lane];
      id = s_id[w][lane];
      ll = s_ll[w][lane];
      st = s_st[w][lane];
      valid = true;
    } else {
      lab = 0.f;
      gap = 0.f;
      ph1 = 0u;
      ph2 = 0u;
      id = kEmpty;
      ll = -1;
      st = 0;
      valid = false;
    }
    __syncwarp();  // every lane has read its slot before the next step writes
  }

  // a frozen read logs the same entry ids for every remaining step
  if (lane < K) s_id[w][lane] = id;
  __syncwarp();
  const long long rest = (long long)(T - 1 - t) * K;
  for (long long i = lane; i < rest; i += kWarp) {
    const int tt = t + 1 + (int)(i / K), j = (int)(i % K);
    ids_log[((size_t)tt * K + j) * B + b] = s_id[w][j];
  }
  if (lane == 0) {
    fin[b] = id;
    err_out[b] = err;
  }
}

template <int KMAX, int AMAX, bool CRF>
cudaError_t launch(const float* probs, const float* init, const int* lengths,
                   float thr, int B, int T, int S, int Si, int A, int K, int collapse,
                   int* ids_log, int* fin, int* err, int rpb, cudaStream_t stream) {
  const dim3 grid((B + rpb - 1) / rpb);
  beam_warp_kernel<KMAX, AMAX, CRF><<<grid, kWarp * rpb, 0, stream>>>(
      probs, init, lengths, thr, B, T, S, Si, A, K, collapse, ids_log, fin, err);
  return cudaGetLastError();
}

template <int KMAX, int AMAX, bool CRF>
int blocks_per_sm(int rpb) {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, beam_warp_kernel<KMAX, AMAX, CRF>, kWarp * rpb, 0);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

}  // namespace

extern "C" {

// Launch the warp-per-read beam on `stream`, `reads_per_block` (1..8) reads
// a block.  probs [B, T, A+1] (crf = 0; S = Si = 1) or [B, T, S, A+1]
// (crf = 1) f32, init [B, Si] f32 (CRF only), lengths [B] i32; outputs
// ids_log [T, K, B], fin [B], err [B] (i32).  All device memory allocated
// by the caller.  Returns the launch's cudaError_t (0 = launched).
int ctc_beam_warp_launch(const float* probs, const float* init, const int* lengths,
                         float thr, int B, int T, int S, int Si, int A, int K,
                         int collapse, int crf, int* ids_log, int* fin, int* err,
                         int reads_per_block, void* stream) {
  if (B <= 0) return 0;
  if (reads_per_block < 1 || reads_per_block > kMaxReadsPerBlock) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpb = reads_per_block;
  if (K <= 5 && A <= 4) {
    if (crf)
      return launch<5, 4, true>(probs, init, lengths, thr, B, T, S, Si, A, K, 0, ids_log,
                                fin, err, rpb, s);
    return launch<5, 4, false>(probs, nullptr, lengths, thr, B, T, 1, 1, A, K, collapse,
                               ids_log, fin, err, rpb, s);
  }
  if (K <= 16 && A <= 7) {
    if (crf)
      return launch<16, 7, true>(probs, init, lengths, thr, B, T, S, Si, A, K, 0, ids_log,
                                 fin, err, rpb, s);
    return launch<16, 7, false>(probs, nullptr, lengths, thr, B, T, 1, 1, A, K, collapse,
                                ids_log, fin, err, rpb, s);
  }
  return cudaErrorInvalidValue;
}

// Blocks of `reads_per_block` warps that one SM holds at once, for the
// instance that (K, A, crf) launches (CUDA occupancy calculation); a
// negative value is minus the cudaError_t.
int ctc_beam_warp_blocks_per_sm(int K, int A, int crf, int reads_per_block) {
  if (K <= 5 && A <= 4)
    return crf ? blocks_per_sm<5, 4, true>(reads_per_block)
               : blocks_per_sm<5, 4, false>(reads_per_block);
  return crf ? blocks_per_sm<16, 7, true>(reads_per_block)
             : blocks_per_sm<16, 7, false>(reads_per_block);
}

}  // extern "C"
