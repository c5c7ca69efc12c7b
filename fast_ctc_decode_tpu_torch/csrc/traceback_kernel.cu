// Batched traceback of the beam's id log into leaf-first labels and times.
//
// Replaces: fast_ctc_decode_tpu/ops/beam_pallas.py::_traceback_kernel (the
// backward id-log sweep that packs (no-emit, step, label+1) keys) together
// with the key sort that follows it (beam_fast._sort_unpack_keys).  Output
// equals the plain engine's sorted-key form, and its 3-operand stable-sort
// fallback, exactly: labels_rev[b, n] / times_rev[b, n] hold the emits
// leaf-first, the rest of each row is -1, and count[b] is the number of
// emits.
//
// A node id is t*K*A + k*A + a: the node was created at step t in slot k
// with label a, and its parent is the entry id of slot k at step t,
// ids_log[t, k, b].  A parent is always created at a strictly earlier step;
// a walk stops at the root (-1), an empty slot (-2), or a step that does not
// decrease, which is what the plain sweep does on any log.
//
// What bounds it on this card: the bytes.  The log is [T, K, B] i32 with the
// reads innermost, so the K*T entries of one read lie B*4 bytes apart, and
// each of the two [B, T] output planes is written once.  A gather moves at
// least a 32-byte sector, so no design reaches the 4 bytes an emitted node
// that the row's bound counts; the sweep's own floor is one read of the log
// and one write of the planes (917 MB, 0.27 ms at B=32768, T=1000, K=5 at
// 3.35 TB/s).
//
// Design: one warp owns 32 consecutive reads, one lane each; the warps of a
// block share nothing (no block barrier).  Two routes, one function:
//  - sweep (the default): the warp streams the log backward through its own
//    ring of kRing tiles in dynamic shared memory, from the largest step of
//    its reads' final ids down to 0.  A tile is `steps` steps of the K rows
//    of its 32 reads: steps*K runs of 128 contiguous bytes, each lane
//    copying its own read's column with cp.async (`cuda_pipeline.h`), so a
//    warp's copy is one coalesced 128-byte request and each lane reads only
//    what it copied itself.  Inside a tile each lane walks from node to
//    parent in shared memory: the plain sweep's hits, in its order.  Lanes
//    whose walk has ended copy nothing more, and the warp stops when all
//    have ended.
//  - walk: each lane walks from node to parent in global memory, one
//    dependent gather a node (the first design's walk).  It needs no tile,
//    so it takes the K whose one-step ring does not fit.
// A walk's step tests compare ids with the step's first id (t*K*A) instead
// of dividing, and the one division left on the chain from a parent load to
// the next is a multiply and two shifts (Divisor).  Both routes stage each
// lane's emits in shared memory, in a ring of two 32-entry chunks, and write
// a row only in chunks cut at 128-byte boundaries of memory, each chunk
// once, the warp's lanes over its entries: a chunk goes out once it lies
// below the lane's emits, or past the most emits the lane can still add (a
// lane whose walk is at step t adds at most t), where it holds -1.  So the
// -1 tail goes out while the sweep still streams, and no store writes part
// of a sector that another store completes later: on the H100, rows written
// in runs that straddle sectors, 32 rows in turn, took several times as long
// as the same rows in aligned chunks.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;  // entries of one store: 128 aligned bytes of a row; most steps a tile
constexpr int kStageRow = 2 * kChunk + 1;  // a lane's ring of two chunks, padded across banks
constexpr int kRing = 4;  // tiles of the sweep a warp holds: one walked, three in flight
constexpr int kMaxWarps = 8;  // warps (32 reads each) a block
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a block may opt in to

// Division of a non-negative int by a divisor d >= 1 fixed for the whole
// kernel, as a multiply and two shifts (Granlund and Montgomery 1994, fig.
// 4.1 with N = 32): exact for every n < 2^32, where the compiler's division
// by a runtime int is a chain of ~20 instructions.
struct Divisor {
  unsigned m;
  int s1, s2;
  __device__ explicit Divisor(unsigned d) {
    const int l = 32 - __clz(d - 1);  // ceil(log2 d)
    m = (unsigned)(((((unsigned long long)1 << l) - d) << 32) / d + 1);
    s1 = min(l, 1);
    s2 = max(l - 1, 0);
  }
  __device__ __forceinline__ int div(int n) const {
    const unsigned t1 = __umulhi(m, (unsigned)n);
    return (int)((t1 + (((unsigned)n - t1) >> s1)) >> s2);
  }
};

// The node id coding, id = t*K*A + k*A + a: id / A = t*K + k is the node's
// row of the log, id / (K*A) its step t, id % A its label.
struct Ids {
  int KA, A;
  Divisor by_ka, by_a;
  __device__ Ids(int K, int A_) : KA(K * A_), A(A_), by_ka(K * A_), by_a(A_) {}
};

// Staged emits of one warp, [32][kStageRow] node ids.  A lane's row is cut
// into chunks at 128-byte boundaries of memory: its position p lies in chunk
// (p + o) / 32, and is staged in slot (p + o) % 64 of the lane's ring, where
// o = (b*T) % 32 places the row's start.
struct Stage {
  int* buf;
  int o;  // the row's first position lies o words past a 128-byte boundary
  int end;  // this lane's emits so far: positions [0, end)
  int done;  // its chunks [0, done) are written
  int tail;  // its chunks [tail, ...) are written, all -1

  __device__ Stage(int* smem, size_t b, int T)
      : buf(smem), o((int)(b * T % kChunk)), end(0), done(0),
        tail((T + o + kChunk - 1) / kChunk) {}
  // emits staged and not yet written, counted from the start of its chunk
  __device__ __forceinline__ int staged() const { return end + o - done * kChunk; }
  __device__ __forceinline__ void emit(int lane, int node) {
    buf[lane * kStageRow + ((end + o) & (2 * kChunk - 1))] = node;
    ++end;
  }
};

// Write chunk c of read j's rows (lane `lane` its entry): the labels and
// steps of the staged emits below `end`, -1 past it.
__device__ __forceinline__ void put_chunk(const Stage& s, int j, int c, int o, int end, int lane,
                                          size_t row, int T, const Ids& ids,
                                          int* __restrict__ labels_rev,
                                          int* __restrict__ times_rev) {
  const int q = c * kChunk - o + lane;
  if (q < 0 || q >= T) return;
  int label = -1, t = -1;
  if (q < end) {
    const int v = s.buf[j * kStageRow + ((c * kChunk + lane) & (2 * kChunk - 1))];
    t = ids.by_ka.div(v);
    label = v - ids.by_a.div(v) * ids.A;
  }
  labels_rev[row + q] = label;
  times_rev[row + q] = t;
}

// Write the chunks of every lane's rows that no later emit can change, the
// warp's lanes over a chunk's entries: the chunks below its emits' end, and
// those past `reach`, the end plus the most emits the lane can still add
// (`more`; a lane whose walk is at step t adds at most t), which hold -1.
// Where `more` is 0 the chunk across the end is complete too.  So every
// store is an aligned chunk, each written once, and the -1 tail goes out
// while the sweep still streams.  A flush usually finds at most one chunk of
// each kind a read: those go out in one unrolled, predicated pass over the
// 32 reads, whose shuffles, loads and stores overlap; the rest read by read.
__device__ __forceinline__ void flush(Stage& s, int more, int lane, int b_warp, int B, int T,
                                      const Ids& ids, int* __restrict__ labels_rev,
                                      int* __restrict__ times_rev) {
  __syncwarp();
  const int reach = min(s.end + more, T);
  const int e = (s.end + s.o + (more == 0 ? kChunk - 1 : 0)) / kChunk;
  const int r = (reach + s.o + kChunk - 1) / kChunk;  // >= e: reach >= end
  const bool valid = b_warp + lane < B;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const size_t row = (size_t)(b_warp + j) * T;
    const int oj = (int)(row % kChunk);
    const int endj = __shfl_sync(kFull, s.end, j);
    const int dj = __shfl_sync(kFull, s.done, j);
    const int ej = __shfl_sync(kFull, valid ? e : s.done, j);
    const int rj = __shfl_sync(kFull, r, j);
    const int tj = __shfl_sync(kFull, valid ? s.tail : r, j);
    if (dj < ej) put_chunk(s, j, dj, oj, endj, lane, row, T, ids, labels_rev, times_rev);
    if (rj < tj) put_chunk(s, j, rj, oj, 0, lane, row, T, ids, labels_rev, times_rev);
  }
  unsigned rest = __ballot_sync(kFull, valid && (e - s.done > 1 || s.tail - r > 1));
  while (rest) {
    const int j = __ffs(rest) - 1;
    rest &= rest - 1;
    const size_t row = (size_t)(b_warp + j) * T;
    const int oj = (int)(row % kChunk);
    const int endj = __shfl_sync(kFull, s.end, j);
    const int dj = __shfl_sync(kFull, s.done, j);
    const int ej = __shfl_sync(kFull, e, j);
    const int rj = __shfl_sync(kFull, r, j);
    const int tj = __shfl_sync(kFull, s.tail, j);
    for (int c = dj + 1; c < ej; ++c)
      put_chunk(s, j, c, oj, endj, lane, row, T, ids, labels_rev, times_rev);
    for (int c = rj + 1; c < tj; ++c)
      put_chunk(s, j, c, oj, 0, lane, row, T, ids, labels_rev, times_rev);
  }
  __syncwarp();
  s.done = e;
  s.tail = r;
}

// This lane's first node, whether its walk can emit at all (a node id below
// T*K*A), and the warp's largest step among the nodes that can (-1: none).
__device__ __forceinline__ int first_node(const int* __restrict__ fin, int b, int B, int T,
                                          const Ids& ids, int lane, bool* alive, int* t_top) {
  const int cur = b < B ? fin[b] : -1;
  *alive = cur >= 0 && cur < T * ids.KA;
  int top = *alive ? ids.by_ka.div(cur) : -1;
  for (int off = 16; off; off >>= 1) top = max(top, __shfl_sync(kFull, top, lane ^ off));
  *t_top = top;
  return cur;
}

// One step of a lane's walk, from node `cur` of step t = cur / KA to its
// parent: ends the walk where t does not fall below the last emit's step
// (`prev_id` = that step * KA), else emits `cur` and returns its log row.
// The tests are compares of ids, so the chain from one parent load to the
// next holds one division.
__device__ __forceinline__ int step_from(Stage& s, int lane, int cur, const Ids& ids,
                                         int* prev_t, int* prev_id) {
  s.emit(lane, cur);
  *prev_t = ids.by_ka.div(cur);
  *prev_id = *prev_t * ids.KA;
  return ids.by_a.div(cur);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
traceback_sweep_kernel(const int* __restrict__ fin, const int* __restrict__ ids_log, int B,
                       int T, int K, int A, int steps, int* __restrict__ labels_rev,
                       int* __restrict__ times_rev, int* __restrict__ count) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b_warp = (blockIdx.x * (blockDim.x >> 5) + warp) * 32;
  if (b_warp >= B) return;  // the whole warp: its warps share nothing
  const int b = b_warp + lane;
  const Ids ids(K, A);
  const int tile = steps * K * 32;  // words of one ring slot
  Stage s(smem + (size_t)warp * (32 * kStageRow + kRing * tile), b, T);
  int* ring = s.buf + 32 * kStageRow;

  bool alive;
  int t_top;
  int cur = first_node(fin, b, B, T, ids, lane, &alive, &t_top);
  int prev_t = T, prev_id = T * ids.KA;  // the last emit's step, and its first id
  const int tiles = t_top < 0 ? 0 : t_top / steps + 1;

  // tile i holds steps [lo, hi], hi = t_top - i*steps, in ring slot i % kRing
  auto issue = [&](int i) {
    const int hi = t_top - i * steps;
    const int lo = max(hi - steps + 1, 0);
    if (!alive) return;  // an ended walk reads nothing more
    int* dst = ring + (i % kRing) * tile + lane;
    const int* src = ids_log + (size_t)lo * K * B + b;
    const int rows = (hi - lo + 1) * K;
    for (int r = 0; r < rows; ++r)
      __pipeline_memcpy_async(dst + r * 32, src + (size_t)r * B, sizeof(int));
  };
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < tiles) issue(i);
    __pipeline_commit();
  }
  for (int i = 0; i < tiles; ++i) {
    if (!__any_sync(kFull, alive)) break;
    // the slot of tile i - 1, which this lane alone read, takes tile i + kRing - 1
    if (i + kRing - 1 < tiles) issue(i + kRing - 1);
    __pipeline_commit();
    __pipeline_wait_prior(kRing - 1);  // this lane's copies of tile i have landed
    const int hi = t_top - i * steps;
    const int lo = max(hi - steps + 1, 0);
    if (__any_sync(kFull, s.staged() > 2 * kChunk - (hi - lo + 1)))
      flush(s, alive ? min(prev_t, hi + 1) : 0, lane, b_warp, B, T, ids, labels_rev,
            times_rev);
    const int lo_id = lo * ids.KA, lo_row = lo * K;  // the tile's first id and log row
    const int slot = (i % kRing) * tile + lane;
    while (alive) {
      if (cur >= prev_id) {  // its step does not decrease
        alive = false;
        break;
      }
      if (cur < lo_id) break;  // a later tile's step
      cur = ring[slot + (step_from(s, lane, cur, ids, &prev_t, &prev_id) - lo_row) * 32];
      alive = cur >= 0;
    }
  }
  __pipeline_wait_prior(0);
  flush(s, 0, lane, b_warp, B, T, ids, labels_rev, times_rev);
  if (b < B) count[b] = s.end;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
traceback_walk_kernel(const int* __restrict__ fin, const int* __restrict__ ids_log, int B,
                      int T, int K, int A, int* __restrict__ labels_rev,
                      int* __restrict__ times_rev, int* __restrict__ count) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b_warp = (blockIdx.x * (blockDim.x >> 5) + warp) * 32;
  if (b_warp >= B) return;
  const int b = b_warp + lane;
  const Ids ids(K, A);
  Stage s(smem + (size_t)warp * 32 * kStageRow, b, T);

  bool alive;
  int t_top;
  int cur = first_node(fin, b, B, T, ids, lane, &alive, &t_top);
  int prev_t = T, prev_id = T * ids.KA;
  do {
    for (int e = 0; e < kChunk && alive; ++e) {  // a flush leaves < kChunk staged
      if (cur >= prev_id) {
        alive = false;
        break;
      }
      cur = ids_log[(size_t)step_from(s, lane, cur, ids, &prev_t, &prev_id) * B + b];
      alive = cur >= 0;
    }
    flush(s, alive ? prev_t : 0, lane, b_warp, B, T, ids, labels_rev, times_rev);
  } while (__any_sync(kFull, alive));
  if (b < B) count[b] = s.end;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block of `warps` warps: each warp's staged
// emits ([32][kStageRow]) and, for the sweep
// (`steps` > 0), its ring of kRing tiles of `steps` steps, K rows of 32
// reads each.  What bounds the K the sweep takes.
long long ctc_traceback_smem_bytes(int K, int warps, int steps) {
  return warps * (32LL * kStageRow + (long long)kRing * steps * K * 32) * (long long)sizeof(int);
}

// Launch the traceback on `stream`.  fin [B], ids_log [T, K, B] in; outputs
// labels_rev [B, T], times_rev [B, T], count [B]; all i32 device memory
// allocated by the caller.  route 0: the sweep, `steps` (1..32) steps a
// tile, which must fit kSmemLimit; route 1: the walk (`steps` ignored).
// `warps` (1..8) warps a block.  Returns the launch's cudaError_t (0 =
// launched).
int ctc_traceback_launch(const int* fin, const int* ids_log, int B, int T, int K, int A,
                         int* labels_rev, int* times_rev, int* count, int route, int warps,
                         int steps, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || A < 1 || T < 0 || warps < 1 || warps > kMaxWarps || route < 0 || route > 1)
    return cudaErrorInvalidValue;
  if ((long long)T * K * A > 0x7fffffffLL) return cudaErrorInvalidValue;  // int32 node ids
  const bool sweep = route == 0;
  if (sweep && (steps < 1 || steps > kChunk)) return cudaErrorInvalidValue;
  const long long bytes = ctc_traceback_smem_bytes(K, warps, sweep ? steps : 0);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  const size_t smem = (size_t)bytes;
  const int reads_per_block = 32 * warps;
  const dim3 grid((B + reads_per_block - 1) / reads_per_block);
  const dim3 block(reads_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (sweep) {
    rc = cudaFuncSetAttribute(traceback_sweep_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
    traceback_sweep_kernel<<<grid, block, smem, st>>>(fin, ids_log, B, T, K, A, steps,
                                                      labels_rev, times_rev, count);
  } else {
    rc = cudaFuncSetAttribute(traceback_walk_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
    traceback_walk_kernel<<<grid, block, smem, st>>>(fin, ids_log, B, T, K, A, labels_rev,
                                                     times_rev, count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
