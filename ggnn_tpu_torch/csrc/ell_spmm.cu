// Sorted-segment gather-sum: the sparse GGNN's message aggregation (B1)
// and its transpose, the aggregation's gradient (B2), one kernel body
// behind two entry points.
//
// B1 (`gather_segment_sum_f32`):
//
//   out[s, :] = sum over e in [off[s], off[s+1]) of h[src[e], :]
//
//   h   [N, H] f32, src [E] int32, off [S+1] int32 (CSR offsets of a
//   segment-sorted edge list), out [S, H] f32.
//
// Replaces the Pallas TPU kernel `_agg_kernel`
// (ggnn_tpu/ops/pallas/ell_spmm.py:51), which computes the same
// per-(type, target) sums of gathered source rows over a blocked-ELL
// layout by building a one-hot matrix on chip and contracting it with
// the gathered rows on the MXU. That one-hot product is a TPU device for
// keeping a scatter off the vector unit; it is not carried over.
//
// B2, the transpose (`segment_scatter_sum_f32`):
//
//   dh[n, :] = sum over e in [boff[n], boff[n+1]) of g[bgather[e], :]
//
//   g [N*T, H] f32 is the gradient of B1's output on the combined lane
//   (row n*T + t is the (target n, type t) sum); bgather [E] int32 holds
//   each real edge's forward composite id target*T + type, in SOURCE
//   order; boff [N+1] int32 are the CSR offsets over sources.
//
// Replaces the Pallas TPU kernel `_scatter_kernel`
// (ggnn_tpu/ops/pallas/ell_spmm.py:101), which gathers rows of one
// type's VMEM-resident cotangent slab, builds a one-hot per source
// block for the MXU and sums over the types outside the kernel. On
// Hopper the transpose is again a sorted-segment gather-sum, over the
// edges sorted by source instead of target, so B2 runs the same kernel
// body as B1 with its own entry point (and its own launch counter in
// the wrapper). An f32 atomicAdd scatter from the forward's target order
// is not used: its summation order would be the scheduler's, and the
// gradient would differ from run to run.
//
// What bounds both on the H100: bytes. Each edge adds one gathered row
// of H floats (4H bytes read for H adds), about 1/4 flop a byte, far
// below the card's f32 ridge. The least traffic is each input row that
// some edge names read once, the indices read once and the output
// written once. At the 20,000-node training batch (T = 4, H = 100) B1
// writes a 32 MB output, two thirds of it the zero rows of empty
// segments, for 40,514 edges; at the serving envelope (N = 2048) h is
// 0.8 MB and stays in the 50 MB L2, as the repeated reads of a source
// row by its several out-edges do. Tensor cores (`wgmma`) and TMA do not
// fit: the rows are gathered by index, 400 B each, one at a time, and
// summed, with no product to feed a matrix unit and no tile that a TMA
// box could describe. The levers are loads in flight, occupancy, and
// the L2.
//
// Design: two kinds of warp in one launch, with no host-side plan.
//
//   * Segment warps take G consecutive segments each. One load brings
//     their G + 1 offsets, one a lane; the warp then walks the edges of
//     its segments in order, their ids 32 a round, one a lane, and the
//     rows of kRowsInFlight consecutive edges loaded before any is
//     added, across segment boundaries; a sum is stored when its segment
//     ends, and the zero rows of empty segments while the first ids
//     load. The launcher sizes G from S and the index array's length E
//     (an upper bound of the edges, so `off` is not read on the host):
//     about kItemsPerWarp items (segment ends and edges) a warp at the
//     lane's mean density, but no fewer than kFillWarps segment warps,
//     so a small launch still spreads over the card. A warp's first load
//     depends on nothing, so on a lane of short segments (molecules) its
//     chain of dependent loads is offsets, ids, rows, as with one warp a
//     segment, and it writes G rows instead of one.
//   * A segment of more than kSplit edges is cut. Its segment warp sums
//     its first kSplit edges (the head); the rest go to the chunk warps,
//     chunk c holding edges [c * kSplit, (c + 1) * kSplit) of the index
//     array. A chunk warp finds the segment holding its first edge by a
//     search of `off` inside the kernel (32 probes a round and a ballot)
//     and sums that segment's edges in the chunk past its head, if any.
//     A segment's tail begins kSplit edges after its start, so a chunk
//     holds a piece of one segment at most, and a long segment is cut
//     over as many warps as its length needs. The chunk warps come after
//     the segment warps in the grid: the segment warps, which write the
//     output, start first, and on a lane with no long segment the chunk
//     warps only search and leave.
//
// The lanes stride over the row's columns (float4 loads when H % 4 == 0
// and h, out and the partial rows are 16-byte aligned, scalar loads
// otherwise). Sums stay in f32 registers and each output row is written
// once, with a streaming store (`st.global.cs`): the kernel never reads
// it back, and at the 20,000-node batch the 32 MB output would otherwise
// push h and the offsets out of L2. Only edges in [off[0], off[S]) are
// read, so pads past off[S] are never touched.
//
// Each piece of a cut segment writes its partial sum to a scratch row
// (two a chunk: one for the piece in the chunk, one for the head of the
// cut segment that starts in it, at most one) and takes an integer
// ticket, after a release fence. In each group of kGroup consecutive
// pieces, the warp drawing the group's last ticket adds the group's rows
// in piece order into the group's first row; the group drawing the
// segment's last ticket adds the groups in order into the output row (a
// hub of 5,000 edges has 313 pieces: two levels keep each adding warp at
// 16 or 20 rows). A winner resets its ticket to 0, so the tickets are
// clean for the next call. No float atomics and a fixed order of every
// sum: two calls on the same inputs give the same bits. The wrapper
// keeps the tickets and the partial rows in two buffers per device and
// stream, the tickets zeroed once, when made or grown: in one buffer, a
// call with fewer chunks would write partial rows where a later call
// with more keeps its tickets.
//
// Registers: `__launch_bounds__` pins 4 blocks of 256 threads an SM, at
// most 64 registers a thread; at 5, 6 or 8 blocks the compiler spills
// and every shape was slower on the H100. `ell_spmm_registers` reports
// what the compiler allotted to each instance.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMinBlocksPerSm = 4;
// A segment of more edges is cut into its head and pieces of the chunks
// of kSplit edges; a chunk's ids are loaded one a lane.
constexpr int kSplit = 16;
static_assert(kSplit <= kWarp, "a chunk's ids exceed a warp's lanes");
// The items (segment ends and edges) a segment warp takes, about ...
constexpr int kItemsPerWarp = 16;
// ... unless fewer segment warps than this would be launched.
constexpr int kFillWarps = 2048;
// G <= kItemsPerWarp, so a warp holds its G + 1 offsets one a lane.
static_assert(kItemsPerWarp < kWarp, "a warp's offsets exceed its lanes");
// Divides kWarp: a batch of rows never straddles a round of ids.
constexpr int kRowsInFlight = 4;
// Pieces of a cut segment that one warp adds before the groups are added.
constexpr int kGroup = 16;
// Partial rows in flight while a warp adds pieces.
constexpr int kCombineInFlight = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void add(float& a, const float b) { a += b; }
__device__ __forceinline__ void add(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

int64_t num_chunks(int num_edges) {
  return (static_cast<int64_t>(num_edges) + kSplit - 1) / kSplit;
}

// Segments a segment warp takes: G of them make about kItemsPerWarp
// items at the mean density (S + E) / S (rounded to the nearest), but G
// never leaves fewer than kFillWarps segment warps, and it is at least 1.
int segments_per_warp(int num_segments, int num_edges) {
  const int64_t items = static_cast<int64_t>(num_segments) + num_edges;
  const int64_t by_items =
      (2 * kItemsPerWarp * static_cast<int64_t>(num_segments) + items) /
      (2 * items);
  const int64_t by_fill = num_segments / kFillWarps;
  return static_cast<int>(std::max<int64_t>(std::min(by_items, by_fill), 1));
}

// The warps of one launch with G = 1 (the most) must be counted in int,
// and so must the index array's positions a chunk covers.
bool too_large(int num_segments, int num_edges) {
  return num_edges > INT_MAX - kSplit ||
         num_chunks(num_edges) + num_segments > INT_MAX - kWarpsPerBlock;
}

// Where the pieces of a cut segment [b, e) (e - b > kSplit) go. Piece 0
// is its head [b, b + kSplit), summed by its segment warp, in scratch
// row 2 * (b / kSplit) + 1; piece p >= 1 is its part of chunk
// b / kSplit + p, in row 2 * that chunk. At most one cut segment starts
// in a chunk, and a chunk holds a piece of at most one, so no two pieces
// share a row.
struct Cut {
  int head_chunk;
  int pieces;
  __device__ Cut(int b, int e)
      : head_chunk(b / kSplit), pieces((e - 1) / kSplit - b / kSplit + 1) {}
  __device__ size_t row(int p) const {
    return p == 0 ? 2 * static_cast<size_t>(head_chunk) + 1
                  : 2 * static_cast<size_t>(head_chunk + p);
  }
};

// The segment [b, e) that holds position a of the index array, returned
// with its index; -1 when a < off[0]. It is the last s < S with
// off[s] <= a (for a >= off[S], the last segment, and then e <= a). The
// 32 lanes probe 32 candidates spread over [lo, hi] and a ballot keeps
// the interval between the last hit and the next probe, until one load
// of off[lo .. hi + 1] resolves it. Called by the whole warp.
__device__ int find_segment(const int* __restrict__ off, int num_segments,
                            int a, int lane, int& b, int& e) {
  int lo = 0;
  int hi = num_segments - 1;
  while (hi - lo >= kWarp - 1) {
    const int step = (hi - lo) / kWarp + 1;
    const int q = lo + lane * step;
    const unsigned hits =
        __ballot_sync(kFull, q <= hi && __ldg(off + q) <= a);
    if (hits == 0) return -1;  // off[lo] <= a holds after the first round
    const int j = kWarp - 1 - __clz(static_cast<int>(hits));
    lo += j * step;
    hi = min(hi, lo + step - 1);
  }
  // off[lo .. hi + 1], hi + 1 <= S, one a lane.
  const int v = __ldg(off + min(lo + lane, num_segments));
  const unsigned hits = __ballot_sync(kFull, lane <= hi - lo && v <= a);
  if (hits == 0) return -1;
  const int j = kWarp - 1 - __clz(static_cast<int>(hits));
  b = __shfl_sync(kFull, v, j);
  e = __shfl_sync(kFull, v, j + 1);
  return lo + j;
}

// The row a sum goes to: row r of `out` for dst = r >= 0, scratch row r
// of `partials` for dst = -1 - r.
__device__ __forceinline__ int scratch_dst(size_t row) {
  return -1 - static_cast<int>(row);
}

// Stores v into column `col` of the row that lane k's `dst` names, an
// output row with a streaming store; k is the same on every lane.
template <typename V>
__device__ __forceinline__ void store_row(V* out, V* partials, int dst, int k,
                                          const V& v, int col, int width,
                                          bool active) {
  const int r = __shfl_sync(kFull, dst, k);
  if (active) {
    if (r >= 0) {
      __stcs(out + static_cast<size_t>(r) * width + col, v);
    } else {
      partials[static_cast<size_t>(-1 - r) * width + col] = v;
    }
  }
}

// Sums runs of edges into rows: run k < n, held on lane k, is the edges
// [begin, begin + count) of the index array, and `dst` on lane k the
// row its sum goes to (a zero row when count is 0). The runs' edges are
// walked in order, their ids 32 a round, one a lane, and the rows of
// kRowsInFlight consecutive edges loaded before any is added, across
// runs; a sum stays in f32 registers and is stored once, when its run
// ends. Called by the whole warp.
template <typename V>
__device__ void sum_runs(const V* __restrict__ h, const int* __restrict__ src,
                         V* out, V* partials, int n, int begin, int count,
                         int dst, int width, int lane) {
  int upto = count;  // the edges of runs 0 .. lane
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const int t = __shfl_up_sync(kFull, upto, d);
    if (lane >= d) upto += t;
  }
  const int total = __shfl_sync(kFull, upto, kWarp - 1);
  // Walk position q of run k is edge q + skip_k of the index array.
  const int skip = begin - (upto - count);
  const unsigned empty = __ballot_sync(kFull, lane < n && count == 0);
  for (int col0 = 0; col0 < width; col0 += kWarp) {
    const int col = col0 + lane;
    const bool active = col < width;
    V acc;
    zero(acc);
    int run = -1;  // the run acc holds
    // The ids of walk positions q0 + lane, and r the run of each: the
    // runs that end at or before it.
    int r;
    auto load_ids = [&](int q0) {
      const int q = q0 + lane;
      r = 0;
#pragma unroll
      for (int step = kWarp / 2; step >= 1; step /= 2) {
        if (__shfl_sync(kFull, upto, r + step - 1) <= q) r += step;
      }
      const int at = q + __shfl_sync(kFull, skip, r);
      return q < total ? __ldg(src + at) : 0;
    };
    int id = load_ids(0);
    // The zero rows are stored while the first ids load.
    for (unsigned z = empty; z != 0; z &= z - 1) {
      V zero_row;
      zero(zero_row);
      store_row(out, partials, dst, __ffs(static_cast<int>(z)) - 1, zero_row,
                col, width, active);
    }
    for (int q0 = 0; q0 < total; q0 += kWarp) {
      if (q0 > 0) id = load_ids(q0);
      const int m = min(kWarp, total - q0);
      for (int u0 = 0; u0 < m; u0 += kRowsInFlight) {
        V rows[kRowsInFlight];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const int row = __shfl_sync(kFull, id, u0 + u);
          zero(rows[u]);
          if (active && u0 + u < m) {
            rows[u] = __ldg(h + static_cast<size_t>(row) * width + col);
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const int run_u = __shfl_sync(kFull, r, u0 + u);
          if (u0 + u < m) {
            if (run_u != run) {
              if (run >= 0) {
                store_row(out, partials, dst, run, acc, col, width, active);
              }
              zero(acc);
              run = run_u;
            }
            add(acc, rows[u]);
          }
        }
      }
    }
    if (run >= 0) store_row(out, partials, dst, run, acc, col, width, active);
  }
}

// Orders this thread's earlier memory operations before its later ones
// for every thread of the device, without the sequentially consistent
// fence of __threadfence(): a release before a ticket, an acquire after
// winning it.
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Takes a ticket of `count` (an int of the scratch, 0 at rest) for the
// whole warp; true on the warp that draws the last one, which resets the
// ticket to 0 for the next call. The warp barrier before lane 0's
// release fence orders every lane's writes before the ticket; the one
// after its acquire fence orders every lane's reads after it.
__device__ __forceinline__ bool last_ticket(int* ticket, int count,
                                            int lane) {
  __syncwarp();
  int drawn = 0;
  if (lane == 0) {
    fence_acq_rel_gpu();
    drawn = atomicAdd(ticket, 1);
    if (drawn == count - 1) {
      *ticket = 0;
      fence_acq_rel_gpu();
    }
  }
  drawn = __shfl_sync(kFull, drawn, 0);
  __syncwarp();
  return drawn == count - 1;
}

// dst = the sum of the scratch rows of pieces p = from, from + stride,
// ... up to `to`, in that order of pieces with kCombineInFlight loads in
// flight (sum j takes every kCombineInFlight-th piece; the sums are then
// added in index order): a fixed order.
template <typename V>
__device__ void add_pieces(const V* partials, const Cut& cut, int from,
                           int to, int stride, V* dst, int width, int lane) {
  for (int col = lane; col < width; col += kWarp) {
    V sums[kCombineInFlight];
#pragma unroll
    for (int j = 0; j < kCombineInFlight; ++j) zero(sums[j]);
    for (int p0 = from; p0 <= to; p0 += kCombineInFlight * stride) {
#pragma unroll
      for (int j = 0; j < kCombineInFlight; ++j) {
        const int p = p0 + j * stride;
        if (p <= to) add(sums[j], __ldcg(partials + cut.row(p) * width + col));
      }
    }
#pragma unroll
    for (int j = 1; j < kCombineInFlight; ++j) add(sums[0], sums[j]);
    dst[col] = sums[0];
  }
}

// This warp has written piece p of a cut segment to scratch. The last
// warp of each group of kGroup pieces to arrive adds the group's pieces
// into the group's first row; the last group to arrive adds the groups
// into the segment's output row. Called by the whole warp; out of line,
// as only the warps of cut segments reach it.
template <typename V>
__device__ __noinline__ void finish_piece(const Cut& cut, int p,
                                          int* __restrict__ tickets,
                                          int* __restrict__ group_tickets,
                                          V* partials, V* out_row, int width,
                                          int lane) {
  const int g_first = p / kGroup * kGroup;
  const int g_last = min(g_first + kGroup, cut.pieces) - 1;
  if (!last_ticket(group_tickets + cut.row(g_first), g_last - g_first + 1,
                   lane)) {
    return;
  }
  if (cut.pieces <= kGroup) {
    add_pieces(partials, cut, 0, cut.pieces - 1, 1, out_row, width, lane);
    return;
  }
  add_pieces(partials, cut, g_first, g_last, 1,
             partials + cut.row(g_first) * width, width, lane);
  if (!last_ticket(tickets + cut.head_chunk, (cut.pieces - 1) / kGroup + 1,
                   lane)) {
    return;
  }
  add_pieces(partials, cut, 0, cut.pieces - 1, kGroup, out_row, width, lane);
}

// Segments [first, first + n): their sums, the heads of the cut ones to
// scratch, then the hand-over of those heads.
template <typename V>
__device__ void segment_warp(const V* __restrict__ h,
                             const int* __restrict__ src,
                             const int* __restrict__ off, V* __restrict__ out,
                             int* tickets, int* group_tickets, V* partials,
                             int first, int n, int width, int lane) {
  const int b = __ldg(off + first + min(lane, n));
  const int e = __shfl_down_sync(kFull, b, 1);  // lanes < n
  const int len = lane < n ? e - b : 0;
  const bool cut = len > kSplit;
  const int dst = cut ? scratch_dst(2 * static_cast<size_t>(b / kSplit) + 1)
                      : first + lane;
  sum_runs(h, src, out, partials, n, b, min(len, kSplit), dst, width, lane);
  for (unsigned m = __ballot_sync(kFull, cut); m != 0; m &= m - 1) {
    const int k = __ffs(static_cast<int>(m)) - 1;
    const Cut segment(__shfl_sync(kFull, b, k), __shfl_sync(kFull, e, k));
    finish_piece(segment, 0, tickets, group_tickets, partials,
                 out + static_cast<size_t>(first + k) * width, width, lane);
  }
}

// Chunk c: the piece, past its head, of the cut segment that holds the
// chunk's first edge, if there is one.
template <typename V>
__device__ void chunk_warp(const V* __restrict__ h,
                           const int* __restrict__ src,
                           const int* __restrict__ off, V* __restrict__ out,
                           int* tickets, int* group_tickets, V* partials,
                           int num_segments, int c, int width, int lane) {
  const int a = c * kSplit;
  int b = 0, e = 0;
  const int seg = find_segment(off, num_segments, a, lane, b, e);
  // A segment that starts after a has its tail past the chunk.
  const int lo = max(a, b + kSplit);
  const int hi = min(a + kSplit, e);
  if (seg < 0 || e - b <= kSplit || lo >= hi) return;
  sum_runs(h, src, out, partials, 1, lo, lane == 0 ? hi - lo : 0,
           scratch_dst(2 * static_cast<size_t>(c)), width, lane);
  const Cut segment(b, e);
  finish_piece(segment, c - segment.head_chunk, tickets, group_tickets,
               partials, out + static_cast<size_t>(seg) * width, width, lane);
}

// V is float or float4; `width` is the row length in units of V. The
// first ceil(S / group) warps are segment warps of `group` segments, the
// next `chunks` chunk warps. `tickets` [chunks] and `group_tickets`
// [2 * chunks] are 0 on entry and on exit; `partials` hold two rows of
// `width` a chunk. Every branch depends on values that are the same on
// all lanes of a warp, so the warp leaves together and every shuffle and
// ballot has its full warp.
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp, kMinBlocksPerSm)
segment_sum_kernel(const V* __restrict__ h, const int* __restrict__ src,
                   const int* __restrict__ off, V* __restrict__ out,
                   int* __restrict__ tickets,
                   int* __restrict__ group_tickets, V* partials,
                   int num_segments, int chunks, int group, int width) {
  const int lane = threadIdx.x % kWarp;
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int segment_warps = (num_segments + group - 1) / group;
  if (warp < segment_warps) {
    const int first = warp * group;
    segment_warp(h, src, off, out, tickets, group_tickets, partials, first,
                 min(group, num_segments - first), width, lane);
  } else if (warp - segment_warps < chunks) {
    chunk_warp(h, src, off, out, tickets, group_tickets, partials,
               num_segments, warp - segment_warps, width, lane);
  }
}

bool vectorized(const void* h, const void* out, const void* partials,
                int hidden) {
  return hidden % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(partials) % 16 == 0;
}

const void* instance(bool vec) {
  return vec ? reinterpret_cast<const void*>(segment_sum_kernel<float4>)
             : reinterpret_cast<const void*>(segment_sum_kernel<float>);
}

// Launches the kernel on `stream` of `device` and returns the CUDA error
// code (0 on success). This library links its own CUDA runtime, whose
// current device is not PyTorch's, so it is set here. The caller
// validates shapes, types and contiguity; num_segments and hidden are
// positive, num_edges is the length of the index array (an upper bound of
// off[S] - off[0], which sizes the grid without reading `off` on the
// host); `tickets` and `partials` hold the ints, all 0, and the floats
// that ell_spmm_scratch gives for these sizes.
int launch(const void* h, const void* src, const void* off, void* out,
           void* tickets, void* partials, int num_segments, int num_edges,
           int hidden, int device, void* stream) {
  if (too_large(num_segments, num_edges)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  int chunks = static_cast<int>(num_chunks(num_edges));
  int group = segments_per_warp(num_segments, num_edges);
  const int64_t warps =
      chunks + (static_cast<int64_t>(num_segments) + group - 1) / group;
  const bool vec = vectorized(h, out, partials, hidden);
  int width = vec ? hidden / 4 : hidden;
  const dim3 blocks(static_cast<unsigned>(
      (warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  // The kernel's parameters by address; the pointers have the same size
  // and bits whatever V is.
  void* group_tickets = static_cast<int*>(tickets) + chunks;
  void* args[] = {&h,        &src,          &off,          &out,
                  &tickets,  &group_tickets, &partials, &num_segments,
                  &chunks,   &group,        &width};
  cudaLaunchKernel(instance(vec), blocks, dim3(kWarpsPerBlock * kWarp),
                   args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B1: out [num_segments, hidden] from h, src [num_edges] and off.
extern "C" int gather_segment_sum_f32(const void* h, const void* src,
                                      const void* off, void* out,
                                      void* tickets, void* partials,
                                      int num_segments, int num_edges,
                                      int hidden, int device, void* stream) {
  return launch(h, src, off, out, tickets, partials, num_segments,
                num_edges, hidden, device, stream);
}

// B2: dh [num_nodes, hidden] from g, bgather [num_edges] and boff.
extern "C" int segment_scatter_sum_f32(const void* g, const void* bgather,
                                       const void* boff, void* dh,
                                       void* tickets, void* partials,
                                       int num_nodes, int num_edges,
                                       int hidden, int device, void* stream) {
  return launch(g, bgather, boff, dh, tickets, partials, num_nodes,
                num_edges, hidden, device, stream);
}

// The scratch of a launch over num_segments segments, an index array of
// num_edges entries and rows of `hidden` floats: *tickets ints, 0 at rest
// (three a chunk: one for the cut segment that starts in it, two for
// groups of pieces), and *partials floats (two rows a chunk). Returns -1
// when the launch's warps or positions overflow an int, else 0.
extern "C" int ell_spmm_scratch(int num_segments, int num_edges, int hidden,
                                int64_t* tickets, int64_t* partials) {
  if (too_large(num_segments, num_edges)) return -1;
  const int64_t chunks = num_chunks(num_edges);
  *tickets = 3 * chunks;
  *partials = 2 * chunks * hidden;
  return 0;
}

// The most edges of a segment that is not cut, and the edges of a chunk.
extern "C" int ell_spmm_split() { return kSplit; }

// The registers a thread of the float4 (vectorized_path != 0) or scalar
// instance uses, as the compiler allotted them, into *regs; returns the
// CUDA error code.
extern "C" int ell_spmm_registers(int vectorized_path, int device,
                                  int* regs) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaFuncAttributes attr;
  const cudaError_t got =
      cudaFuncGetAttributes(&attr, instance(vectorized_path != 0));
  if (got != cudaSuccess) return static_cast<int>(got);
  *regs = attr.numRegs;
  return 0;
}
