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
// What bounds it on the H100: bytes. Each edge adds one gathered row of
// H floats (4H bytes read for H adds), about 1/4 flop per byte, far
// below the card's f32 ridge. The least traffic is h read once, the
// indices read once and out written once; at the serving envelope
// (N = 2048, T = 4, H = 100) h is 0.8 MB and stays in the 50 MB L2, so
// the repeated reads of a source row by its several out-edges hit L2.
//
// Design: one warp per output row. The warp's lanes stride over the
// row's columns (float4 loads when H % 4 == 0 and the rows are 16-byte
// aligned, scalar loads otherwise); the warp walks its segment's edges,
// loading 32 source ids at once (one coalesced load) and broadcasting
// each with a shuffle. Sums stay in f32 registers (32 registers a
// thread, so 64 warps fit on an SM and hide the load latency of the
// short segments of molecular graphs) and each row is written exactly
// once, so empty segments come out as zeros. No atomics, no memset, no
// second pass, and the summation order is fixed (edge order), so the
// result is deterministic. A segment runs on one warp whatever its
// length: a hub of thousands of edges is latency-bound on that warp.
// Loading a hub's rows 8 at a time halved its time but took the float4
// kernel to 76 registers and doubled its time at the 20k-node shape
// on an H100 (PERF.md, Findings), so it is not done.

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
// the wrapper). The alternative, an f32 atomicAdd scatter from the
// forward's target order, is not used: its summation order would be
// the scheduler's, and the gradient would differ from run to run.
//
// What bounds B2: bytes, as for B1. g is T times larger than h (32 MB at
// N = 20,000, T = 4, H = 100, still inside L2, but not at the
// reference's 100,000-node budget); the kernel reads one g row per real
// edge, and only the rows of (target, type) pairs that have an edge,
// and writes each dh row once. The design above carries over as it is:
// one warp per dh row (a source node, whose out-edges of all types form
// one segment), float4 lanes, f32 register sums, each row written once,
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kWarp = 32;

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

// V is float or float4; `width` is the row length in units of V.
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
gather_segment_sum_kernel(const V* __restrict__ h,
                          const int* __restrict__ src,
                          const int* __restrict__ off,
                          V* __restrict__ out, int num_segments,
                          int width) {
  const int lane = threadIdx.x % kWarp;
  const int seg = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  // `seg` is the same for all lanes of a warp, so the warp leaves
  // together and every shuffle below has its full warp.
  if (seg >= num_segments) return;
  const int begin = off[seg];
  const int end = off[seg + 1];
  V* out_row = out + static_cast<size_t>(seg) * width;
  for (int col0 = 0; col0 < width; col0 += kWarp) {
    const int col = col0 + lane;
    const bool active = col < width;
    V acc;
    zero(acc);
    for (int base = begin; base < end; base += kWarp) {
      const int n = min(kWarp, end - base);
      const int my_src = lane < n ? __ldg(src + base + lane) : 0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int row = __shfl_sync(0xffffffffu, my_src, j);
        if (active) {
          add(acc, __ldg(h + static_cast<size_t>(row) * width + col));
        }
      }
    }
    if (active) out_row[col] = acc;
  }
}

}  // namespace

// Launches the kernel on `stream` of `device` and returns the CUDA error
// code (0 on success). This library links its own CUDA runtime, whose
// current device is not PyTorch's, so it is set here. The caller
// validates shapes, types and contiguity; num_segments and hidden are
// positive.
static int launch(const void* h, const void* src, const void* off,
                  void* out, int num_segments, int hidden, int device,
                  void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = kWarpsPerBlock * kWarp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = hidden % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    gather_segment_sum_kernel<float4><<<blocks, threads, 0, s>>>(
        static_cast<const float4*>(h), static_cast<const int*>(src),
        static_cast<const int*>(off), static_cast<float4*>(out),
        num_segments, hidden / 4);
  } else {
    gather_segment_sum_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const int*>(src),
        static_cast<const int*>(off), static_cast<float*>(out),
        num_segments, hidden);
  }
  return static_cast<int>(cudaGetLastError());
}

// B1: out [num_segments, hidden] from h, src and off.
extern "C" int gather_segment_sum_f32(const void* h, const void* src,
                                      const void* off, void* out,
                                      int num_segments, int hidden,
                                      int device, void* stream) {
  return launch(h, src, off, out, num_segments, hidden, device, stream);
}

// B2: dh [num_nodes, hidden] from g, bgather and boff.
extern "C" int segment_scatter_sum_f32(const void* g, const void* bgather,
                                       const void* boff, void* dh,
                                       int num_nodes, int hidden,
                                       int device, void* stream) {
  return launch(g, bgather, boff, dh, num_nodes, hidden, device, stream);
}
