// Per-edge dot product of two gathered rows (a port-only kernel):
//
//   out[e] = <x[a[e], :], y[b[e], :]>   for e in [0, E)
//
//   x [NX, H] f32, a [E] int32 in [0, NX), y [NY, H] f32, b [E] int32,
//   out [E] f32. A pair whose b[e] lies outside [0, NY) is a pad and
//   gets 0: the packers' pads point at the dump slot one past the last
//   row (target N of the node states, composite id N*T of an
//   aggregation's output), so the pads need no clamp.
//
// It replaces no TPU kernel: the JAX package computes both of its uses
// in XLA, outside Pallas. They are the sparse GGNN's propagation
// attention scores <h[src], h[tgt]> (ggnn_tpu/ops/messages.py:56-70),
// and the gradient of the attention weights in the weighted aggregation,
// dw[e] = <h[src[e]], g[comp[e]]>. A plain version materialises two
// [E, H] gathers for each; this kernel reads each pair's rows into
// registers and writes one float an edge.
//
// What bounds it on the H100: bytes. An edge reads two rows of H floats
// for 2H operations, about 1/4 flop a byte, far below the card's f32
// ridge; the least traffic is each row that some pair names read once,
// the ids read once and one float an edge written. At the 20,000-node
// training batch h is 8 MB and stays in the 50 MB L2, as do the repeated
// reads of a row by its several edges. The levers are loads in flight
// and the warps that hold them: at that batch a launch takes about 9 us,
// of which about 4.9 us is the launch itself (an empty kernel through the
// same path), and a design that holds more in registers loses warps.
//
// Design: a warp takes kEdges consecutive edges, one a group of kLanes =
// 8 lanes. Lanes 0 .. kEdges-1 load their a ids and lanes kEdges ..
// 2 kEdges-1 their b ids in one load instruction; lane li of a group then
// loads units li, li + 8, li + 16, li + 24 of its edge's x and y rows
// (float4 per lane when H % 4 == 0 and x and y are 16-byte aligned,
// scalar otherwise; a wider row takes further passes of 4 units a lane),
// 8 row loads of each lane in flight before any product, so at H = 100
// every lane loads (25 float4 units over 8 lanes), and its products are
// summed in registers. An edge's lane sums are added by a butterfly of 3
// shuffles inside its group (xor 4, 2, 1) and the group's first lane
// stores them. No atomics and a fixed order of every sum: two calls on
// the same inputs give the same bits.
//
// Designs timed against this one on an H100 and rejected (PERF.md has
// their numbers): a warp of 32 consecutive edges walked by groups with
// the y row kept while b repeats and the rows staged by `cp.async` (its
// per-warp walk is a chain of dependent steps that the small launches
// cannot hide), and the kernel before this one (all 32 lanes on one edge
// at a time, a 5-round butterfly an edge, 7 of 32 lanes idle at H = 100)
// with the y row reused or 8 edges a warp, each of which costs registers
// and so warps.
//
// The bf16 instance (`edge_dot_bf16`, `compute_dtype: bfloat16`): x and y
// bf16, out f32. A lane loads 8 bf16 values (16 bytes) when H % 8 == 0
// and x and y are 16-byte aligned, 4 (8 bytes) when H % 4 == 0 and they
// are 8-byte aligned, one otherwise; it widens each to f32 (exact) and
// multiplies in f32, where a product of two bf16 values is exact, so
// each dot is the f32 sum of its exact products. The JAX model rounds
// each product to bf16 before its f32 sum (ggnn_tpu/ops/messages.py:68);
// the port does not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
// Edges a warp takes; 2 * kEdges <= 32 ids load in one instruction.
constexpr int kEdges = 4;
static_assert(2 * kEdges <= kWarp, "a warp's ids exceed its lanes");
// The lanes of an edge's group, and the units of a row each loads a pass.
constexpr int kLanes = kWarp / kEdges;
constexpr int kUnits = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float dot(const float u, const float v) {
  return u * v;
}
__device__ __forceinline__ float dot(const float4 u, const float4 v) {
  return u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
}

// bf16 rows, as their bits: 1, 4 or 8 values a lane.
__device__ __forceinline__ void zero(unsigned short& v) { v = 0; }
__device__ __forceinline__ void zero(uint2& v) { v = make_uint2(0, 0); }
__device__ __forceinline__ void zero(uint4& v) { v = make_uint4(0, 0, 0, 0); }
// The low and the high bf16 value of a 32-bit word, widened (exact).
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ float dot(const unsigned u, const unsigned v) {
  return bf16_lo(u) * bf16_lo(v) + bf16_hi(u) * bf16_hi(v);
}
__device__ __forceinline__ float dot(const unsigned short u,
                                     const unsigned short v) {
  return bf16_lo(u) * bf16_lo(v);
}
__device__ __forceinline__ float dot(const uint2 u, const uint2 v) {
  return dot(u.x, v.x) + dot(u.y, v.y);
}
__device__ __forceinline__ float dot(const uint4 u, const uint4 v) {
  return dot(u.x, v.x) + dot(u.y, v.y) + dot(u.z, v.z) + dot(u.w, v.w);
}

// V is float or float4 (f32 rows), or unsigned short, uint2 or uint4
// (bf16 rows, as bits); `width` is the row length in units of V. Lane li
// of group u holds units li, li + kLanes, ... of edge u's rows, kUnits of
// them a pass. The branches on an edge's own values (`real`, a column
// past the row) guard loads only; every shuffle has its full warp.
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
edge_dot_kernel(const V* __restrict__ x, const int* __restrict__ a,
                const V* __restrict__ y, const int* __restrict__ b,
                float* __restrict__ out, int num_edges, int rows_y,
                int width) {
  const int lane = threadIdx.x % kWarp;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
       threadIdx.x / kWarp) * kEdges;
  if (first >= num_edges) return;
  const int64_t left = num_edges - first;
  const int n = left < kEdges ? static_cast<int>(left) : kEdges;
  int id = 0;
  if (lane < n) {
    id = __ldg(a + first + lane);
  } else if (lane >= kEdges && lane - kEdges < n) {
    id = __ldg(b + first + lane - kEdges);
  }
  const int u = lane / kLanes;   // the group's edge
  const int li = lane % kLanes;  // the lane within its group
  const int ra = __shfl_sync(kFull, id, u);
  const int rb = __shfl_sync(kFull, id, kEdges + u);
  const bool real =
      u < n && static_cast<unsigned>(rb) < static_cast<unsigned>(rows_y);
  float acc = 0.f;
  for (int c0 = li; c0 - li < width; c0 += kLanes * kUnits) {
    V xv[kUnits], yv[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int col = c0 + k * kLanes;
      zero(xv[k]);
      zero(yv[k]);
      if (real && col < width) {
        xv[k] = __ldg(x + static_cast<size_t>(ra) * width + col);
        yv[k] = __ldg(y + static_cast<size_t>(rb) * width + col);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) acc += dot(xv[k], yv[k]);
  }
#pragma unroll
  for (int d = kLanes / 2; d >= 1; d /= 2) {
    acc += __shfl_xor_sync(kFull, acc, d);
  }
  if (li == 0 && u < n) out[first + u] = acc;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The values of a row a lane loads at once: f32 4 (float4) when H % 4 ==
// 0 and x and y are 16-byte aligned, else 1; bf16 8 (16 bytes) when
// H % 8 == 0 and they are 16-byte aligned, 4 (8 bytes) when H % 4 == 0
// and they are 8-byte aligned, else 1.
int vector_elems(const void* x, const void* y, int hidden, bool bf16) {
  if (!bf16) {
    return hidden % 4 == 0 && aligned(x, 16) && aligned(y, 16) ? 4 : 1;
  }
  if (hidden % 8 == 0 && aligned(x, 16) && aligned(y, 16)) return 8;
  if (hidden % 4 == 0 && aligned(x, 8) && aligned(y, 8)) return 4;
  return 1;
}

// The kernel instance for `elems` values a lane load, or nullptr for a
// width that has none.
const void* instance(int elems, bool bf16) {
  if (!bf16) {
    switch (elems) {
      case 1: return reinterpret_cast<const void*>(edge_dot_kernel<float>);
      case 4: return reinterpret_cast<const void*>(edge_dot_kernel<float4>);
      default: return nullptr;
    }
  }
  switch (elems) {
    case 1:
      return reinterpret_cast<const void*>(edge_dot_kernel<unsigned short>);
    case 4: return reinterpret_cast<const void*>(edge_dot_kernel<uint2>);
    case 8: return reinterpret_cast<const void*>(edge_dot_kernel<uint4>);
    default: return nullptr;
  }
}

int launch(const void* x, const void* a, const void* y, const void* b,
           void* out, int num_edges, int rows_y, int hidden, int device,
           void* stream, bool bf16) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int elems = vector_elems(x, y, hidden, bf16);
  int width = hidden / elems;
  const int64_t warps = (static_cast<int64_t>(num_edges) + kEdges - 1) /
                        kEdges;
  const dim3 blocks(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  // The kernel's parameters by address; the pointers have the same size
  // and bits whatever V is.
  void* args[] = {&x, &a, &y, &b, &out, &num_edges, &rows_y, &width};
  cudaLaunchKernel(instance(elems, bf16), blocks,
                   dim3(kWarpsPerBlock * kWarp), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` of `device` and returns the CUDA error
// code (0 on success). This library links its own CUDA runtime, whose
// current device is not PyTorch's, so it is set here. The caller
// validates shapes, types and contiguity; num_edges and hidden are
// positive, and every a[e] lies in [0, NX) (not checked here).
extern "C" int edge_dot_f32(const void* x, const void* a, const void* y,
                            const void* b, void* out, int num_edges,
                            int rows_y, int hidden, int device,
                            void* stream) {
  return launch(x, a, y, b, out, num_edges, rows_y, hidden, device, stream,
                false);
}

// The bf16 instance: x and y bf16, out f32; otherwise as edge_dot_f32.
extern "C" int edge_dot_bf16(const void* x, const void* a, const void* y,
                             const void* b, void* out, int num_edges,
                             int rows_y, int hidden, int device,
                             void* stream) {
  return launch(x, a, y, b, out, num_edges, rows_y, hidden, device, stream,
                true);
}

// The values a lane loads at once (1, 4 or 8) for these x and y, f32 or
// bf16 (bf16 != 0).
extern "C" int edge_dot_vector_elems(const void* x, const void* y,
                                     int hidden, int bf16) {
  return vector_elems(x, y, hidden, bf16 != 0);
}

// The registers a thread of the instance loading `elems` values a lane
// (1 or 4 for f32; 1, 4 or 8 for bf16) uses, as the compiler allotted
// them, into *regs; returns the CUDA error code.
extern "C" int edge_dot_registers(int elems, int bf16, int device,
                                  int* regs) {
  const void* fn = instance(elems, bf16 != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaFuncAttributes attr;
  const cudaError_t got = cudaFuncGetAttributes(&attr, fn);
  if (got != cudaSuccess) return static_cast<int>(got);
  *regs = attr.numRegs;
  return 0;
}
