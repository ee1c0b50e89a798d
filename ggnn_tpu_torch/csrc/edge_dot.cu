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
// [E, H] gathers for each; this kernel reads each row once into
// registers and writes one float an edge.
//
// What bounds it on the H100: bytes. An edge reads two rows of H floats
// for 2H operations, about 1/4 flop a byte, far below the card's f32
// ridge; the least traffic is each row that some pair names read once,
// the ids read once and one float an edge written. At the 20,000-node
// training batch h is 8 MB and stays in the 50 MB L2, as do the repeated
// reads of a row by its several edges. The levers are loads in flight
// and the warps that hold them.
//
// Design: a warp takes kEdges consecutive edges. Lanes 0 .. kEdges-1
// load their a ids and lanes kEdges .. 2 kEdges-1 their b ids in one
// load instruction; the warp then loads the rows of all kEdges pairs
// (float4 per lane when H % 4 == 0 and x and y are 16-byte aligned,
// scalar otherwise), 2 kEdges row loads of each lane in flight before
// any product, each lane's products summed in registers over its
// columns. Each edge's lane sums are added by a butterfly of shuffles
// (xor 16, 8, 4, 2, 1) and lane 0 stores them. No atomics and a fixed
// order of every sum: two calls on the same inputs give the same bits.
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
// (bf16 rows, as bits); `width` is the row length in units of V. Every
// branch around a shuffle depends on values that are the same on all
// lanes of a warp, so every shuffle has its full warp.
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
  int ra[kEdges], rb[kEdges];
  bool real[kEdges];
#pragma unroll
  for (int u = 0; u < kEdges; ++u) {
    ra[u] = __shfl_sync(kFull, id, u);
    rb[u] = __shfl_sync(kFull, id, kEdges + u);
    real[u] = u < n && static_cast<unsigned>(rb[u]) <
                           static_cast<unsigned>(rows_y);
  }
  float acc[kEdges];
#pragma unroll
  for (int u = 0; u < kEdges; ++u) acc[u] = 0.f;
  for (int col = lane; col - lane < width; col += kWarp) {
    const bool active = col < width;
    V xv[kEdges], yv[kEdges];
#pragma unroll
    for (int u = 0; u < kEdges; ++u) {
      zero(xv[u]);
      zero(yv[u]);
      if (active && real[u]) {
        xv[u] = __ldg(x + static_cast<size_t>(ra[u]) * width + col);
        yv[u] = __ldg(y + static_cast<size_t>(rb[u]) * width + col);
      }
    }
#pragma unroll
    for (int u = 0; u < kEdges; ++u) acc[u] += dot(xv[u], yv[u]);
  }
#pragma unroll
  for (int u = 0; u < kEdges; ++u) {
#pragma unroll
    for (int d = kWarp / 2; d >= 1; d /= 2) {
      acc[u] += __shfl_xor_sync(kFull, acc[u], d);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < kEdges; ++u) {
      if (u < n) out[first + u] = acc[u];
    }
  }
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
