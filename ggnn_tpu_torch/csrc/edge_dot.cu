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

// V is float or float4; `width` is the row length in units of V. Every
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

bool vectorized(const void* x, const void* y, int hidden) {
  return hidden % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

const void* instance(bool vec) {
  return vec ? reinterpret_cast<const void*>(edge_dot_kernel<float4>)
             : reinterpret_cast<const void*>(edge_dot_kernel<float>);
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
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const bool vec = vectorized(x, y, hidden);
  int width = vec ? hidden / 4 : hidden;
  const int64_t warps = (static_cast<int64_t>(num_edges) + kEdges - 1) /
                        kEdges;
  const dim3 blocks(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  // The kernel's parameters by address; the pointers have the same size
  // and bits whatever V is.
  void* args[] = {&x, &a, &y, &b, &out, &num_edges, &rows_y, &width};
  cudaLaunchKernel(instance(vec), blocks, dim3(kWarpsPerBlock * kWarp), args,
                   0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// 1 if edge_dot_f32 takes the float4 path for these x and y, else 0.
extern "C" int edge_dot_vectorized(const void* x, const void* y,
                                   int hidden) {
  return vectorized(x, y, hidden) ? 1 : 0;
}

// The registers a thread of the float4 (vectorized_path != 0) or scalar
// instance uses, as the compiler allotted them, into *regs; returns the
// CUDA error code.
extern "C" int edge_dot_registers(int vectorized_path, int device,
                                  int* regs) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaFuncAttributes attr;
  const cudaError_t got = cudaFuncGetAttributes(&attr,
                                                instance(vectorized_path != 0));
  if (got != cudaSuccess) return static_cast<int>(got);
  *regs = attr.numRegs;
  return 0;
}
