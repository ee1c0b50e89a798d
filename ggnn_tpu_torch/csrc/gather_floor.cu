// Row gather, the gather-floor probe (B3):
//
//   out[r, :] = h[src[r], :]   for r in [0, num_rows)
//
//   h [NP, H] f32, src [NB * KE] int32 (the [NB, KE] id array, flat),
//   out [NB * KE, H] f32. Pure copy: no arithmetic, so a result equals
//   its plain version bit for bit.
//
// Replaces the Pallas TPU kernel `_gather_kernel`
// (benchmarks/probes/gather_floor.py:52), which keeps the whole table in
// VMEM and a block's KE ids in SMEM, one grid step per block, and copies
// `unroll` rows per loop body. That layout is not carried over: on
// Hopper the table (4 MiB at the probe's shape) does not fit in a
// block's 227 KB of shared memory, and blocks run in parallel, not in
// grid order. The table stays in the 50 MB L2 and is read with `__ldg`;
// each warp loads its own ids.
//
// What bounds it on the H100: bytes. It does no arithmetic at all; the
// least traffic is the output written once (100.7 MB at the probe's
// shape), the ids read once and each table row that some id names read
// once. The design keeps every byte moved to that least: one warp per
// output row, the lanes over its columns (float4 when H % 4 == 0 and
// h and out are 16-byte aligned, scalar otherwise), so each row is read
// and written as whole, coalesced lines; a warp owns 32 consecutive
// rows and loads their ids in one coalesced load, broadcasting each with
// a shuffle.
//
// The probe's question is the unroll. UNROLL (1, 4 or 8) is a template
// parameter: a warp issues the loads of UNROLL rows, independent of one
// another, before it stores any of them, so UNROLL row loads of a warp
// are in flight at once. If the warps on an SM already hide the load
// latency, the unroll moves nothing; if they do not (too few warps, as
// when the rows are few), it divides the latency the warp waits on.
// Registers grow with it (UNROLL float4 values a thread).
//
// The stores are the other question. STREAM (a template parameter too)
// stores with `__stcs`, the evict-first hint, so that the output, written
// once and not read again here, need not push the table's rows out of
// L2. On an H100 it is faster than plain stores at the probe's shape
// (a 100 MB output beside a 4 MiB table) and no faster where the output
// fits in L2 (PERF.md, Findings).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kWarp = 32;

// V is float or float4; `width` is the row length in units of V. A warp
// owns rows [first, first + 32); 32 is a multiple of every UNROLL, so a
// shuffle's source lane j + u stays below 32.
template <typename V, int UNROLL, bool STREAM>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
gather_rows_kernel(const V* __restrict__ h, const int* __restrict__ src,
                   V* __restrict__ out, int num_rows, int width) {
  const int lane = threadIdx.x % kWarp;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
       threadIdx.x / kWarp) * kWarp;
  // `first` is the same for all lanes of a warp, so the warp leaves
  // together and every shuffle below has its full warp.
  if (first >= num_rows) return;
  const int64_t left = num_rows - first;
  const int n = left < kWarp ? static_cast<int>(left) : kWarp;
  const int my_src = lane < n ? __ldg(src + first + lane) : 0;
  V* out_rows = out + first * width;
  for (int col0 = 0; col0 < width; col0 += kWarp) {
    const int col = col0 + lane;
    const bool active = col < width;
    for (int j = 0; j < n; j += UNROLL) {
      V v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = __shfl_sync(0xffffffffu, my_src, j + u);
        if (active && j + u < n) {
          v[u] = __ldg(h + static_cast<size_t>(row) * width + col);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (active && j + u < n) {
          V* dst = out_rows + static_cast<size_t>(j + u) * width + col;
          if (STREAM) {
            __stcs(dst, v[u]);
          } else {
            *dst = v[u];
          }
        }
      }
    }
  }
}

// The kernel instance for (V, STREAM) at `unroll`, or nullptr for an
// unroll that has none.
template <typename V, bool STREAM>
const void* instance_of(int unroll) {
  switch (unroll) {
    case 1:
      return reinterpret_cast<const void*>(gather_rows_kernel<V, 1, STREAM>);
    case 4:
      return reinterpret_cast<const void*>(gather_rows_kernel<V, 4, STREAM>);
    case 8:
      return reinterpret_cast<const void*>(gather_rows_kernel<V, 8, STREAM>);
    default:
      return nullptr;
  }
}

const void* instance(bool vec, bool streaming, int unroll) {
  if (vec) {
    return streaming ? instance_of<float4, true>(unroll)
                     : instance_of<float4, false>(unroll);
  }
  return streaming ? instance_of<float, true>(unroll)
                   : instance_of<float, false>(unroll);
}

bool vectorized(const void* h, const void* out, int hidden) {
  return hidden % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace

// Launches the kernel on `stream` of `device` and returns the CUDA error
// code (0 on success). This library links its own CUDA runtime, whose
// current device is not PyTorch's, so it is set here. The caller
// validates shapes, types and contiguity; num_rows and hidden are
// positive, and every id lies in [0, NP) (not checked here).
extern "C" int gather_rows_f32(const void* h, const void* src, void* out,
                               int num_rows, int hidden, int unroll,
                               int streaming, int device, void* stream) {
  const bool vec = vectorized(h, out, hidden);
  const void* fn = instance(vec, streaming != 0, unroll);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  int width = vec ? hidden / 4 : hidden;
  const int64_t warps = (static_cast<int64_t>(num_rows) + kWarp - 1) / kWarp;
  const dim3 blocks(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  // The kernel's parameters (const V*, const int*, V*, int, int) by
  // address; the pointers have the same size and bits whatever V is.
  void* args[] = {&h, &src, &out, &num_rows, &width};
  cudaLaunchKernel(fn, blocks, dim3(kWarpsPerBlock * kWarp), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// 1 if gather_rows_f32 takes the float4 path for these h and out, else 0.
extern "C" int gather_rows_vectorized(const void* h, const void* out,
                                      int hidden) {
  return vectorized(h, out, hidden) ? 1 : 0;
}

// The registers a thread of the (vectorized, unroll, streaming) instance
// uses, as the compiler allotted them, into *regs; returns the CUDA
// error code.
extern "C" int gather_rows_registers(int vectorized_path, int unroll,
                                     int streaming, int device, int* regs) {
  const void* fn = instance(vectorized_path != 0, streaming != 0, unroll);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaFuncAttributes attr;
  const cudaError_t got = cudaFuncGetAttributes(&attr, fn);
  if (got != cudaSuccess) return static_cast<int>(got);
  *regs = attr.numRegs;
  return 0;
}
