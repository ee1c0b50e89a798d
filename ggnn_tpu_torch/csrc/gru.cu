// The TF1 GRU cell's gate and update math, forward and backward, as four
// elementwise kernels around the cell's products (a port-only kernel
// set). With xs = x @ [Wg_x | Wc_x] ([N, 3H]: r, u and candidate
// columns), hg = h @ Ug and hc = rh @ Uc from cuBLAS:
//
//   K1 gru_gates:      g = sigmoid((xs[:, :2H] + hg) + b_g), g = [r | u];
//                      rh = r * h
//   K2 gru_update:     c = act((xs[:, 2H:] + hc) + b_c);
//                      h' = u * h + (1 - u) * c
//   K3 gru_update_bwd: from dh', u, h and c: da_c = dh' (1 - u) act'(c)
//                      into dxs[:, 2H:], da_u = (dh' h - dh' c)(1 - u) u
//                      into dxs[:, H:2H], dh = dh' u
//   K4 gru_gates_bwd:  from d(rh) = da_c @ Uc^T, h and r:
//                      da_r = (d(rh) h)(1 - r) r into dxs[:, :H];
//                      dh += d(rh) r
//
// act is tanh or relu (`make_cell` allows both for GRU). K3 and K4 also
// write each block's column sums of the da they write into one [B, 3H]
// buffer of partials (B the row blocks); the caller sums its rows, in a
// fixed order, into the biases' gradients. No atomics: two calls on the
// same inputs give the same bits, so replays stay bit-equal.
//
// It replaces no TPU kernel: the JAX package leaves this math to XLA,
// which fuses it into its products (`ggnn_tpu/ops/cells.py:gru_apply`,
// no Pallas kernel). Run op by op, as eager PyTorch and autograd do, it is
// some 31 elementwise passes a propagation step over [N, H] f32 tensors,
// ~98 tensor reads and writes; these four make 27 (K1 5 reads and 3
// writes, K2 4 and 2, K3 4 and 3, K4 4 and 2) in 4 launches.
//
// What bounds it on the H100: bytes. Each element takes a few operations
// for 20-40 bytes, far under the card's f32 ridge, so the least time is
// the bytes over 3.35 TB/s. At the sparse batch (100,000 rows, H = 100)
// each [N, H] tensor is 40 MB, so the tensors stream from device memory;
// at the dense batches (1,024-7,424 rows) the launch itself costs most.
//
// Design: a block is 8 rows of threads by up to 32 column units (a unit
// is a float4 where H % 4 == 0 and every row pointer is 16-byte aligned,
// else a float), so at H = 100 a block is 25 x 8 threads and a warp's
// loads are one row's 400 contiguous bytes and part of the next's. Each
// thread keeps one column unit and walks `rows_per_thread` rows 8 apart,
// loading kInFlight rows' operands before it computes any; wider rows
// take further column chunks as grid.y. The grid is the row count over 8
// x `rows_per_thread`, chosen by the caller from the row count and the
// SMs, so one design serves 100,000 rows and 1,024. The column sums of
// K3 and K4 are each thread's in row order, then the block's 8 row
// threads' in order through shared memory. The arithmetic keeps eager
// PyTorch's association, (xs + hU) + b and u h + (1 - u) c, each
// operation rounded on its own (`__fadd_rn`, `__fmul_rn`: no contraction
// into fused multiply-adds), with the accurate expf and tanhf (no
// --use_fast_math), in f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 8;   // blockDim.y
constexpr int kColThreads = 32;  // the most column units a block takes
constexpr int kInFlight = 4;     // rows a thread loads before computing

enum Act { kTanh = 0, kRelu = 1 };

// K floats of a row: a float4 (K = 4) or a float (K = 1).
template <int K>
struct Vec {
  float v[K];
};

template <int K>
__device__ __forceinline__ Vec<K> load(const float* p) {
  Vec<K> out;
  if constexpr (K == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out.v[0] = q.x;
    out.v[1] = q.y;
    out.v[2] = q.z;
    out.v[3] = q.w;
  } else {
    out.v[0] = __ldg(p);
  }
  return out;
}

// A load of data this launch also writes (dh in K4): no read-only path.
template <int K>
__device__ __forceinline__ Vec<K> load_rw(const float* p) {
  Vec<K> out;
  if constexpr (K == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out.v[0] = q.x;
    out.v[1] = q.y;
    out.v[2] = q.z;
    out.v[3] = q.w;
  } else {
    out.v[0] = *p;
  }
  return out;
}

template <int K>
__device__ __forceinline__ void store(float* p, const Vec<K>& a) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2],
                                                a.v[3]);
  } else {
    *p = a.v[0];
  }
}

// PyTorch's f32 sigmoid, 1 / (1 + exp(-a)), and the activations.
__device__ __forceinline__ float sigmoid(float a) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
}

template <int A>
__device__ __forceinline__ float act(float a) {
  if constexpr (A == kTanh) {
    return tanhf(a);
  } else {
    return a > 0.f ? a : 0.f;
  }
}

// The activation's backward from its output y, as PyTorch's
// tanh_backward, g (1 - y y), and threshold_backward, 0 where y <= 0.
template <int A>
__device__ __forceinline__ float act_bwd(float g, float y) {
  if constexpr (A == kTanh) {
    return __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(y, y)));
  } else {
    return y <= 0.f ? 0.f : g;
  }
}

// The rows this thread takes: first, first + 8, ..., below `end`.
struct Rows {
  int64_t first;
  int64_t end;
  int count;
};

__device__ __forceinline__ Rows my_rows(int64_t num_rows,
                                        int rows_per_thread) {
  const int64_t block_first =
      static_cast<int64_t>(blockIdx.x) * kRowThreads * rows_per_thread;
  Rows rows;
  rows.first = block_first + threadIdx.y;
  const int64_t block_end = block_first + kRowThreads * rows_per_thread;
  rows.end = block_end < num_rows ? block_end : num_rows;
  rows.count = 0;
  if (rows.first < rows.end) {
    rows.count = static_cast<int>((rows.end - rows.first + kRowThreads - 1) /
                                  kRowThreads);
  }
  return rows;
}

// K1: g = sigmoid((xs[:, :2H] + hg) + b_g), rh = r * h.
template <int K>
__global__ void __launch_bounds__(kRowThreads * kColThreads)
gru_gates_kernel(const float* __restrict__ xs, const float* __restrict__ hg,
                 const float* __restrict__ bias, const float* __restrict__ h,
                 float* __restrict__ g, float* __restrict__ rh,
                 int64_t num_rows, int hidden, int rows_per_thread) {
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * K;
  if (col >= hidden) return;
  const Rows rows = my_rows(num_rows, rows_per_thread);
  const Vec<K> br = load<K>(bias + col);
  const Vec<K> bu = load<K>(bias + hidden + col);
  const int64_t h3 = 3 * static_cast<int64_t>(hidden);
  const int64_t h2 = 2 * static_cast<int64_t>(hidden);
  for (int k0 = 0; k0 < rows.count; k0 += kInFlight) {
    Vec<K> xr[kInFlight], xu[kInFlight], hr[kInFlight], hu[kInFlight],
        hv[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k0 + k < rows.count) {
        const int64_t row = rows.first + (k0 + k) * kRowThreads;
        xr[k] = load<K>(xs + row * h3 + col);
        xu[k] = load<K>(xs + row * h3 + hidden + col);
        hr[k] = load<K>(hg + row * h2 + col);
        hu[k] = load<K>(hg + row * h2 + hidden + col);
        hv[k] = load<K>(h + row * hidden + col);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k0 + k < rows.count) {
        const int64_t row = rows.first + (k0 + k) * kRowThreads;
        Vec<K> r, u, out;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          r.v[i] = sigmoid(__fadd_rn(__fadd_rn(xr[k].v[i], hr[k].v[i]),
                                     br.v[i]));
          u.v[i] = sigmoid(__fadd_rn(__fadd_rn(xu[k].v[i], hu[k].v[i]),
                                     bu.v[i]));
          out.v[i] = __fmul_rn(r.v[i], hv[k].v[i]);
        }
        store<K>(g + row * h2 + col, r);
        store<K>(g + row * h2 + hidden + col, u);
        store<K>(rh + row * hidden + col, out);
      }
    }
  }
}

// K2: c = act((xs[:, 2H:] + hc) + b_c), h' = u * h + (1 - u) * c.
template <int K, int A>
__global__ void __launch_bounds__(kRowThreads * kColThreads)
gru_update_kernel(const float* __restrict__ xs, const float* __restrict__ hc,
                  const float* __restrict__ bias,
                  const float* __restrict__ g, const float* __restrict__ h,
                  float* __restrict__ c, float* __restrict__ h_new,
                  int64_t num_rows, int hidden, int rows_per_thread) {
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * K;
  if (col >= hidden) return;
  const Rows rows = my_rows(num_rows, rows_per_thread);
  const Vec<K> bc = load<K>(bias + col);
  const int64_t h3 = 3 * static_cast<int64_t>(hidden);
  const int64_t h2 = 2 * static_cast<int64_t>(hidden);
  for (int k0 = 0; k0 < rows.count; k0 += kInFlight) {
    Vec<K> xc[kInFlight], hcv[kInFlight], uv[kInFlight], hv[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k0 + k < rows.count) {
        const int64_t row = rows.first + (k0 + k) * kRowThreads;
        xc[k] = load<K>(xs + row * h3 + 2 * hidden + col);
        hcv[k] = load<K>(hc + row * hidden + col);
        uv[k] = load<K>(g + row * h2 + hidden + col);
        hv[k] = load<K>(h + row * hidden + col);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k0 + k < rows.count) {
        const int64_t row = rows.first + (k0 + k) * kRowThreads;
        Vec<K> cv, out;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          cv.v[i] = act<A>(__fadd_rn(__fadd_rn(xc[k].v[i], hcv[k].v[i]),
                                     bc.v[i]));
          const float u = uv[k].v[i];
          out.v[i] = __fadd_rn(__fmul_rn(u, hv[k].v[i]),
                               __fmul_rn(__fsub_rn(1.f, u), cv.v[i]));
        }
        store<K>(c + row * hidden + col, cv);
        store<K>(h_new + row * hidden + col, out);
      }
    }
  }
}

// The block's column sums of N values a thread (`sums`), written to
// partials[blockIdx.x, offset[j] + col]: each row thread's in row order,
// then the 8 row threads' in order. Every thread of the block calls it
// (it holds a barrier); a thread past the row (`live` false) writes none.
template <int K, int N>
__device__ __forceinline__ void block_column_sums(
    const float (&sums)[N][K], float* __restrict__ partials,
    int64_t stride, const int (&offset)[N], int col, bool live) {
  __shared__ float staged[N][kRowThreads][kColThreads * 4];
  const int unit = threadIdx.x * K;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < K; ++i) staged[j][threadIdx.y][unit + i] = sums[j][i];
  }
  __syncthreads();
  if (threadIdx.y != 0 || !live) return;
  float* out = partials + blockIdx.x * stride + col;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float total = staged[j][0][unit + i];
#pragma unroll
      for (int y = 1; y < kRowThreads; ++y) {
        total = __fadd_rn(total, staged[j][y][unit + i]);
      }
      out[offset[j] + i] = total;
    }
  }
}

// K3: da_u into dxs[:, H:2H], da_c into dxs[:, 2H:], dh = dh' * u, and
// the block's column sums of da_u and da_c into partials[:, H:3H].
template <int K, int A>
__global__ void __launch_bounds__(kRowThreads * kColThreads)
gru_update_bwd_kernel(const float* __restrict__ dh_new,
                      const float* __restrict__ g,
                      const float* __restrict__ h,
                      const float* __restrict__ c, float* __restrict__ dxs,
                      float* __restrict__ dh, float* __restrict__ partials,
                      int64_t num_rows, int hidden, int rows_per_thread) {
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * K;
  const bool live = col < hidden;
  const Rows rows = my_rows(num_rows, rows_per_thread);
  const int count = live ? rows.count : 0;
  const int64_t h3 = 3 * static_cast<int64_t>(hidden);
  const int64_t h2 = 2 * static_cast<int64_t>(hidden);
  float sums[2][K];
#pragma unroll
  for (int i = 0; i < K; ++i) sums[0][i] = sums[1][i] = 0.f;
  for (int k0 = 0; k0 < count; k0 += kInFlight) {
    Vec<K> dn[kInFlight], uv[kInFlight], hv[kInFlight], cv[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k0 + k < count) {
        const int64_t row = rows.first + (k0 + k) * kRowThreads;
        dn[k] = load<K>(dh_new + row * hidden + col);
        uv[k] = load<K>(g + row * h2 + hidden + col);
        hv[k] = load<K>(h + row * hidden + col);
        cv[k] = load<K>(c + row * hidden + col);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k0 + k < count) {
        const int64_t row = rows.first + (k0 + k) * kRowThreads;
        Vec<K> dau, dac, dhv;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const float d = dn[k].v[i], u = uv[k].v[i];
          const float du = __fsub_rn(__fmul_rn(d, hv[k].v[i]),
                                     __fmul_rn(d, cv[k].v[i]));
          dau.v[i] = __fmul_rn(__fmul_rn(du, __fsub_rn(1.f, u)), u);
          dac.v[i] = act_bwd<A>(__fmul_rn(d, __fsub_rn(1.f, u)), cv[k].v[i]);
          dhv.v[i] = __fmul_rn(d, u);
          sums[0][i] = __fadd_rn(sums[0][i], dau.v[i]);
          sums[1][i] = __fadd_rn(sums[1][i], dac.v[i]);
        }
        store<K>(dxs + row * h3 + hidden + col, dau);
        store<K>(dxs + row * h3 + 2 * hidden + col, dac);
        store<K>(dh + row * hidden + col, dhv);
      }
    }
  }
  const int offset[2] = {hidden, 2 * hidden};
  block_column_sums<K, 2>(sums, partials, h3, offset, col, live);
}

// K4: da_r = (d(rh) h)(1 - r) r into dxs[:, :H], dh += d(rh) r, and the
// block's column sums of da_r into partials[:, :H].
template <int K>
__global__ void __launch_bounds__(kRowThreads * kColThreads)
gru_gates_bwd_kernel(const float* __restrict__ drh,
                     const float* __restrict__ h,
                     const float* __restrict__ g, float* __restrict__ dxs,
                     float* dh, float* __restrict__ partials,
                     int64_t num_rows, int hidden, int rows_per_thread) {
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * K;
  const bool live = col < hidden;
  const Rows rows = my_rows(num_rows, rows_per_thread);
  const int count = live ? rows.count : 0;
  const int64_t h3 = 3 * static_cast<int64_t>(hidden);
  const int64_t h2 = 2 * static_cast<int64_t>(hidden);
  float sums[1][K];
#pragma unroll
  for (int i = 0; i < K; ++i) sums[0][i] = 0.f;
  for (int k0 = 0; k0 < count; k0 += kInFlight) {
    Vec<K> dv[kInFlight], hv[kInFlight], rv[kInFlight], dhv[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k0 + k < count) {
        const int64_t row = rows.first + (k0 + k) * kRowThreads;
        dv[k] = load<K>(drh + row * hidden + col);
        hv[k] = load<K>(h + row * hidden + col);
        rv[k] = load<K>(g + row * h2 + col);
        dhv[k] = load_rw<K>(dh + row * hidden + col);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k0 + k < count) {
        const int64_t row = rows.first + (k0 + k) * kRowThreads;
        Vec<K> dar, out;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const float d = dv[k].v[i], r = rv[k].v[i];
          dar.v[i] = __fmul_rn(
              __fmul_rn(__fmul_rn(d, hv[k].v[i]), __fsub_rn(1.f, r)), r);
          out.v[i] = __fadd_rn(dhv[k].v[i], __fmul_rn(d, r));
          sums[0][i] = __fadd_rn(sums[0][i], dar.v[i]);
        }
        store<K>(dxs + row * h3 + col, dar);
        store<K>(dh + row * hidden + col, out);
      }
    }
  }
  const int offset[1] = {0};
  block_column_sums<K, 1>(sums, partials, h3, offset, col, live);
}

// The launch shape the caller planned (`ops/kernels/gru.py:launch_plan`).
struct Plan {
  dim3 blocks;
  dim3 threads;
  int64_t rows;
  int hidden;
  int rows_per_thread;
};

Plan plan(int64_t rows, int hidden, int col_threads, int col_chunks,
          int row_blocks, int rows_per_thread) {
  return Plan{dim3(static_cast<unsigned>(row_blocks),
                   static_cast<unsigned>(col_chunks)),
              dim3(static_cast<unsigned>(col_threads), kRowThreads), rows,
              hidden, rows_per_thread};
}

int set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each entry point launches one kernel on `stream` of `device` and
// returns the CUDA error code (0 on success). This library links its own
// CUDA runtime, whose current device is not PyTorch's, so it is set here.
// The caller validates dtypes, shapes and contiguity, plans the launch
// (`vec` 4 only where H % 4 == 0 and every pointer is 16-byte aligned;
// col_threads <= 32) and launches nothing for zero rows. act: 0 tanh,
// 1 relu. Tensors, all f32 and contiguous: xs [N, 3H], hg and g
// [N, 2H], bias [2H] (K1) or [H] (K2), every other [N, H]; dxs [N, 3H]
// and partials [row_blocks, 3H].

extern "C" int gru_gates_f32(const float* xs, const float* hg,
                             const float* bias, const float* h, float* g,
                             float* rh, int64_t rows, int hidden, int vec,
                             int col_threads, int col_chunks, int row_blocks,
                             int rows_per_thread, int device, void* stream) {
  const int set = set_device(device);
  if (set != 0) return set;
  const Plan p = plan(rows, hidden, col_threads, col_chunks, row_blocks,
                      rows_per_thread);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    gru_gates_kernel<4><<<p.blocks, p.threads, 0, s>>>(
        xs, hg, bias, h, g, rh, p.rows, p.hidden, p.rows_per_thread);
  } else {
    gru_gates_kernel<1><<<p.blocks, p.threads, 0, s>>>(
        xs, hg, bias, h, g, rh, p.rows, p.hidden, p.rows_per_thread);
  }
  return last_error();
}

extern "C" int gru_update_f32(const float* xs, const float* hc,
                              const float* bias, const float* g,
                              const float* h, float* c, float* h_new,
                              int64_t rows, int hidden, int act, int vec,
                              int col_threads, int col_chunks,
                              int row_blocks, int rows_per_thread,
                              int device, void* stream) {
  const int set = set_device(device);
  if (set != 0) return set;
  const Plan p = plan(rows, hidden, col_threads, col_chunks, row_blocks,
                      rows_per_thread);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRU_UPDATE(K, A)                                             \
  gru_update_kernel<K, A><<<p.blocks, p.threads, 0, s>>>(            \
      xs, hc, bias, g, h, c, h_new, p.rows, p.hidden, p.rows_per_thread)
  if (vec == 4) {
    if (act == kTanh) GRU_UPDATE(4, kTanh); else GRU_UPDATE(4, kRelu);
  } else {
    if (act == kTanh) GRU_UPDATE(1, kTanh); else GRU_UPDATE(1, kRelu);
  }
#undef GRU_UPDATE
  return last_error();
}

extern "C" int gru_update_bwd_f32(const float* dh_new, const float* g,
                                  const float* h, const float* c,
                                  float* dxs, float* dh, float* partials,
                                  int64_t rows, int hidden, int act,
                                  int vec, int col_threads, int col_chunks,
                                  int row_blocks, int rows_per_thread,
                                  int device, void* stream) {
  const int set = set_device(device);
  if (set != 0) return set;
  const Plan p = plan(rows, hidden, col_threads, col_chunks, row_blocks,
                      rows_per_thread);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRU_UPDATE_BWD(K, A)                                          \
  gru_update_bwd_kernel<K, A><<<p.blocks, p.threads, 0, s>>>(         \
      dh_new, g, h, c, dxs, dh, partials, p.rows, p.hidden,           \
      p.rows_per_thread)
  if (vec == 4) {
    if (act == kTanh) GRU_UPDATE_BWD(4, kTanh); else GRU_UPDATE_BWD(4, kRelu);
  } else {
    if (act == kTanh) GRU_UPDATE_BWD(1, kTanh); else GRU_UPDATE_BWD(1, kRelu);
  }
#undef GRU_UPDATE_BWD
  return last_error();
}

extern "C" int gru_gates_bwd_f32(const float* drh, const float* h,
                                 const float* g, float* dxs, float* dh,
                                 float* partials, int64_t rows, int hidden,
                                 int vec, int col_threads, int col_chunks,
                                 int row_blocks, int rows_per_thread,
                                 int device, void* stream) {
  const int set = set_device(device);
  if (set != 0) return set;
  const Plan p = plan(rows, hidden, col_threads, col_chunks, row_blocks,
                      rows_per_thread);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    gru_gates_bwd_kernel<4><<<p.blocks, p.threads, 0, s>>>(
        drh, h, g, dxs, dh, partials, p.rows, p.hidden, p.rows_per_thread);
  } else {
    gru_gates_bwd_kernel<1><<<p.blocks, p.threads, 0, s>>>(
        drh, h, g, dxs, dh, partials, p.rows, p.hidden, p.rows_per_thread);
  }
  return last_error();
}
