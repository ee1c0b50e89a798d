// Ragged all-to-all of boundary rows over peer memory: the node-sharded
// mesh's "ragged" boundary exchange on an NVLink-connected group of
// cards, one rank a card.
//
// Replaces XLA's `jax.lax.ragged_all_to_all` at
// ggnn_tpu/parallel/node_shard.py:508 (no Pallas kernel). No torch or
// NCCL collective takes its split sizes on the device: `all_to_all_single`
// wants them as host integers, so a step that used it would need a CUDA
// graph for every batch. Here each rank reads its own routing rows on the
// card, so one captured graph replays every batch of a stack shape.
//
// What it computes, for rank `me` of S (its rows of a RaggedSendSpec:
// gather [SEND_CAP], input_offsets / send_sizes / output_offsets /
// recv_sizes [S], int32):
//
//   forward:  table_d[output_offsets[me,d] + i] = h[gather[input_offsets
//             [me,d] + i]] for i < send_sizes[me,d], every peer d; rows
//             [sum recv_sizes[me], recv_cap) of this rank's table zero,
//             as JAX's `out = jnp.zeros(...)`;
//   backward: pack[input_offsets[me,d] + i] = g_d[output_offsets[me,d] + i]
//             (the owner pulls its cotangent slices from each peer), the
//             other pack rows zero. The pack's gradient reaches h through
//             the gather's transpose, a sorted sum outside this file.
//
// The slices land owner-major from row 0 and tile [0, sum recv_sizes),
// as `_materialize_sends` lays them out: the copy-out reads that prefix of
// the receive buffer. The kernels copy bytes (rows of `row_bytes`, in
// 16-, 4- or 2-byte units), so one instance serves f32 and bf16 rows and
// a result equals its plain version bit for bit. Routing rows are not
// checked: rows outside a buffer are the layout's fault, as an id outside
// h is B3's caller's.
//
// Memory. Every rank owns one region (cudaMalloc, exported to its peers
// as a CUDA IPC handle by the Python side; `rx_region_alloc`): a header of
// signal flags and round counters, then four buffers of `buffer_bytes`:
// (channel 0 forward, channel 1 backward) x (round parity 0, 1). Peers
// write into a region's forward buffers and read its backward buffers
// over NVLink; `peers` is a device array of the S regions' addresses in
// this process.
//
// Signals count on the device. Each channel is a sequence of rounds that
// every rank runs in the same order. A rank's round counter
// (header.round[c], bumped by its own wait or pull kernel) gives the
// round e = round + 1; a signal is the store of e into the peer's
// header.flag[c][me] (st.release.sys after a system fence), and a wait
// spins until flag[c][src] >= e (ld.acquire.sys). Flags only grow, so a
// replayed graph never sees a stale one, and a capture (which runs
// nothing) leaves none set.
//
// Buffer reuse: two buffers a channel, alternated by round parity, and
// no entry barrier. A rank writes into a peer's buffer of parity e % 2
// in round e only after its wait of round e - 1 saw every peer's signal
// of e - 1, which each peer sent after its own copy-out of round e - 2
// (stream order); so the buffer's previous contents were consumed. The
// backward channel is the same with the roles turned: a peer overwrites
// its buffer of parity e % 2 (publish, round e + 2) only after its pull
// of e + 1 saw this rank's signal of e + 1, sent after this rank's pull
// of round e.
//
// Split put from wait: `rx_put` writes and signals, `rx_wait` waits and
// copies out (`rx_publish` / `rx_pull` backward). One process can so
// stand in for S ranks on one card (S puts, then S waits, on one
// stream). Two processes on one card cannot run it: without MPS their
// kernels time-slice, and one rank's spin can starve the other's put.
//
// Waits are bounded: a spin that outlives its budget (clock64 cycles
// for `seconds` at the card's clock rate) writes a code naming the
// channel, the rank and the peer it waited for into a mapped host word
// (`rx_status`) and traps, so a rank that never arrives becomes an error
// at the next synchronise, not a hang.
//
// What bounds it on the H100: bytes, and at the shapes of the 20k-node
// batch latency. A rank moves sum_d send_sizes[me,d] rows to its peers
// over NVLink (450 GB/s each way) and reads them from h (3.35 TB/s);
// the copy-out reads sum recv_sizes rows and writes recv_cap. A
// molecular batch cuts a few dozen rows a pair, so the exchange is a
// put, a signal's round trip over NVLink and a copy-out: two launches
// and microseconds, far above its byte bound. The design is the simple
// one: a block a destination for the put (a warp a row); the wait and
// the pull over up to 64 blocks, each of which polls the flags and moves
// its share, the last to finish ending the round (every block has read
// the round counter before it); one block for the publish, which copies
// only the received rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr size_t kHeaderBytes = 4096;
constexpr int kThreads = 512;
constexpr int kWarp = 32;

struct Header {
  unsigned long long flag[2][kMaxRanks];   // written by the peers
  unsigned long long round[2];             // this rank's rounds done
  unsigned int done[2];     // blocks of the round's wait / pull finished
};

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ Header* header_of(
    const unsigned long long* peers, int rank) {
  return reinterpret_cast<Header*>(peers[rank]);
}

// The buffer of `channel` for round parity `parity` in rank's region.
template <typename V>
__device__ __forceinline__ V* buffer_of(const unsigned long long* peers,
                                        int rank, int channel, int parity,
                                        size_t buffer_bytes) {
  return reinterpret_cast<V*>(peers[rank] + kHeaderBytes +
                              (2 * channel + parity) * buffer_bytes);
}

// Thread 0..S-1 (but `me`) waits for peer `threadIdx.x`'s signal of round
// e on `channel`; the block then goes on together.
__device__ void wait_for_peers(Header* mine, int channel, int me, int S,
                               unsigned long long e, long long budget,
                               int* status) {
  const int src = threadIdx.x;
  if (src < S && src != me) {
    const long long start = clock64();
    while (load_acquire_sys(&mine->flag[channel][src]) < e) {
      if (clock64() - start > budget) {
        *reinterpret_cast<volatile int*>(status) =
            (1 << 16) | (channel << 8) | (me << 4) | src;
        __threadfence_system();
        __trap();
      }
      __nanosleep(128);
    }
  }
  __syncthreads();
}

// The end of a round on `channel`, in a kernel of several blocks: the
// last block to finish bumps the round counter (every block read it
// before it finished) and resets the block count.
__device__ void end_round(Header* mine, int channel, unsigned long long e) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&mine->done[channel], 1u) == gridDim.x - 1) {
      mine->done[channel] = 0;
      mine->round[channel] = e;
    }
  }
}

// Forward put: block d copies this rank's rows for peer d into d's
// forward buffer of this round's parity, then signals d.
template <typename V>
__global__ void __launch_bounds__(kThreads)
put_kernel(const V* __restrict__ h, const int* __restrict__ gather,
           const int* __restrict__ in_off, const int* __restrict__ send,
           const int* __restrict__ out_off, const unsigned long long* peers,
           int me, int S, int width, size_t buffer_bytes) {
  const int d = blockIdx.x;
  if (d == me) return;
  const unsigned long long e = header_of(peers, me)->round[0] + 1;
  V* dst = buffer_of<V>(peers, d, 0, static_cast<int>(e & 1), buffer_bytes);
  const int n = send[d];
  const int first = in_off[d];
  const int at = out_off[d];
  const int lane = threadIdx.x % kWarp;
  for (int r = threadIdx.x / kWarp; r < n; r += kThreads / kWarp) {
    const V* row = h + static_cast<int64_t>(__ldg(gather + first + r)) * width;
    V* out = dst + static_cast<int64_t>(at + r) * width;
    for (int c = lane; c < width; c += kWarp) out[c] = __ldg(row + c);
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) store_release_sys(&header_of(peers, d)->flag[0][me], e);
}

// Forward wait: every block waits for every peer's put of this round,
// then the blocks copy rows [0, sum recv_sizes) of the buffer into the
// table and zero the rest; the last block ends the round.
template <typename V>
__global__ void __launch_bounds__(kThreads)
wait_kernel(V* __restrict__ out, const int* __restrict__ recv_sizes,
            int recv_cap, const unsigned long long* peers, int me, int S,
            int width, size_t buffer_bytes, long long budget, int* status) {
  Header* mine = header_of(peers, me);
  const unsigned long long e = mine->round[0] + 1;
  wait_for_peers(mine, 0, me, S, e, budget, status);
  int n = 0;
  for (int s = 0; s < S; ++s) n += recv_sizes[s];
  const V* src = buffer_of<V>(peers, me, 0, static_cast<int>(e & 1),
                              buffer_bytes);
  const int64_t filled = static_cast<int64_t>(n) * width;
  const int64_t total = static_cast<int64_t>(recv_cap) * width;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * kThreads)
    out[i] = i < filled ? __ldcg(src + i) : V{};
  end_round(mine, 0, e);
}

// Backward publish: one block; copies this rank's table cotangent rows
// [0, sum recv_sizes) into its own backward buffer of this round's
// parity, then signals every peer.
template <typename V>
__global__ void __launch_bounds__(kThreads)
publish_kernel(const V* __restrict__ g, const int* __restrict__ recv_sizes,
               const unsigned long long* peers, int me, int S, int width,
               size_t buffer_bytes) {
  const unsigned long long e = header_of(peers, me)->round[1] + 1;
  int n = 0;
  for (int s = 0; s < S; ++s) n += recv_sizes[s];
  V* dst = buffer_of<V>(peers, me, 1, static_cast<int>(e & 1), buffer_bytes);
  const int64_t total = static_cast<int64_t>(n) * width;
  for (int64_t i = threadIdx.x; i < total; i += kThreads) dst[i] = g[i];
  __threadfence_system();
  __syncthreads();
  const int d = threadIdx.x;
  if (d < S && d != me) store_release_sys(&header_of(peers, d)->flag[1][me], e);
}

// Backward pull: every block waits for every peer's publish of this
// round, then the blocks fill the pack, a warp a row: row
// input_offsets[me,d] + i from peer d's backward buffer at
// output_offsets[me,d] + i (i < send_sizes[me,d]), every other row zero;
// the last block ends the round.
template <typename V>
__global__ void __launch_bounds__(kThreads)
pull_kernel(V* __restrict__ pack, int send_cap, const int* __restrict__ in_off,
            const int* __restrict__ send, const int* __restrict__ out_off,
            const unsigned long long* peers, int me, int S, int width,
            size_t buffer_bytes, long long budget, int* status) {
  __shared__ int first[kMaxRanks], count[kMaxRanks], at[kMaxRanks];
  Header* mine = header_of(peers, me);
  const unsigned long long e = mine->round[1] + 1;
  if (threadIdx.x < S) {
    const int d = threadIdx.x;
    first[d] = in_off[d];
    count[d] = d == me ? 0 : send[d];
    at[d] = out_off[d];
  }
  wait_for_peers(mine, 1, me, S, e, budget, status);
  const int parity = static_cast<int>(e & 1);
  const int lane = threadIdx.x % kWarp;
  const int warps = kThreads / kWarp;
  for (int r = blockIdx.x * warps + threadIdx.x / kWarp; r < send_cap;
       r += gridDim.x * warps) {
    const V* row = nullptr;
    for (int d = 0; d < S; ++d) {
      const int k = r - first[d];
      if (k >= 0 && k < count[d])
        row = buffer_of<V>(peers, d, 1, parity, buffer_bytes) +
              static_cast<int64_t>(at[d] + k) * width;
    }
    V* out = pack + static_cast<int64_t>(r) * width;
    for (int c = lane; c < width; c += kWarp)
      out[c] = row != nullptr ? __ldcg(row + c) : V{};
  }
  end_round(mine, 1, e);
}

// The copy unit: 16 bytes where the row length and every row start
// allow it (buffers start 256-byte aligned), else 4, else 2.
int unit_bytes(int row_bytes, const void* a, const void* b) {
  const uintptr_t both = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  if (row_bytes % 16 == 0 && both % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && both % 4 == 0) return 4;
  return 2;
}

// The card's clock rate in kHz, read once a device (the query is slow).
int g_khz[64] = {0};

long long budget_cycles(int device, double seconds) {
  if (device < 0 || device >= 64) device = 0;
  if (g_khz[device] <= 0) {
    int khz = 0;
    if (cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device) !=
            cudaSuccess ||
        khz <= 0)
      khz = 2000000;
    g_khz[device] = khz;
  }
  return static_cast<long long>(seconds * 1e3 * g_khz[device]);
}

// Blocks of a wait or pull over `units` copy units: enough that each
// thread moves a few, at most kMaxBlocks.
constexpr int kMaxBlocks = 64;

int blocks_for(int64_t units) {
  const int64_t per = static_cast<int64_t>(kThreads) * 4;
  const int64_t b = (units + per - 1) / per;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

int* g_status = nullptr;   // mapped host word, device address == host

int status_word(int** out) {
  if (g_status == nullptr) {
    void* p = nullptr;
    const cudaError_t got = cudaHostAlloc(
        &p, sizeof(int), cudaHostAllocMapped | cudaHostAllocPortable);
    if (got != cudaSuccess) return static_cast<int>(got);
    *static_cast<int*>(p) = 0;
    g_status = static_cast<int*>(p);
  }
  *out = g_status;
  return 0;
}

int check_args(int S, int me, int row_bytes) {
  if (S < 1 || S > kMaxRanks || me < 0 || me >= S || row_bytes <= 0 ||
      row_bytes % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// A region of kHeaderBytes + 4 * buffer_bytes bytes on `device`, zeroed
// (flags and round counters 0), into *ptr; with `handle` non-null its
// CUDA IPC handle (64 bytes) too. Returns the CUDA error code.
extern "C" int rx_region_alloc(size_t buffer_bytes, int device, void** ptr,
                               void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = kHeaderBytes + 4 * buffer_bytes;
  void* p = nullptr;
  err = cudaMalloc(&p, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(p, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess && handle != nullptr) {
    cudaIpcMemHandle_t h;
    err = cudaIpcGetMemHandle(&h, p);
    if (err == cudaSuccess) {
      const char* src = reinterpret_cast<const char*>(&h);
      char* dst = static_cast<char*>(handle);
      for (size_t i = 0; i < sizeof(h); ++i) dst[i] = src[i];
    }
  }
  if (err != cudaSuccess) {
    cudaFree(p);
    return static_cast<int>(err);
  }
  *ptr = p;
  return 0;
}

// A peer's region, from its IPC handle, mapped into this process.
extern "C" int rx_region_open(const void* handle, int device, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  const char* src = static_cast<const char*>(handle);
  char* dst = reinterpret_cast<char*>(&h);
  for (size_t i = 0; i < sizeof(h); ++i) dst[i] = src[i];
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int rx_handle_bytes(void) {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// The code a timed-out wait left (0 when none): 1 << 16 | channel << 8 |
// rank << 4 | the peer waited for.
extern "C" int rx_status(void) {
  int* word = nullptr;
  if (status_word(&word) != 0) return -1;
  return *reinterpret_cast<volatile int*>(word);
}

extern "C" int rx_put(const void* h, const void* gather, const void* in_off,
                      const void* send, const void* out_off,
                      const void* peers, int me, int S, int row_bytes,
                      size_t buffer_bytes, int device, void* stream) {
  int bad = check_args(S, me, row_bytes);
  if (bad != 0) return bad;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto* table = static_cast<const unsigned long long*>(peers);
  const auto s = static_cast<cudaStream_t>(stream);
  const int unit = unit_bytes(row_bytes, h, nullptr);
  const int width = row_bytes / unit;
  const auto* g = static_cast<const int*>(gather);
  const auto* io = static_cast<const int*>(in_off);
  const auto* sz = static_cast<const int*>(send);
  const auto* oo = static_cast<const int*>(out_off);
  if (unit == 16)
    put_kernel<uint4><<<S, kThreads, 0, s>>>(static_cast<const uint4*>(h), g,
                                             io, sz, oo, table, me, S, width,
                                             buffer_bytes);
  else if (unit == 4)
    put_kernel<unsigned int><<<S, kThreads, 0, s>>>(
        static_cast<const unsigned int*>(h), g, io, sz, oo, table, me, S,
        width, buffer_bytes);
  else
    put_kernel<unsigned short><<<S, kThreads, 0, s>>>(
        static_cast<const unsigned short*>(h), g, io, sz, oo, table, me, S,
        width, buffer_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rx_wait(void* out, const void* recv_sizes, int recv_cap,
                       const void* peers, int me, int S, int row_bytes,
                       size_t buffer_bytes, double seconds, int device,
                       void* stream) {
  int bad = check_args(S, me, row_bytes);
  if (bad != 0) return bad;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  int* status = nullptr;
  bad = status_word(&status);
  if (bad != 0) return bad;
  const auto* table = static_cast<const unsigned long long*>(peers);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long budget = budget_cycles(device, seconds);
  const auto* rs = static_cast<const int*>(recv_sizes);
  const int unit = unit_bytes(row_bytes, out, nullptr);
  const int width = row_bytes / unit;
  const int grid = blocks_for(static_cast<int64_t>(recv_cap) * width);
  if (unit == 16)
    wait_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<uint4*>(out), rs, recv_cap, table, me, S, width,
        buffer_bytes, budget, status);
  else if (unit == 4)
    wait_kernel<unsigned int><<<grid, kThreads, 0, s>>>(
        static_cast<unsigned int*>(out), rs, recv_cap, table, me, S, width,
        buffer_bytes, budget, status);
  else
    wait_kernel<unsigned short><<<grid, kThreads, 0, s>>>(
        static_cast<unsigned short*>(out), rs, recv_cap, table, me, S, width,
        buffer_bytes, budget, status);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rx_publish(const void* g, const void* recv_sizes,
                          const void* peers, int me, int S, int row_bytes,
                          size_t buffer_bytes, int device, void* stream) {
  int bad = check_args(S, me, row_bytes);
  if (bad != 0) return bad;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto* table = static_cast<const unsigned long long*>(peers);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rs = static_cast<const int*>(recv_sizes);
  const int unit = unit_bytes(row_bytes, g, nullptr);
  const int width = row_bytes / unit;
  if (unit == 16)
    publish_kernel<uint4><<<1, kThreads, 0, s>>>(
        static_cast<const uint4*>(g), rs, table, me, S, width, buffer_bytes);
  else if (unit == 4)
    publish_kernel<unsigned int><<<1, kThreads, 0, s>>>(
        static_cast<const unsigned int*>(g), rs, table, me, S, width,
        buffer_bytes);
  else
    publish_kernel<unsigned short><<<1, kThreads, 0, s>>>(
        static_cast<const unsigned short*>(g), rs, table, me, S, width,
        buffer_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rx_pull(void* pack, int send_cap, const void* in_off,
                       const void* send, const void* out_off,
                       const void* peers, int me, int S, int row_bytes,
                       size_t buffer_bytes, double seconds, int device,
                       void* stream) {
  int bad = check_args(S, me, row_bytes);
  if (bad != 0) return bad;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  int* status = nullptr;
  bad = status_word(&status);
  if (bad != 0) return bad;
  const auto* table = static_cast<const unsigned long long*>(peers);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long budget = budget_cycles(device, seconds);
  const auto* io = static_cast<const int*>(in_off);
  const auto* sz = static_cast<const int*>(send);
  const auto* oo = static_cast<const int*>(out_off);
  const int unit = unit_bytes(row_bytes, pack, nullptr);
  const int width = row_bytes / unit;
  const int grid = blocks_for(static_cast<int64_t>(send_cap) * width);
  if (unit == 16)
    pull_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<uint4*>(pack), send_cap, io, sz, oo, table, me, S, width,
        buffer_bytes, budget, status);
  else if (unit == 4)
    pull_kernel<unsigned int><<<grid, kThreads, 0, s>>>(
        static_cast<unsigned int*>(pack), send_cap, io, sz, oo, table, me, S,
        width, buffer_bytes, budget, status);
  else
    pull_kernel<unsigned short><<<grid, kThreads, 0, s>>>(
        static_cast<unsigned short*>(pack), send_cap, io, sz, oo, table, me,
        S, width, buffer_bytes, budget, status);
  return static_cast<int>(cudaGetLastError());
}
