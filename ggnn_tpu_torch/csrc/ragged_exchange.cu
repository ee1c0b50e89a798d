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
//             for i < send_sizes[me,d], the other pack rows zero. The
//             pack's gradient reaches h through the gather's transpose,
//             a sorted sum outside this file.
//
// The slices land owner-major from row 0 and tile [0, sum recv_sizes),
// as `_materialize_sends` lays them out: the forward's copy-out reads
// that prefix of the receive buffer. The kernels copy bytes (rows of
// `row_bytes`, in 8-, 4- or 2-byte units), so one instance serves f32
// and bf16 rows and a result equals its plain version bit for bit.
// Routing rows are not checked: rows outside a buffer are the layout's
// fault, as an id outside h is B3's caller's.
//
// One kernel a rank a direction, and no fence. Rows travel as lines
// (NCCL's low-latency protocol): 16-byte stores of 8 data bytes, each 4
// beside the round's flag, so that a line whose two flags read as the
// round's holds its data (each aligned 8-byte half is single-copy
// atomic) and a receiver needs no signal after the data, nor the sender
// a system fence before one. Each block of a rank's kernel first pushes
// its share of the lines to every peer (a block-stride loop over the
// flattened lines of each peer's slice, consecutive threads on
// consecutive lines); block 0 also pushes each peer this rank's route
// for it, two lines, which the peer waits for in every round, rows or
// none: that is the round's handshake. Then every block copies its share
// of the table (forward) or pack (backward) out of its own buffer,
// spinning on each line until its flags are the round's, and zeroes the
// rest; the last block to finish ends the round. Rows cross NVLink once,
// by stores that do not wait for a reply, at twice their bytes; no
// kernel loads from a peer.
//
// The backward pushes too. The receiver of an owner's rows holds the
// cotangent of its slice but not where the owner's pack takes it
// (input_offsets[owner, me]): each rank reads only its own routing rows.
// So the route lines of the forward carry, for each peer d,
// (input_offsets[me,d], send_sizes[me,d], output_offsets[me,d]); d's
// forward writes the routes it received into a small tensor of its own
// exchange (`routes`, [kMaxRanks][3] int32), which the caller hands to
// that exchange's backward: a step may run several forwards before their
// backwards, in any order. The backward pushes by those routes into each
// owner's backward buffer, at the very rows of the owner's pack, after
// the route itself (its route lines); the owner copies its buffer into
// the pack by its own routing rows, and traps where a pusher's route
// differs from them, so routes of another exchange are an error, never a
// wrong pack. The backward buffers hold up to SEND_CAP rows, the
// forward's recv_cap: a region's buffers are sized by the larger.
//
// Memory. Every rank owns one region (cudaMalloc, exported to its peers
// as a CUDA IPC handle by the Python side; `rx_region_alloc`): a header
// (Header below: its round counters), then four buffers
// of `buffer_bytes`: (channel 0 forward, channel 1 backward) x (round
// parity 0, 1), each kMaxRanks x 2 route lines by sender, then the rows'
// lines. Peers write into a region's buffers over NVLink; `peers` is a
// device array of the S regions' addresses in this process.
//
// Rounds count on the device. Each channel is a sequence of rounds that
// every rank runs in the same order. A rank's round counter
// (header.round[c], bumped by the last block of its kernel; every block
// read it first) gives the round e = round + 1, and its flag (never 0,
// which a zeroed buffer holds). A replayed graph so never reads a stale
// line as fresh: lines of parity e % 2 hold e - 2's flag or e's.
//
// Buffer reuse: two buffers a channel, alternated by round parity, and
// no entry barrier. A rank writes into a peer's buffer of parity e % 2
// in round e only in its kernel of round e, which starts after its
// kernel of round e - 1 ended (stream order); that kernel waited for the
// peer's route lines of e - 1, which the peer wrote from its own kernel
// of round e - 1, which started after the peer's kernel of round e - 2,
// the last to read that buffer, ended. One buffer would not do: the
// peer writes its lines of e - 1 before its copy-out of e - 1.
//
// Every block of a launch must be resident at once: a block spins on
// lines that blocks of its peers write, and theirs on lines of its own
// rank's blocks, which an unscheduled block never writes. The wrapper
// sizes the grid from the caps (never from the sizes, which live on the
// card) within what the occupancy API admits (`rx_resident_blocks`),
// and a launch that asks for more is refused. One process can stand in
// for the S ranks of a group on one card: it launches them as one grid,
// the rank a grid dimension (S ranks' kernels one after another on one
// stream would deadlock: rank 0 would spin before rank 1 was launched).
// Two processes on one card cannot run it: without MPS their kernels
// time-slice.
//
// Waits are bounded: a spin that outlives its budget (clock64 cycles
// for `seconds` at the card's clock rate) writes a code naming the
// channel, the rank and the peer it waited for into a mapped host word
// (`rx_status`) and traps, so a rank that never arrives becomes an
// error at the next synchronise, not a hang. A stale route traps the
// same way with another code.
//
// What bounds it on the H100: at a molecular batch's few dozen rows a
// pair, latency: a launch, a line's trip over NVLink and a copy-out of
// the receive buffer (the bytes: each sent row read from h at 3.35 TB/s
// and stored over NVLink, as lines of twice its bytes, at 450 GB/s each
// way; the table or pack written once). The design spends one launch an
// exchange and one trip each way, with no fence on the path.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr size_t kHeaderBytes = 4096;
constexpr int kThreads = 256;

// Where an owner's rows for this rank came from and went, as its forward
// pushed them: rows [first, first + count) of its pack, landed at row
// `at` of this rank's table.
struct Route {
  int first;
  int count;
  int at;
};

struct Header {
  unsigned long long round[2];             // this rank's rounds done
  unsigned int done[2];     // blocks of the round's kernel finished
};
static_assert(sizeof(Header) <= kHeaderBytes, "the header outgrew its room");

// Each rank's tensors of one launch, by grid row (one row, or S for one
// process standing in for a group), passed by value.
struct Ranks {
  const void* src[kMaxRanks];   // h forward, the table cotangent backward
  void* out[kMaxRanks];         // the table forward, the pack backward
  const int* gather[kMaxRanks];
  const int* in_off[kMaxRanks];
  const int* send[kMaxRanks];
  const int* out_off[kMaxRanks];
  const int* recv[kMaxRanks];
  int* routes[kMaxRanks];       // [kMaxRanks][3]: written forward, read back
};

// a[y] with constant indices only (a parameter array indexed at run time
// would be copied to local memory).
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxRanks], int y) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < kMaxRanks; ++k)
    if (k == y) v = a[k];
  return v;
}

__device__ __forceinline__ Header* header_of(
    const unsigned long long* peers, int rank) {
  return reinterpret_cast<Header*>(peers[rank]);
}

__device__ __forceinline__ void fail(int* status, int code) {
  *reinterpret_cast<volatile int*>(status) = code;
  __threadfence_system();
  __trap();
}

// A line: 8 bytes of data, each 4 with the round's flag beside it, stored
// and loaded as one 16-byte access; each 8-byte half is single-copy
// atomic, so a line whose two flags are the round's holds its data.
struct Line {
  unsigned int d0, f0, d1, f1;
};
// Lines a sender's route takes in a buffer: {first, count}, {at, 0}.
constexpr int kPairLines = 2;

// The lines of `channel` for round parity `parity` in rank's region:
// kMaxRanks x kPairLines route lines by sender, then the rows' lines.
__device__ __forceinline__ Line* lines_of(const unsigned long long* peers,
                                          int rank, int channel, int parity,
                                          size_t buffer_bytes) {
  return reinterpret_cast<Line*>(peers[rank] + kHeaderBytes +
                                 (2 * channel + parity) * buffer_bytes);
}

__device__ __forceinline__ void store_line(Line* p, unsigned int d0,
                                           unsigned int d1, unsigned int f) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(d0), "r"(f), "r"(d1), "r"(f)
               : "memory");
}

// Spins until the line at p holds round f's data (bounded, as a wait).
__device__ __forceinline__ uint2 wait_line(const Line* p, unsigned int f,
                                           long long start, long long budget,
                                           int* status, int code) {
  unsigned int d0, f0, d1, f1;
  for (;;) {
    asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(d0), "=r"(f0), "=r"(d1), "=r"(f1)
                 : "l"(p)
                 : "memory");
    if (f0 == f && f1 == f) return make_uint2(d0, d1);
    if (clock64() - start > budget) fail(status, code);
  }
}

// Bytes [8 l, 8 l + 8) of a row of `width` units V (zero past its end).
template <typename V>
__device__ __forceinline__ uint2 read_chunk(const V* row, int l, int width) {
  constexpr int kPer = 8 / sizeof(V);
  union {
    uint2 u;
    V v[kPer];
  } c;
  c.u = make_uint2(0, 0);
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (l * kPer + k < width) c.v[k] = __ldg(row + l * kPer + k);
  return c.u;
}

template <typename V>
__device__ __forceinline__ void write_chunk(V* row, int l, int width,
                                           uint2 data) {
  constexpr int kPer = 8 / sizeof(V);
  union {
    uint2 u;
    V v[kPer];
  } c;
  c.u = data;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (l * kPer + k < width) row[l * kPer + k] = c.v[k];
}

// This block's share of `n` rows of `src` (row ids `ids`, or consecutive
// rows from 0 when null) as lines of round f at `dst`, L lines a row.
template <typename V>
__device__ __forceinline__ void push_rows(Line* dst, const V* src,
                                          const int* ids, int n, int width,
                                          int L, unsigned int f) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n * L;
       i += gridDim.x * kThreads) {
    const int r = i / L;
    const int l = i - r * L;
    const int row = ids != nullptr ? __ldg(ids + r) : r;
    const uint2 c = read_chunk(src + static_cast<int64_t>(row) * width, l,
                               width);
    store_line(dst + i, c.x, c.y, f);
  }
}

// The end of a round: the last block to finish bumps the round counter
// (every block read it before it finished) and resets the block count.
__device__ void end_round(Header* mine, int channel, unsigned long long e) {
  __syncthreads();
  if (threadIdx.x == 0 &&
      atomicAdd(&mine->done[channel], 1u) == gridDim.x - 1) {
    mine->done[channel] = 0;
    mine->round[channel] = e;
  }
}

// The flag of round e: never 0, which a zeroed buffer holds.
__device__ __forceinline__ unsigned int flag_of(unsigned long long e) {
  return static_cast<unsigned int>((e - 1) % 0xffffffffull) + 1u;
}

// Forward: push this rank's route and rows to every peer as lines of the
// round; block 0 reads every peer's route (the handshake a round needs,
// rows or none) into `routes` for the backward; every block
// copies its share of the table out of its own lines as they arrive, and
// zeroes rows past sum recv_sizes.
template <typename V>
__global__ void __launch_bounds__(kThreads)
forward_kernel(Ranks a, const unsigned long long* peers, int me0, int S,
               int width, int recv_cap, size_t buffer_bytes,
               long long budget, int* status) {
  __shared__ int lo[kMaxRanks], hi[kMaxRanks];  // each peer's table rows
  const int y = blockIdx.y;
  const int me = me0 + y;
  const V* h = static_cast<const V*>(pick(a.src, y));
  V* out = static_cast<V*>(pick(a.out, y));
  const int* gather = pick(a.gather, y);
  const int* in_off = pick(a.in_off, y);
  const int* send = pick(a.send, y);
  const int* out_off = pick(a.out_off, y);
  const int* recv = pick(a.recv, y);
  int* routes = pick(a.routes, y);
  Header* mine = header_of(peers, me);
  const unsigned long long e =
      *reinterpret_cast<volatile unsigned long long*>(&mine->round[0]) + 1;
  const int parity = static_cast<int>(e & 1);
  const unsigned int f = flag_of(e);
  const int L = (width * static_cast<int>(sizeof(V)) + 7) / 8;
  const int t = threadIdx.x;
  const long long start = clock64();
  if (t == 0) {   // the slices tile the table owner-major from row 0
    int at = 0;
    for (int s = 0; s < S; ++s) {
      lo[s] = at;
      hi[s] = s == me ? 0 : __ldg(recv + s);
      at += __ldg(recv + s);
    }
  }
  __syncthreads();
  if (blockIdx.x == 0 && t < S && t != me) {
    Line* head = lines_of(peers, t, 0, parity, buffer_bytes) +
                 me * kPairLines;
    store_line(head, __ldg(in_off + t), __ldg(send + t), f);
    store_line(head + 1, __ldg(out_off + t), 0u, f);
  }
  for (int k = 1; k < S; ++k) {
    const int d = (me + k) % S;   // peers in a rotated order
    push_rows(lines_of(peers, d, 0, parity, buffer_bytes) +
                  kMaxRanks * kPairLines +
                  static_cast<int64_t>(__ldg(out_off + d)) * L,
              h, gather + __ldg(in_off + d), __ldg(send + d), width, L, f);
  }
  const Line* own = lines_of(peers, me, 0, parity, buffer_bytes);
  if (blockIdx.x == 0 && t < S && t != me) {
    const int code = (1 << 16) | (me << 4) | t;
    const uint2 fc = wait_line(own + t * kPairLines, f, start, budget,
                               status, code);
    const uint2 at = wait_line(own + t * kPairLines + 1, f, start, budget,
                               status, code);
    routes[3 * t] = static_cast<int>(fc.x);
    routes[3 * t + 1] = static_cast<int>(fc.y);
    routes[3 * t + 2] = static_cast<int>(at.x);
  } else if (blockIdx.x == 0 && t < kMaxRanks) {   // itself, or past S
    routes[3 * t] = routes[3 * t + 1] = routes[3 * t + 2] = 0;
  }
  const Line* rows = own + kMaxRanks * kPairLines;
  for (int i = blockIdx.x * kThreads + t; i < recv_cap * L;
       i += gridDim.x * kThreads) {
    const int r = i / L;
    const int l = i - r * L;
    int src = -1;   // the peer whose slice holds table row r
    for (int s = 0; s < S; ++s)
      if (static_cast<unsigned>(r - lo[s]) < static_cast<unsigned>(hi[s]))
        src = s;
    write_chunk(out + static_cast<int64_t>(r) * width, l, width,
                src >= 0 ? wait_line(rows + i, f, start, budget, status,
                                     (1 << 16) | (me << 4) | src)
                         : make_uint2(0, 0));
  }
  end_round(mine, 0, e);
}

// Backward: push the cotangent of each owner's slice, as lines of the
// round, into the owner's backward buffer at the rows its pack takes
// (the route the forward of these rows received, in `routes`), after
// the route itself; block 0 checks each pusher's route against this
// rank's rows; every block copies its share of the pack out of its own
// lines as they arrive, zero where nothing was sent.
template <typename V>
__global__ void __launch_bounds__(kThreads)
backward_kernel(Ranks a, const unsigned long long* peers, int me0, int S,
                int width, int send_cap, size_t buffer_bytes,
                long long budget, int* status) {
  __shared__ int first[kMaxRanks], count[kMaxRanks];
  const int y = blockIdx.y;
  const int me = me0 + y;
  const V* g = static_cast<const V*>(pick(a.src, y));
  V* pack = static_cast<V*>(pick(a.out, y));
  const int* in_off = pick(a.in_off, y);
  const int* send = pick(a.send, y);
  const int* out_off = pick(a.out_off, y);
  const int* routes = pick(a.routes, y);
  Header* mine = header_of(peers, me);
  const unsigned long long e =
      *reinterpret_cast<volatile unsigned long long*>(&mine->round[1]) + 1;
  const int parity = static_cast<int>(e & 1);
  const unsigned int f = flag_of(e);
  const int L = (width * static_cast<int>(sizeof(V)) + 7) / 8;
  const int t = threadIdx.x;
  const long long start = clock64();
  if (t < S) {
    first[t] = __ldg(in_off + t);
    count[t] = t == me ? 0 : __ldg(send + t);
  }
  for (int k = 1; k < S; ++k) {
    const int o = (me + k) % S;
    const Route r = Route{__ldg(routes + 3 * o), __ldg(routes + 3 * o + 1),
                          __ldg(routes + 3 * o + 2)};
    Line* lines = lines_of(peers, o, 1, parity, buffer_bytes);
    if (blockIdx.x == 0 && t == 0) {
      store_line(lines + me * kPairLines, r.first, r.count, f);
      store_line(lines + me * kPairLines + 1, r.at, 0u, f);
    }
    push_rows(lines + kMaxRanks * kPairLines +
                  static_cast<int64_t>(r.first) * L,
              g + static_cast<int64_t>(r.at) * width,
              static_cast<const int*>(nullptr), r.count, width, L, f);
  }
  __syncthreads();
  const Line* own = lines_of(peers, me, 1, parity, buffer_bytes);
  if (blockIdx.x == 0 && t < S && t != me) {
    const int code = (1 << 16) | (1 << 8) | (me << 4) | t;
    const uint2 fc = wait_line(own + t * kPairLines, f, start, budget,
                               status, code);
    const uint2 at = wait_line(own + t * kPairLines + 1, f, start, budget,
                               status, code);
    if (static_cast<int>(fc.x) != first[t] ||
        static_cast<int>(fc.y) != count[t] ||
        static_cast<int>(at.x) != __ldg(out_off + t))
      fail(status, (2 << 16) | (1 << 8) | (me << 4) | t);
  }
  const Line* rows = own + kMaxRanks * kPairLines;
  for (int i = blockIdx.x * kThreads + t; i < send_cap * L;
       i += gridDim.x * kThreads) {
    const int row = i / L;
    const int l = i - row * L;
    int src = -1;   // the peer that pushed pack row `row`
    for (int d = 0; d < S; ++d)
      if (static_cast<unsigned>(row - first[d]) <
          static_cast<unsigned>(count[d]))
        src = d;
    write_chunk(pack + static_cast<int64_t>(row) * width, l, width,
                src >= 0 ? wait_line(rows + i, f, start, budget, status,
                                     (1 << 16) | (1 << 8) | (me << 4) | src)
                         : make_uint2(0, 0));
  }
  end_round(mine, 1, e);
}

// The card's clock rate in kHz and its SM count, read once a device (the
// queries are slow).
int g_khz[64] = {0};
int g_sms[64] = {0};

int device_slot(int device) { return device < 0 || device >= 64 ? 0 : device; }

long long budget_cycles(int device, double seconds) {
  const int slot = device_slot(device);
  if (g_khz[slot] <= 0) {
    int khz = 0;
    if (cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device) !=
            cudaSuccess ||
        khz <= 0)
      khz = 2000000;
    g_khz[slot] = khz;
  }
  return static_cast<long long>(seconds * 1e3 * g_khz[slot]);
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

// Blocks of `threads` the card holds at once of the unit's forward and
// backward instances (the fewer), into *out.
template <typename V>
int resident(int device, int* out) {
  const int slot = device_slot(device);
  if (g_sms[slot] <= 0) {
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[slot] = sms;
  }
  int fwd = 0, bwd = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fwd, forward_kernel<V>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &bwd, backward_kernel<V>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = (fwd < bwd ? fwd : bwd) * g_sms[slot];
  return 0;
}

int g_resident[3][64] = {{0}};   // by unit (16, 4, 2) and device

int resident_for(int unit, int device, int* out) {
  const int u = unit == 8 ? 0 : unit == 4 ? 1 : unit == 2 ? 2 : -1;
  if (u < 0) return static_cast<int>(cudaErrorInvalidValue);
  int& held = g_resident[u][device_slot(device)];
  if (held <= 0) {
    const int err = u == 0   ? resident<uint2>(device, &held)
                    : u == 1 ? resident<unsigned int>(device, &held)
                             : resident<unsigned short>(device, &held);
    if (err != 0) return err;
  }
  *out = held;
  return 0;
}

bool aligned(const void* p, int unit) {
  return reinterpret_cast<uintptr_t>(p) % unit == 0;
}

// One launch of `ranks` grid rows from rank me0 on, each row's pointers
// from the host arrays; `cap` is recv_cap forward, SEND_CAP backward.
int launch(bool backward, const void* const* src, void* const* out,
           const void* const* gather, const void* const* in_off,
           const void* const* send, const void* const* out_off,
           const void* const* recv, void* const* routes,
           const void* peers, int me0, int ranks,
           int S, int row_bytes, int unit, int blocks, int cap,
           size_t buffer_bytes, double seconds, int device, void* stream) {
  if (S < 1 || S > kMaxRanks || ranks < 1 || me0 < 0 || me0 + ranks > S ||
      blocks < 1 || cap < 0 || row_bytes <= 0 || (unit != 8 && unit != 4 &&
      unit != 2) || row_bytes % unit != 0 || buffer_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width = row_bytes / unit;
  if (static_cast<long long>(cap) * width > INT_MAX ||
      static_cast<long long>(buffer_bytes / unit) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Ranks a{};
  for (int y = 0; y < ranks; ++y) {
    if (!aligned(src[y], unit) || !aligned(out[y], unit) ||
        !aligned(routes[y], 4))
      return static_cast<int>(cudaErrorMisalignedAddress);
    a.src[y] = src[y];
    a.out[y] = out[y];
    a.gather[y] = static_cast<const int*>(gather[y]);
    a.in_off[y] = static_cast<const int*>(in_off[y]);
    a.send[y] = static_cast<const int*>(send[y]);
    a.out_off[y] = static_cast<const int*>(out_off[y]);
    a.recv[y] = static_cast<const int*>(recv[y]);
    a.routes[y] = static_cast<int*>(routes[y]);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* status = nullptr;
  int bad = status_word(&status);
  if (bad != 0) return bad;
  int fits = 0;
  bad = resident_for(unit, device, &fits);
  if (bad != 0) return bad;
  if (blocks * ranks > fits)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const auto* table = static_cast<const unsigned long long*>(peers);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long budget = budget_cycles(device, seconds);
  const dim3 grid(blocks, ranks);
#define RX_LAUNCH(V)                                                        \
  (backward ? (backward_kernel<V><<<grid, kThreads, 0, s>>>(               \
                   a, table, me0, S, width, cap, buffer_bytes, budget,      \
                   status), 0)                                              \
            : (forward_kernel<V><<<grid, kThreads, 0, s>>>(                \
                   a, table, me0, S, width, cap, buffer_bytes, budget,      \
                   status), 0))
  if (unit == 8)
    RX_LAUNCH(uint2);
  else if (unit == 4)
    RX_LAUNCH(unsigned int);
  else
    RX_LAUNCH(unsigned short);
#undef RX_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A region of kHeaderBytes + 4 * buffer_bytes bytes on `device`, zeroed
// (counters and lines 0), into *ptr; with `handle` non-null its
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

// The code a failed wait left (0 when none): 1 << 16 (a wait timed out)
// or 2 << 16 (a pusher's route differs from this rank's rows) | channel
// << 8 | rank << 4 | the peer.
extern "C" int rx_status(void) {
  int* word = nullptr;
  if (status_word(&word) != 0) return -1;
  return *reinterpret_cast<volatile int*>(word);
}

// Blocks of the copy unit's kernels the card holds at once.
extern "C" int rx_resident_blocks(int unit, int device, int* out) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return resident_for(unit, device, out);
}

// Forward of grid rows me0 .. me0 + ranks - 1: each writes its table and
// the routes it received (`routes`, [kMaxRanks][3] int32 a rank).
extern "C" int rx_forward(const void* const* h, void* const* table,
                          const void* const* gather, const void* const* in_off,
                          const void* const* send, const void* const* out_off,
                          const void* const* recv, void* const* routes,
                          const void* peers, int me0, int ranks, int S,
                          int row_bytes, int unit, int blocks, int recv_cap,
                          size_t buffer_bytes, double seconds, int device,
                          void* stream) {
  return launch(false, h, table, gather, in_off, send, out_off, recv, routes,
                peers, me0, ranks, S, row_bytes, unit, blocks, recv_cap,
                buffer_bytes, seconds, device, stream);
}

// Reverse transfer of grid rows me0 .. me0 + ranks - 1, each pushing by
// the `routes` its forward of the same rows wrote.
extern "C" int rx_backward(const void* const* g, void* const* pack,
                           const void* const* gather,
                           const void* const* in_off, const void* const* send,
                           const void* const* out_off,
                           const void* const* recv, void* const* routes,
                           const void* peers, int me0, int ranks, int S,
                           int row_bytes, int unit, int blocks, int send_cap,
                           size_t buffer_bytes, double seconds, int device,
                           void* stream) {
  return launch(true, g, pack, gather, in_off, send, out_off, recv, routes,
                peers, me0, ranks, S, row_bytes, unit, blocks, send_cap,
                buffer_bytes, seconds, device, stream);
}
