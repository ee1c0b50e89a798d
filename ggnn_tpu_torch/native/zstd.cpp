// A Zstandard frame decoder (RFC 8878), with crc32c and XXH64, for the
// Orbax directory checkpoints (ggnn_tpu_torch/training/orbax_dir.py).
//
// Host code, built by g++ into build/native/ at first use and bound with
// ctypes (ggnn_tpu_torch/native/__init__.py). It decodes:
//   - raw, RLE and compressed blocks;
//   - raw, RLE, compressed and treeless literals (Huffman, 1 and 4
//     streams; weights direct or FSE-compressed);
//   - sequences under predefined, RLE, FSE and repeat modes, with the
//     three repeat offsets and matches that overlap their output;
//   - the optional content checksum (XXH64, verified when present),
//     several frames in one buffer, and skippable frames.
// A frame that names a dictionary is refused. Every read is bounds
// checked: a corrupt frame is an error, never a read past the input.
//
// C interface:
//   zstd_decompress(src, n, &out, &out_len, err, err_cap) -> 0 or -1
//       `out` is malloc'd and freed by zstd_free; on -1, `err` holds the
//       reason.
//   ggnn_crc32c(crc, p, n) -> the crc32c (Castagnoli) continued from crc

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  explicit Error(const std::string& what) : std::runtime_error(what) {}
};

[[noreturn]] void fail(const char* what) { throw Error(what); }

inline int highest_bit(uint64_t v) {  // v > 0
  return 63 - __builtin_clzll(v);
}

inline uint64_t read_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, read_le(p, 8));
      v2 = xxh_round(v2, read_le(p + 8, 8));
      v3 = xxh_round(v3, read_le(p + 16, 8));
      v4 = xxh_round(v4, read_le(p + 24, 8));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    h ^= xxh_round(0, read_le(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= read_le(p, 4) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------------------------- crc32c
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(uint32_t crc, const uint8_t* p, size_t n) {
  static const Crc32cTable table;
  const auto& t = table.t;
  crc = ~crc;
  while (n >= 8) {  // slicing by 8
    uint64_t v = read_le(p, 8) ^ crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^ t[2][(v >> 40) & 0xFF] ^
          t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

// ------------------------------------------------------------ bit input
// Forward reader (FSE table descriptions): bits in little-endian order.
struct ForwardBits {
  const uint8_t* p;
  size_t size;
  size_t pos = 0;  // in bits
  ForwardBits(const uint8_t* p_, size_t n) : p(p_), size(n) {}
  uint32_t read(int n) {
    if (n == 0) return 0;
    if (pos + n > size * 8) fail("FSE table description runs past its block");
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++pos)
      v |= uint32_t((p[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
  void rewind(int n) { pos -= n; }
  size_t bytes_used() const { return (pos + 7) / 8; }
};

// Backward reader (Huffman and FSE bitstreams): the stream ends with a
// 1-bit of padding in its last byte, and is read from there towards its
// first byte. Bits past the start read as 0 and leave `pos` negative.
struct BackwardBits {
  const uint8_t* p;
  int64_t size;
  int64_t pos;  // bits not yet read
  BackwardBits(const uint8_t* p_, size_t n) : p(p_), size(int64_t(n)) {
    if (n == 0) fail("empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("bitstream's last byte holds no padding bit");
    pos = int64_t(n - 1) * 8 + highest_bit(last);
  }
  uint64_t get(int64_t start, int n) const {  // bits [start, start + n)
    if (start < 0) {
      int64_t k = start + n;
      if (k <= 0) return 0;
      return get(0, int(k)) << (-start);
    }
    int64_t byte = start >> 3;
    int shift = int(start & 7);
    int avail = int(size - byte < 8 ? size - byte : 8);
    uint64_t v = read_le(p + byte, avail) >> shift;
    return n == 64 ? v : v & ((uint64_t(1) << n) - 1);
  }
  uint64_t read(int n) {
    if (n == 0) return 0;
    pos -= n;
    return get(pos, n);
  }
};

// -------------------------------------------------------------- FSE
constexpr int kMaxSymbols = 256;

struct FseTable {
  int log = 0;
  std::vector<uint8_t> symbol, bits;
  std::vector<uint16_t> base;
};

void fse_build(FseTable& t, const int16_t* norm, int num_symbols, int log) {
  int size = 1 << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.bits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(num_symbols, 0);
  int high = size;
  for (int s = 0; s < num_symbols; ++s) {
    if (norm[s] == -1) {
      t.symbol[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < num_symbols; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE distribution does not fill its table");
  for (int i = 0; i < size; ++i) {
    int s = t.symbol[i];
    uint32_t state = next[s]++;
    int nb = log - highest_bit(state);
    t.bits[i] = uint8_t(nb);
    t.base[i] = uint16_t((state << nb) - size);
  }
}

// An FSE table description (RFC 8878 4.1.1); returns the bytes read.
size_t fse_read_table(FseTable& t, const uint8_t* p, size_t n, int max_log,
                      int max_symbol) {
  ForwardBits in(p, n);
  int log = 5 + int(in.read(4));
  if (log > max_log) fail("FSE accuracy log above its maximum");
  int remaining = 1 << log;
  int16_t norm[kMaxSymbols];
  int symbol = 0;
  while (remaining > 0 && symbol <= max_symbol) {
    int nb = highest_bit(uint64_t(remaining) + 1) + 1;
    uint32_t v = in.read(nb);
    uint32_t lower = (1u << (nb - 1)) - 1;
    uint32_t threshold = (1u << nb) - 1 - uint32_t(remaining + 1);
    if ((v & lower) < threshold) {
      in.rewind(1);
      v &= lower;
    } else if (v > lower) {
      v -= threshold;
    }
    int proba = int(v) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[symbol++] = int16_t(proba);
    if (proba == 0) {
      uint32_t repeat = in.read(2);
      while (true) {
        for (uint32_t i = 0; i < repeat && symbol <= max_symbol; ++i) norm[symbol++] = 0;
        if (repeat != 3) break;
        repeat = in.read(2);
      }
    }
  }
  if (remaining != 0) fail("FSE distribution does not sum to its table size");
  fse_build(t, norm, symbol, log);
  return in.bytes_used();
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.symbol.assign(1, symbol);
  t.bits.assign(1, 0);
  t.base.assign(1, 0);
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(const FseTable& table, BackwardBits& in) {
    t = &table;
    state = uint32_t(in.read(table.log));
  }
  uint8_t peek() const { return t->symbol[state]; }
  void update(BackwardBits& in) {
    state = t->base[state] + uint32_t(in.read(t->bits[state]));
  }
};

// ---------------------------------------------------------- Huffman
struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;
};

void huf_build(HufTable& t, const uint8_t* weights, int num_symbols) {
  uint64_t total = 0;
  for (int s = 0; s < num_symbols; ++s)
    if (weights[s]) total += uint64_t(1) << (weights[s] - 1);
  if (total == 0) fail("Huffman weights are all zero");
  int max_bits = highest_bit(total) + 1;
  uint64_t left = (uint64_t(1) << max_bits) - total;
  if (left == 0 || (left & (left - 1))) fail("Huffman weights do not complete a tree");
  uint8_t w[kMaxSymbols];
  memcpy(w, weights, num_symbols);
  if (num_symbols >= kMaxSymbols) fail("Huffman tree has too many symbols");
  w[num_symbols] = uint8_t(highest_bit(left) + 1);  // the implied last weight
  ++num_symbols;
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  int size = 1 << max_bits;
  t.max_bits = max_bits;
  t.symbol.assign(size, 0);
  t.bits.assign(size, 0);
  int count[13] = {0}, idx[13] = {0};
  uint8_t nbits[kMaxSymbols];
  for (int s = 0; s < num_symbols; ++s) {
    nbits[s] = w[s] ? uint8_t(max_bits + 1 - w[s]) : 0;
    if (w[s] > max_bits) fail("Huffman weight above the tree's depth");
    count[nbits[s]]++;
  }
  idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    idx[b - 1] = idx[b] + count[b] * (1 << (max_bits - b));
    for (int i = idx[b]; i < idx[b - 1]; ++i) t.bits[i] = uint8_t(b);
  }
  for (int s = 0; s < num_symbols; ++s) {
    if (!nbits[s]) continue;
    int len = 1 << (max_bits - nbits[s]);
    int code = idx[nbits[s]];
    for (int i = 0; i < len; ++i) t.symbol[code + i] = uint8_t(s);
    idx[nbits[s]] += len;
  }
}

// A Huffman tree description (RFC 8878 4.2.1); returns the bytes read.
size_t huf_read_table(HufTable& t, const uint8_t* p, size_t n) {
  if (n < 1) fail("missing Huffman tree description");
  uint8_t weights[kMaxSymbols] = {0};
  int num = 0;
  int header = p[0];
  size_t used;
  if (header >= 128) {  // direct: 4 bits a weight
    num = header - 127;
    used = 1 + (size_t(num) + 1) / 2;
    if (used > n) fail("Huffman weights run past their block");
    for (int i = 0; i < num; ++i) {
      uint8_t byte = p[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (byte >> 4) : (byte & 0xF);
    }
  } else {  // FSE-compressed weights
    used = 1 + size_t(header);
    if (used > n || header == 0) fail("Huffman weights run past their block");
    FseTable table;
    size_t hdr = fse_read_table(table, p + 1, header, 6, 255);
    if (hdr >= size_t(header)) fail("Huffman weights hold no bitstream");
    BackwardBits in(p + 1 + hdr, header - hdr);
    FseState s1, s2;
    s1.init(table, in);
    s2.init(table, in);
    while (true) {
      if (num >= 255) fail("too many Huffman weights");
      weights[num++] = s1.peek();
      s1.update(in);
      if (in.pos < 0) {
        weights[num++] = s2.peek();
        break;
      }
      if (num >= 255) fail("too many Huffman weights");
      weights[num++] = s2.peek();
      s2.update(in);
      if (in.pos < 0) {
        weights[num++] = s1.peek();
        break;
      }
    }
  }
  for (int i = 0; i < num; ++i)
    if (weights[i] > 11) fail("Huffman weight above 11");
  huf_build(t, weights, num);
  return used;
}

void huf_decode_stream(const HufTable& t, const uint8_t* p, size_t n, uint8_t* out,
                       size_t count) {
  BackwardBits in(p, n);
  uint32_t mask = (1u << t.max_bits) - 1;
  uint32_t state = uint32_t(in.read(t.max_bits));
  for (size_t i = 0; i < count; ++i) {
    out[i] = t.symbol[state];
    int nb = t.bits[state];
    state = ((state << nb) + uint32_t(in.read(nb))) & mask;
  }
  // The decoder reads max_bits past the last symbol's code: exactly
  // max_bits below the stream's start remain unread.
  if (in.pos != -int64_t(t.max_bits)) fail("Huffman stream length does not match its literals");
}

// ----------------------------------------------------------- sequences
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,   8,   9,   10,  11,   12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21,  22,  23,  24,  25,   26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35,  37,  39,  41,  43,   47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// What persists from block to block within a frame.
struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

// Decodes one compressed block into `out`, whose frame starts at
// `frame_start`.
void decode_compressed_block(const uint8_t* p, size_t n, FrameState& fs,
                             std::vector<uint8_t>& out, size_t frame_start) {
  // Literals section.
  if (n < 1) fail("empty compressed block");
  int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
  size_t regen = 0, comp = 0, hdr = 0;
  int streams = 1;
  if (type == 0 || type == 1) {
    if (fmt == 0 || fmt == 2) {
      regen = p[0] >> 3;
      hdr = 1;
    } else if (fmt == 1) {
      if (n < 2) fail("literals header runs past its block");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      hdr = 2;
    } else {
      if (n < 3) fail("literals header runs past its block");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      hdr = 3;
    }
  } else {
    if (fmt <= 1) {
      if (n < 3) fail("literals header runs past its block");
      uint64_t h = read_le(p, 3);
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
      hdr = 3;
      streams = fmt == 0 ? 1 : 4;
    } else if (fmt == 2) {
      if (n < 4) fail("literals header runs past its block");
      uint64_t h = read_le(p, 4);
      regen = (h >> 4) & 0x3FFF;
      comp = (h >> 18) & 0x3FFF;
      hdr = 4;
      streams = 4;
    } else {
      if (n < 5) fail("literals header runs past its block");
      uint64_t h = read_le(p, 5);
      regen = (h >> 4) & 0x3FFFF;
      comp = (h >> 22) & 0x3FFFF;
      hdr = 5;
      streams = 4;
    }
  }
  if (regen > (128u << 10)) fail("literals longer than a block");
  std::vector<uint8_t> lit(regen);
  size_t pos = hdr;
  if (type == 0) {
    if (pos + regen > n) fail("raw literals run past their block");
    if (regen) memcpy(lit.data(), p + pos, regen);
    pos += regen;
  } else if (type == 1) {
    if (pos + 1 > n) fail("RLE literals run past their block");
    memset(lit.data(), p[pos], regen);
    pos += 1;
  } else {
    if (pos + comp > n) fail("compressed literals run past their block");
    const uint8_t* q = p + pos;
    size_t qn = comp;
    if (type == 2) {
      size_t used = huf_read_table(fs.huf, q, qn);
      fs.have_huf = true;
      q += used;
      qn -= used;
    } else if (!fs.have_huf) {
      fail("treeless literals with no earlier Huffman table");
    }
    if (streams == 1) {
      huf_decode_stream(fs.huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail("literals jump table runs past its block");
      size_t s1 = read_le(q, 2), s2 = read_le(q + 2, 2), s3 = read_le(q + 4, 2);
      if (6 + s1 + s2 + s3 > qn) fail("literal streams run past their block");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("literals too short for four streams");
      const uint8_t* r = q + 6;
      huf_decode_stream(fs.huf, r, s1, lit.data(), seg);
      huf_decode_stream(fs.huf, r + s1, s2, lit.data() + seg, seg);
      huf_decode_stream(fs.huf, r + s1 + s2, s3, lit.data() + 2 * seg, seg);
      huf_decode_stream(fs.huf, r + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
    }
    pos += comp;
  }

  // Sequences section.
  if (pos >= n) fail("block has no sequences section");
  size_t nseq = p[pos++];
  if (nseq >= 128) {
    if (nseq == 255) {
      if (pos + 2 > n) fail("sequence count runs past its block");
      nseq = p[pos] + (size_t(p[pos + 1]) << 8) + 0x7F00;
      pos += 2;
    } else {
      if (pos + 1 > n) fail("sequence count runs past its block");
      nseq = ((nseq - 128) << 8) + p[pos];
      pos += 1;
    }
  }
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (pos >= n) fail("sequence modes run past their block");
    uint8_t modes = p[pos++];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    struct Spec {
      int mode;
      FseTable* table;
      bool* have;
      const int16_t* dflt;
      int dflt_n, dflt_log, max_log, max_symbol;
    } specs[3] = {
        {(modes >> 6) & 3, &fs.ll, &fs.have_ll, kLLDefault, 36, 6, 9, 35},
        {(modes >> 4) & 3, &fs.of, &fs.have_of, kOFDefault, 29, 5, 8, 31},
        {(modes >> 2) & 3, &fs.ml, &fs.have_ml, kMLDefault, 53, 6, 9, 52},
    };
    for (auto& s : specs) {
      if (s.mode == 0) {
        fse_build(*s.table, s.dflt, s.dflt_n, s.dflt_log);
      } else if (s.mode == 1) {
        if (pos >= n) fail("RLE sequence symbol runs past its block");
        if (p[pos] > s.max_symbol) fail("RLE sequence symbol out of range");
        fse_rle(*s.table, p[pos++]);
      } else if (s.mode == 2) {
        pos += fse_read_table(*s.table, p + pos, n - pos, s.max_log, s.max_symbol);
      } else if (!*s.have) {
        fail("repeat mode with no earlier sequence table");
      }
      *s.have = true;
    }
    if (pos >= n) fail("sequence bitstream missing");
    BackwardBits in(p + pos, n - pos);
    FseState ll, of, ml;
    ll.init(fs.ll, in);
    of.init(fs.of, in);
    ml.init(fs.ml, in);
    for (size_t i = 0; i < nseq; ++i) {
      uint8_t ofc = of.peek(), mlc = ml.peek(), llc = ll.peek();
      if (ofc > 31) fail("offset code out of range");
      if (mlc > 52 || llc > 35) fail("length code out of range");
      uint64_t offv = (uint64_t(1) << ofc) + in.read(ofc);
      uint64_t mlen = kMLBase[mlc] + in.read(kMLBits[mlc]);
      uint64_t llen = kLLBase[llc] + in.read(kLLBits[llc]);
      if (i + 1 < nseq) {
        ll.update(in);
        ml.update(in);
        of.update(in);
      }
      uint64_t offset;
      uint64_t* rep = fs.rep;
      if (offv > 3) {
        offset = offv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        int idx = int(offv) - 1 + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx < 3 ? rep[idx] : rep[0] - 1;
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (lit_pos + llen > regen) fail("sequence reads past its literals");
      out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + llen);
      lit_pos += llen;
      size_t have = out.size() - frame_start;
      if (offset == 0 || offset > have) fail("match offset reaches before the frame");
      size_t from = out.size() - offset;
      if (offset >= mlen) {
        out.insert(out.end(), out.begin() + from, out.begin() + from + mlen);
      } else {
        out.reserve(out.size() + mlen);
        for (uint64_t k = 0; k < mlen; ++k) out.push_back(out[from + k]);
      }
    }
    if (in.pos != 0) fail("sequence bitstream not consumed exactly");
  }
  out.insert(out.end(), lit.begin() + lit_pos, lit.end());
}

// Decodes one frame at p[0..n); returns the bytes it took.
size_t decode_frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  if (n < 6) fail("truncated frame header");
  uint8_t fhd = p[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      dict_flag = fhd & 3;
  if (fhd & 0x08) fail("reserved bit set in the frame header");
  size_t pos = 5;
  // The window descriptor (absent from a single-segment frame) bounds
  // how far back a match may reach; the whole frame is decoded into one
  // buffer, so only the frame's start bounds an offset here.
  if (!single) ++pos;
  static const int dict_bytes[4] = {0, 1, 2, 4};
  if (pos + dict_bytes[dict_flag] > n) fail("truncated frame header");
  uint64_t dict_id = read_le(p + pos, dict_bytes[dict_flag]);
  pos += dict_bytes[dict_flag];
  if (dict_id != 0) fail("frame needs a dictionary, which this decoder does not support");
  static const int fcs_bytes[4] = {0, 2, 4, 8};
  int fb = fcs_flag == 0 ? (single ? 1 : 0) : fcs_bytes[fcs_flag];
  if (pos + fb > n) fail("truncated frame header");
  uint64_t content = read_le(p + pos, fb);
  if (fb == 2) content += 256;
  bool has_content = fb > 0;
  pos += fb;
  size_t frame_start = out.size();
  FrameState fs;
  while (true) {
    if (pos + 3 > n) fail("truncated block header");
    uint32_t bh = uint32_t(read_le(p + pos, 3));
    pos += 3;
    int last = bh & 1, btype = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (btype == 3) fail("reserved block type");
    if (bsize > (128u << 10)) fail("block larger than 128 KiB");
    if (btype == 0) {
      if (pos + bsize > n) fail("raw block runs past the input");
      out.insert(out.end(), p + pos, p + pos + bsize);
      pos += bsize;
    } else if (btype == 1) {
      if (pos + 1 > n) fail("RLE block runs past the input");
      out.insert(out.end(), bsize, p[pos]);
      pos += 1;
    } else {
      if (pos + bsize > n) fail("compressed block runs past the input");
      size_t before = out.size();
      decode_compressed_block(p + pos, bsize, fs, out, frame_start);
      if (out.size() - before > (128u << 10)) fail("block decodes to more than 128 KiB");
      pos += bsize;
    }
    if (last) break;
  }
  size_t produced = out.size() - frame_start;
  if (has_content && produced != content) fail("frame content size does not match its blocks");
  if (checksum) {
    if (pos + 4 > n) fail("truncated content checksum");
    uint32_t want = uint32_t(read_le(p + pos, 4));
    uint32_t got = uint32_t(xxh64(out.data() + frame_start, produced, 0));
    if (want != got) fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  size_t pos = 0;
  if (n == 0) fail("empty input");
  while (pos < n) {
    if (n - pos < 4) fail("trailing bytes after the last frame");
    uint32_t magic = uint32_t(read_le(p + pos, 4));
    if (magic == 0xFD2FB528u) {
      pos += decode_frame(p + pos, n - pos, out);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("truncated skippable frame");
      uint64_t size = read_le(p + pos + 4, 4);
      if (size > n - pos - 8) fail("skippable frame runs past the input");
      pos += 8 + size;
    } else {
      fail("not a zstd frame (bad magic number)");
    }
  }
}

}  // namespace

extern "C" {

int zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_len, char* err,
                    size_t err_cap) {
  *out = nullptr;
  *out_len = 0;
  try {
    std::vector<uint8_t> buf;
    decode_all(src, n, buf);
    uint8_t* mem = static_cast<uint8_t*>(malloc(buf.size() ? buf.size() : 1));
    if (!mem) fail("out of memory");
    if (!buf.empty()) memcpy(mem, buf.data(), buf.size());
    *out = mem;
    *out_len = buf.size();
    return 0;
  } catch (const std::exception& e) {
    if (err_cap) snprintf(err, err_cap, "%s", e.what());
    return -1;
  }
}

void zstd_free(uint8_t* p) { free(p); }

uint32_t ggnn_crc32c(uint32_t crc, const uint8_t* p, size_t n) { return crc32c(crc, p, n); }

}  // extern "C"
