// lz4codec.cpp — self-contained LZ4 block + frame codec for the np4 flow
// blob format: a copy of native/lz4codec.cpp for the port, so its blobs
// are the JAX package's bytes.
//
// The reference stores optical flow as ".np4" blobs = LZ4-frame-compressed
// msgpack of {d: raw bytes, t: dtype, s: shape} (reference
// mmaction/utils/data_transform.py:7-19 uses the lz4 python package; the
// vendored native code there is CUDA correlation kernels). This is a fresh
// C++ implementation of the public LZ4 format (https://lz4.org spec):
//   - block decompress (sequence copy machine)
//   - greedy hash-chain block compress
//   - frame wrapper (magic 0x184D2204, FLG/BD/HC header, size-prefixed
//     blocks, xxHash32 header checksum)
// Exposed via a tiny C ABI consumed from Python with ctypes
// (mscl_torch/utils/np4.py).
//
// Built with the host C++ compiler into build/ at first use
// (mscl_torch/ops/cuda_build.py load_host).

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

// ---------------------------------------------------------------- xxHash32
// Public xxHash32 algorithm (needed for the LZ4 frame header checksum).
constexpr uint32_t PRIME1 = 2654435761U;
constexpr uint32_t PRIME2 = 2246822519U;
constexpr uint32_t PRIME3 = 3266489917U;
constexpr uint32_t PRIME4 = 668265263U;
constexpr uint32_t PRIME5 = 374761393U;

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/ARM/TPU hosts)
}

static inline uint16_t read16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

uint32_t xxh32(const uint8_t* input, size_t len, uint32_t seed) {
  const uint8_t* p = input;
  const uint8_t* end = input + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = seed + PRIME1 + PRIME2;
    uint32_t v2 = seed + PRIME2;
    uint32_t v3 = seed + 0;
    uint32_t v4 = seed - PRIME1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + read32(p) * PRIME2, 13) * PRIME1; p += 4;
      v2 = rotl32(v2 + read32(p) * PRIME2, 13) * PRIME1; p += 4;
      v3 = rotl32(v3 + read32(p) * PRIME2, 13) * PRIME1; p += 4;
      v4 = rotl32(v4 + read32(p) * PRIME2, 13) * PRIME1; p += 4;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + PRIME5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) {
    h = rotl32(h + read32(p) * PRIME3, 17) * PRIME4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * PRIME5, 11) * PRIME1;
    p++;
  }
  h ^= h >> 15; h *= PRIME2;
  h ^= h >> 13; h *= PRIME3;
  h ^= h >> 16;
  return h;
}

// ------------------------------------------------------- LZ4 block decode
// Returns decompressed size, or -1 on malformed input / overflow.
int64_t lz4_block_decompress(const uint8_t* src, size_t src_len,
                             uint8_t* dst, size_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;

  while (ip < iend) {
    uint8_t token = *ip++;
    // literals
    size_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        lit_len += s;
      } while (s == 255);
    }
    if (ip + lit_len > iend || op + lit_len > oend) return -1;
    std::memcpy(op, ip, lit_len);
    ip += lit_len;
    op += lit_len;
    if (ip >= iend) break;  // last sequence has no match
    // match
    if (ip + 2 > iend) return -1;
    size_t offset = read16(ip);
    ip += 2;
    if (offset == 0 || (size_t)(op - dst) < offset) return -1;
    size_t match_len = (token & 0x0F);
    if (match_len == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        match_len += s;
      } while (s == 255);
    }
    match_len += 4;
    if (op + match_len > oend) return -1;
    const uint8_t* match = op - offset;
    // overlapping copy must be byte-wise when offset < match_len
    if (offset >= match_len) {
      std::memcpy(op, match, match_len);
      op += match_len;
    } else {
      for (size_t i = 0; i < match_len; i++) *op++ = *match++;
    }
  }
  return (int64_t)(op - dst);
}

// ------------------------------------------------------- LZ4 block encode
// Greedy hash-table compressor. Output must have capacity for worst case:
// len + len/255 + 16.
constexpr int MINMATCH = 4;
constexpr int MFLIMIT = 12;      // last 12 bytes are always literals
constexpr int LASTLITERALS = 5;  // last match must start 12 bytes before end
constexpr int HASH_LOG = 16;

static inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761U) >> (32 - HASH_LOG);
}

size_t lz4_compress_bound(size_t len) { return len + len / 255 + 16; }

int64_t lz4_block_compress(const uint8_t* src, size_t src_len,
                           uint8_t* dst, size_t dst_cap) {
  if (dst_cap < lz4_compress_bound(src_len)) return -1;
  uint8_t* op = dst;
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  const uint8_t* anchor = src;

  auto emit_literals_and_match = [&](size_t lit_len, size_t offset,
                                     size_t match_len_m4) {
    uint8_t* token = op++;
    // literal length
    if (lit_len >= 15) {
      *token = (uint8_t)(15 << 4);
      size_t rest = lit_len - 15;
      while (rest >= 255) { *op++ = 255; rest -= 255; }
      *op++ = (uint8_t)rest;
    } else {
      *token = (uint8_t)(lit_len << 4);
    }
    std::memcpy(op, anchor, lit_len);
    op += lit_len;
    if (offset) {
      *op++ = (uint8_t)(offset & 0xFF);
      *op++ = (uint8_t)(offset >> 8);
      if (match_len_m4 >= 15) {
        *token |= 15;
        size_t rest = match_len_m4 - 15;
        while (rest >= 255) { *op++ = 255; rest -= 255; }
        *op++ = (uint8_t)rest;
      } else {
        *token |= (uint8_t)match_len_m4;
      }
    }
  };

  if (src_len >= MFLIMIT) {
    const uint8_t* mflimit = iend - MFLIMIT;
    uint32_t* table = (uint32_t*)std::calloc(1u << HASH_LOG, sizeof(uint32_t));
    if (!table) return -1;
    ip++;  // first byte is always a literal
    while (ip <= mflimit) {
      uint32_t h = hash4(read32(ip));
      const uint8_t* match = src + table[h];
      table[h] = (uint32_t)(ip - src);
      if (match < ip && (size_t)(ip - match) <= 65535 &&
          read32(match) == read32(ip)) {
        // extend match forward
        const uint8_t* match_end = iend - LASTLITERALS;
        size_t match_len = MINMATCH;
        while (ip + match_len < match_end &&
               ip[match_len] == match[match_len]) {
          match_len++;
        }
        size_t lit_len = (size_t)(ip - anchor);
        emit_literals_and_match(lit_len, (size_t)(ip - match),
                                match_len - MINMATCH);
        ip += match_len;
        anchor = ip;
      } else {
        ip++;
      }
    }
    std::free(table);
  }
  // trailing literals
  {
    size_t lit_len = (size_t)(iend - anchor);
    uint8_t* token = op++;
    if (lit_len >= 15) {
      *token = (uint8_t)(15 << 4);
      size_t rest = lit_len - 15;
      while (rest >= 255) { *op++ = 255; rest -= 255; }
      *op++ = (uint8_t)rest;
    } else {
      *token = (uint8_t)(lit_len << 4);
    }
    std::memcpy(op, anchor, lit_len);
    op += lit_len;
  }
  return (int64_t)(op - dst);
}

constexpr uint32_t LZ4F_MAGIC = 0x184D2204U;

}  // namespace

extern "C" {

// ------------------------------------------------------------ frame decode
// Decompress an LZ4 frame into dst. Returns decompressed size or -1.
// Supports: content-size field, block checksums (skipped), content
// checksum (skipped), linked or independent blocks.
int64_t lz4f_decompress(const uint8_t* src, size_t src_len,
                        uint8_t* dst, size_t dst_cap) {
  if (src_len < 7) return -1;
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  if (read32(ip) != LZ4F_MAGIC) return -1;
  ip += 4;
  uint8_t flg = *ip++;
  ip++;  // BD byte (block max size) — we rely on dst_cap instead
  if ((flg >> 6) != 1) return -1;  // version must be 01
  bool block_checksum = (flg >> 4) & 1;
  bool content_size = (flg >> 3) & 1;
  bool dict_id = flg & 1;
  if (content_size) ip += 8;
  if (dict_id) ip += 4;
  ip += 1;  // header checksum (not verified on decode)
  if (ip > iend) return -1;

  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  while (true) {
    if (ip + 4 > iend) return -1;
    uint32_t block_size = read32(ip);
    ip += 4;
    if (block_size == 0) break;  // EndMark
    bool uncompressed = block_size >> 31;
    block_size &= 0x7FFFFFFF;
    if (ip + block_size > iend) return -1;
    if (uncompressed) {
      if (op + block_size > oend) return -1;
      std::memcpy(op, ip, block_size);
      op += block_size;
    } else {
      int64_t n = lz4_block_decompress(ip, block_size, op,
                                       (size_t)(oend - op));
      if (n < 0) return -1;
      op += n;
    }
    ip += block_size;
    if (block_checksum) ip += 4;
  }
  return (int64_t)(op - dst);
}

// ------------------------------------------------------------ frame encode
// Compress src into a single-block LZ4 frame with content-size. Returns
// frame size or -1. dst must have capacity lz4f_compress_bound(src_len).
size_t lz4f_compress_bound(size_t src_len) {
  return lz4_compress_bound(src_len) + 32;
}

int64_t lz4f_compress(const uint8_t* src, size_t src_len,
                      uint8_t* dst, size_t dst_cap) {
  if (dst_cap < lz4f_compress_bound(src_len)) return -1;
  uint8_t* op = dst;
  std::memcpy(op, &LZ4F_MAGIC, 4);
  op += 4;
  uint8_t* hdr = op;
  uint8_t flg = (1 << 6) | (1 << 5) | (1 << 3);  // v01, indep blocks, csize
  *op++ = flg;
  *op++ = (uint8_t)(7 << 4);  // BD: 4 MB max block size
  uint64_t csize = src_len;
  std::memcpy(op, &csize, 8);
  op += 8;
  *op++ = (uint8_t)((xxh32(hdr, (size_t)(op - hdr), 0) >> 8) & 0xFF);

  // emit blocks of at most 4 MB
  const size_t kBlock = 4u << 20;
  const uint8_t* ip = src;
  size_t remaining = src_len;
  while (remaining > 0) {
    size_t n = remaining < kBlock ? remaining : kBlock;
    uint8_t* size_slot = op;
    op += 4;
    int64_t c = lz4_block_compress(ip, n, op, (size_t)(dst_cap - (op - dst)));
    uint32_t bsz;
    if (c < 0 || (size_t)c >= n) {
      // incompressible: store raw with high bit set
      std::memcpy(op, ip, n);
      bsz = (uint32_t)n | 0x80000000U;
      op += n;
    } else {
      bsz = (uint32_t)c;
      op += c;
    }
    std::memcpy(size_slot, &bsz, 4);
    ip += n;
    remaining -= n;
  }
  uint32_t endmark = 0;
  std::memcpy(op, &endmark, 4);
  op += 4;
  return (int64_t)(op - dst);
}

uint32_t lz4codec_xxh32(const uint8_t* input, size_t len, uint32_t seed) {
  return xxh32(input, len, seed);
}

}  // extern "C"
