// Native LZ4 block codec for the host IO of kmdiff_tpu_torch.
//
// Clean-room implementation of the public LZ4 block format
// (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md), exposed
// through a plain C ABI consumed via ctypes (kmdiff_tpu_torch/native/__init__.py).
// Replaces the pure-Python fallback in kmdiff_tpu_torch/io/lz4.py on the hot host
// paths: decoding kmtricks partition count files and writing accumulator
// spills (the reference links the upstream lz4 C library for the same jobs,
// reference: thirdparty/CMakeLists.txt:103-115, accumulator.hpp:165-166).
//
// Build: kmdiff_tpu_torch/native/Makefile, run by the loader at first use
// into build/kmdiff_tpu_torch/native/ (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>

namespace {

constexpr int MINMATCH = 4;
constexpr int MFLIMIT = 12;     // last 12 bytes are always literals
constexpr int LASTLITERALS = 5; // no match may cover the last 5 bytes
constexpr int HASH_LOG = 13;  // 32 KiB table: cheap to clear per block

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - HASH_LOG);
}

}  // namespace

extern "C" {

// Decompress one LZ4 block. Returns number of bytes written to dst, or a
// negative error code (-1 malformed, -2 dst overflow).
long lz4_decompress_block(const uint8_t* src, long src_len, uint8_t* dst,
                          long dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  while (ip < iend) {
    const uint8_t token = *ip++;
    long lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit_len += b;
      } while (b == 255);
    }
    if (ip + lit_len > iend) return -1;
    if (op + lit_len > oend) return -2;
    std::memcpy(op, ip, lit_len);
    ip += lit_len;
    op += lit_len;
    if (ip >= iend) break;  // last sequence has no match

    if (ip + 2 > iend) return -1;
    const uint32_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < (long)offset) return -1;

    long match_len = token & 15;
    if (match_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        match_len += b;
      } while (b == 255);
    }
    match_len += MINMATCH;
    if (op + match_len > oend) return -2;

    const uint8_t* match = op - offset;
    if (offset >= 8) {
      // non-overlapping fast copy
      long n = match_len;
      while (n >= 8) {
        std::memcpy(op, match, 8);
        op += 8;
        match += 8;
        n -= 8;
      }
      while (n--) *op++ = *match++;
    } else {
      for (long i = 0; i < match_len; ++i) op[i] = match[i];
      op += match_len;
    }
  }
  return op - dst;
}

// Greedy single-pass compressor (hash-chain-free, like LZ4_compress_fast).
// Returns compressed size, or negative if dst_cap too small.
long lz4_compress_block(const uint8_t* src, long src_len, uint8_t* dst,
                        long dst_cap) {
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  const uint8_t* anchor = src;

  auto emit = [&](const uint8_t* lit, long lit_len, long match_off,
                  long match_len) -> bool {
    long token_bytes = 1 + lit_len / 255 + 1 + (match_len > 0 ? 2 + match_len / 255 + 1 : 0);
    if (op + token_bytes + lit_len > oend) return false;
    uint8_t* token = op++;
    long ll = lit_len;
    if (ll >= 15) {
      *token = 15 << 4;
      ll -= 15;
      while (ll >= 255) {
        *op++ = 255;
        ll -= 255;
      }
      *op++ = (uint8_t)ll;
    } else {
      *token = (uint8_t)(ll << 4);
    }
    std::memcpy(op, lit, lit_len);
    op += lit_len;
    if (match_len > 0) {
      *op++ = (uint8_t)(match_off & 0xff);
      *op++ = (uint8_t)(match_off >> 8);
      long ml = match_len - MINMATCH;
      if (ml >= 15) {
        *token |= 15;
        ml -= 15;
        while (ml >= 255) {
          *op++ = 255;
          ml -= 255;
        }
        *op++ = (uint8_t)ml;
      } else {
        *token |= (uint8_t)ml;
      }
    }
    return true;
  };

  if (src_len < MFLIMIT + 1) {
    if (!emit(anchor, src_len, 0, 0)) return -1;
    return op - dst;
  }

  static thread_local uint32_t table[1 << HASH_LOG];
  std::memset(table, 0, sizeof(table));
  const uint8_t* const mflimit = iend - MFLIMIT;

  ip++;  // first byte can't match (table holds offset+1, 0 = empty)
  while (ip <= mflimit) {
    const uint32_t h = hash4(read32(ip));
    const uint8_t* match = src + table[h] - 1;
    const bool has = table[h] != 0;
    table[h] = (uint32_t)(ip - src) + 1;
    if (has && ip - match <= 0xffff && read32(match) == read32(ip)) {
      // extend match forward (respect the 5-byte tail rule)
      const uint8_t* const matchlimit = iend - LASTLITERALS;
      const uint8_t* p = ip + MINMATCH;
      const uint8_t* m = match + MINMATCH;
      while (p < matchlimit && *p == *m) {
        ++p;
        ++m;
      }
      long match_len = p - ip;
      if (!emit(anchor, ip - anchor, ip - match, match_len)) return -1;
      ip += match_len;
      anchor = ip;
      if (ip > mflimit) break;
      // prime the table at the new position
      table[hash4(read32(ip - 2))] = (uint32_t)(ip - 2 - src) + 1;
    } else {
      ++ip;
    }
  }
  if (!emit(anchor, iend - anchor, 0, 0)) return -1;
  return op - dst;
}

long lz4_compress_bound(long n) { return n + n / 255 + 16; }

const char* kmdiff_native_info() {
  return "lz4-codec/2 io-codec/1 (clean-room, C++17)";
}

}  // extern "C"
