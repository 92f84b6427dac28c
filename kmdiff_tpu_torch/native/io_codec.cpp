// Fused host-IO codecs for kmdiff_tpu_torch: whole-LZ4-frame (de)compression and
// k-mer record AoS<->SoA (re)packing in one native pass.
//
// The per-partition per-sample count files (kmtricks format, reference:
// include/kmdiff/kmtricks_utils.hpp:44-62 + the lz4_stream framing of
// accumulator.hpp:165-166) hold fixed-width records
//   [nw x u64 k-mer words (LE)] [slots x count (LE, 1/2/4 bytes)]
// inside a standard LZ4 frame. Decoding them through Python block loops +
// numpy strided copies moved every byte ~5x at this host's page-fault-bound
// copy speed; these entry points do frame decode and the record split in a
// single pass each, called once per file via ctypes
// (kmdiff_tpu_torch/native/__init__.py).
//
// Assumes a little-endian host (the numpy paths make the same assumption via
// '<u8'/'<u4' views).

#include <cstdint>
#include <cstring>

extern "C" {
// from lz4_codec.cpp
long lz4_compress_block(const uint8_t* src, long src_len, uint8_t* dst,
                        long dst_cap);
long lz4_compress_bound(long n);
}

namespace {

// ---------------------------------------------------------------------------
// xxh32 (needed for the LZ4 frame header checksum byte), clean-room per the
// public xxHash spec — mirrors kmdiff_tpu_torch/utils/xxhash.py.
// ---------------------------------------------------------------------------

constexpr uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                   P4 = 668265263u, P5 = 374761393u;

inline uint32_t rotl32(uint32_t v, int r) { return (v << r) | (v >> (32 - r)); }

inline uint32_t read32le(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint32_t xxh32(const uint8_t* p, size_t len, uint32_t seed) {
  const uint8_t* end = p + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + read32le(p) * P2, 13) * P1;
      v2 = rotl32(v2 + read32le(p + 4) * P2, 13) * P1;
      v3 = rotl32(v3 + read32le(p + 8) * P2, 13) * P1;
      v4 = rotl32(v4 + read32le(p + 12) * P2, 13) * P1;
      p += 16;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) {
    h = rotl32(h + read32le(p) * P3, 17) * P4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p++) * P5, 11) * P1;
  }
  h ^= h >> 15;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  h ^= h >> 16;
  return h;
}

// Decompress one LZ4 block at base+pos; matches may reference the already
// decoded prefix [0, pos) (block-DEPENDENT frames decode correctly through a
// contiguous destination, which the Python per-block path cannot do).
long decompress_block_at(const uint8_t* src, long src_len, uint8_t* base,
                         long pos, long cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  uint8_t* op = base + pos;
  uint8_t* const oend = base + cap;

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
    if (ip >= iend) break;  // last sequence: literals only

    if (ip + 2 > iend) return -1;
    const uint32_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - base < (long)offset) return -1;

    long match_len = token & 15;
    if (match_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        match_len += b;
      } while (b == 255);
    }
    match_len += 4;
    if (op + match_len > oend) return -2;

    const uint8_t* match = op - offset;
    if (offset >= 8) {
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
  return op - (base + pos);
}

}  // namespace

extern "C" {

// Decode a complete LZ4 frame (magic..end-mark) into dst. Returns the
// decoded byte count, -1 on malformed input, -2 when dst_cap is too small
// (caller grows and retries).
long lz4_frame_decompress(const uint8_t* src, long src_len, uint8_t* dst,
                          long dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  if (iend - ip < 7) return -1;
  if (read32le(ip) != 0x184D2204u) return -1;
  ip += 4;
  const uint8_t flg = *ip++;
  ip++;  // BD byte: the block max size only bounds block sizes we see anyway
  if ((flg >> 6) != 1) return -1;
  const bool block_checksum = flg & 0x10;
  const bool content_size = flg & 0x08;
  const bool content_checksum = flg & 0x04;
  const bool dict_id = flg & 0x01;
  if (content_size) {
    if (iend - ip < 8) return -1;
    uint64_t csize;
    std::memcpy(&csize, ip, 8);
    if ((long)csize > dst_cap) return -2;
    ip += 8;
  }
  if (dict_id) {
    if (iend - ip < 4) return -1;
    ip += 4;
  }
  if (ip >= iend) return -1;
  ip++;  // header checksum byte (not verified, like the Python reader)

  long pos = 0;
  while (true) {
    if (iend - ip < 4) return -1;
    uint32_t bsize = read32le(ip);
    ip += 4;
    if (bsize == 0) break;  // end mark
    const bool stored = bsize & 0x80000000u;
    bsize &= 0x7FFFFFFFu;
    if (iend - ip < (long)bsize) return -1;
    if (stored) {
      if (pos + (long)bsize > dst_cap) return -2;
      std::memcpy(dst + pos, ip, bsize);
      pos += bsize;
    } else {
      const long n = decompress_block_at(ip, bsize, dst, pos, dst_cap);
      if (n < 0) return n;
      pos += n;
    }
    ip += bsize;
    if (block_checksum) {
      if (iend - ip < 4) return -1;
      ip += 4;
    }
  }
  if (content_checksum && iend - ip < 4) return -1;
  return pos;
}

// Decompress one block of a block-LINKED frame for the STREAMING reader:
// `buf` holds `hist_len` bytes of previously-decoded history at its start;
// the block decodes into buf+hist_len (capacity dst_cap total including the
// history) and its matches may reach back into the window. Returns bytes
// written past the history, or -1 malformed / -2 overflow.
long lz4_decompress_block_continue(const uint8_t* src, long src_len,
                                   uint8_t* buf, long hist_len,
                                   long dst_cap) {
  if (hist_len < 0 || hist_len > dst_cap) return -1;
  return decompress_block_at(src, src_len, buf, hist_len, dst_cap);
}

// Worst-case frame size for lz4_frame_compress (headers + per-block bound).
long lz4_frame_compress_bound(long n, long block_size) {
  if (block_size <= 0) block_size = 1 << 16;
  const long blocks = n / block_size + 1;
  return 7 + 8 + lz4_compress_bound(n) + 4 * (blocks + 1) + 16;
}

// Compress src into a standard LZ4 frame (block-independent, no checksums —
// the exact framing Lz4FrameWriter produces). mode 0 = store (uncompressed
// blocks), 1 = fast (greedy LZ4, falling back to stored blocks when
// compression does not shrink). Returns the frame size or -2 when dst_cap
// is too small.
long lz4_frame_compress(const uint8_t* src, long src_len, uint8_t* dst,
                        long dst_cap, int mode, long block_size) {
  if (block_size <= 0) block_size = 1 << 16;
  int bmax;
  long cap;
  if (block_size <= (1 << 16)) {
    bmax = 4;
    cap = 1 << 16;
  } else if (block_size <= (1 << 18)) {
    bmax = 5;
    cap = 1 << 18;
  } else if (block_size <= (1 << 20)) {
    bmax = 6;
    cap = 1 << 20;
  } else {
    bmax = 7;
    cap = 1 << 22;
  }
  if (block_size > cap) block_size = cap;

  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  if (oend - op < 7) return -2;
  const uint32_t magic = 0x184D2204u;
  std::memcpy(op, &magic, 4);
  op += 4;
  const uint8_t flg = (1 << 6) | 0x20;  // version 01, block-independent
  const uint8_t bd = (uint8_t)(bmax << 4);
  op[0] = flg;
  op[1] = bd;
  const uint8_t hdr[2] = {flg, bd};
  op[2] = (uint8_t)((xxh32(hdr, 2, 0) >> 8) & 0xFF);
  op += 3;

  for (long off = 0; off < src_len; off += block_size) {
    const long raw = src_len - off < block_size ? src_len - off : block_size;
    if (oend - op < 4) return -2;
    uint8_t* const sizep = op;
    op += 4;
    long written = -1;
    if (mode == 1) {
      written = lz4_compress_block(src + off, raw, op, oend - op);
      if (written >= raw) written = -1;  // compression did not help
    }
    uint32_t bsize;
    if (written > 0) {
      bsize = (uint32_t)written;
    } else {
      if (oend - op < raw) return -2;
      std::memcpy(op, src + off, raw);
      written = raw;
      bsize = (uint32_t)raw | 0x80000000u;
    }
    std::memcpy(sizep, &bsize, 4);
    op += written;
  }
  if (oend - op < 4) return -2;
  std::memset(op, 0, 4);  // end mark
  op += 4;
  return op - dst;
}

// Split n fixed-width records into kmer words and counts:
//   payload record = [nw x u64 LE][slots x cbytes LE]
//   kmers  out: [n * nw] u64, counts out: [n * slots] u32 (widened).
// cbytes outside {1, 2, 4} is rejected (-1): a wider memcpy into the
// 4-byte widening temporary would be an out-of-bounds write, and file
// headers are untrusted input.
long split_kmer_records(const uint8_t* payload, long n, int nw, int cbytes,
                        int slots, uint64_t* kmers, uint32_t* counts) {
  if ((cbytes != 1 && cbytes != 2 && cbytes != 4) || nw < 1 || slots < 1) {
    return -1;
  }
  const long rec = (long)nw * 8 + (long)cbytes * slots;
  const uint8_t* p = payload;
  if (nw == 1 && slots == 1 && cbytes == 1) {
    for (long i = 0; i < n; ++i, p += rec) {
      std::memcpy(&kmers[i], p, 8);
      counts[i] = p[8];
    }
    return n;
  }
  if (nw == 1 && slots == 1 && cbytes == 2) {
    for (long i = 0; i < n; ++i, p += rec) {
      std::memcpy(&kmers[i], p, 8);
      uint16_t c;
      std::memcpy(&c, p + 8, 2);
      counts[i] = c;
    }
    return n;
  }
  if (nw == 1 && slots == 1 && cbytes == 4) {
    for (long i = 0; i < n; ++i, p += rec) {
      std::memcpy(&kmers[i], p, 8);
      std::memcpy(&counts[i], p + 8, 4);
    }
    return n;
  }
  for (long i = 0; i < n; ++i, p += rec) {
    std::memcpy(&kmers[(long)i * nw], p, (size_t)nw * 8);
    const uint8_t* cp = p + (long)nw * 8;
    for (int s = 0; s < slots; ++s, cp += cbytes) {
      uint32_t c = 0;
      std::memcpy(&c, cp, cbytes);
      counts[(long)i * slots + s] = c;
    }
  }
  return n;
}

// K-way merge of m k-mer-sorted (kmer[nw] asc, count) streams, summing the
// counts of equal k-mers — the host combiner for device count chunks
// (pipeline.count.count_sample_device sorts each <=8M-row chunk on device
// and merges the distinct streams here). kmers: concatenated [N, nw] u64
// rows (word 0 most significant); offsets: [m+1] row bounds per stream.
// Writes at most N rows to out_k/out_c; returns merged row count, or -1
// when m exceeds the stream cap.
long merge_counted_streams(const uint64_t* kmers, const uint32_t* counts,
                           const long* offsets, int m, int nw,
                           uint64_t* out_k, uint32_t* out_c) {
  constexpr int MAX_STREAMS = 64;
  if (m < 0 || m > MAX_STREAMS) return -1;
  long pos[MAX_STREAMS];
  for (int s = 0; s < m; ++s) pos[s] = offsets[s];

  auto kless = [&](const uint64_t* a, const uint64_t* b) {
    for (int w = 0; w < nw; ++w) {
      if (a[w] != b[w]) return a[w] < b[w];
    }
    return false;
  };
  auto keq = [&](const uint64_t* a, const uint64_t* b) {
    for (int w = 0; w < nw; ++w) {
      if (a[w] != b[w]) return false;
    }
    return true;
  };

  long out = -1;
  while (true) {
    int best = -1;
    for (int s = 0; s < m; ++s) {
      if (pos[s] >= offsets[s + 1]) continue;
      if (best < 0 || kless(kmers + pos[s] * nw, kmers + pos[best] * nw)) {
        best = s;
      }
    }
    if (best < 0) break;
    const uint64_t* kp = kmers + pos[best] * nw;
    if (out >= 0 && keq(out_k + out * nw, kp)) {
      out_c[out] += counts[pos[best]];
    } else {
      ++out;
      std::memcpy(out_k + out * nw, kp, (size_t)nw * 8);
      out_c[out] = counts[pos[best]];
    }
    ++pos[best];
  }
  return out + 1;
}

// Stable counting-sort regroup by partition id: two passes instead of a
// general argsort + three fancy gathers (pipeline.count._regroup_by_
// partition's numpy fallback — measured 0.8-2.6 s per 8M-row sample on
// fault-bound hosts). parts values must be < nparts. Preserves the
// incoming (k-mer-sorted) order inside every partition.
long partition_regroup(const uint32_t* parts, const uint64_t* kmers,
                       const uint32_t* counts, long n, int nw, int nparts,
                       uint64_t* out_k, uint32_t* out_p, uint32_t* out_c) {
  if (nparts <= 0 || nparts > (1 << 20)) return -1;
  long* off = new long[nparts + 1]();
  for (long i = 0; i < n; ++i) {
    if (parts[i] >= (uint32_t)nparts) {
      delete[] off;
      return -2;
    }
    ++off[parts[i] + 1];
  }
  for (int p = 0; p < nparts; ++p) off[p + 1] += off[p];
  for (long i = 0; i < n; ++i) {
    const long d = off[parts[i]]++;
    std::memcpy(out_k + d * nw, kmers + i * nw, (size_t)nw * 8);
    out_p[d] = parts[i];
    out_c[d] = counts[i];
  }
  delete[] off;
  return n;
}

// Inverse of split_kmer_records: interleave kmer words and (narrowed)
// counts back into the record payload.
long pack_kmer_records(const uint64_t* kmers, const uint32_t* counts, long n,
                       int nw, int cbytes, int slots, uint8_t* payload) {
  if ((cbytes != 1 && cbytes != 2 && cbytes != 4) || nw < 1 || slots < 1) {
    return -1;
  }
  const long rec = (long)nw * 8 + (long)cbytes * slots;
  uint8_t* p = payload;
  if (nw == 1 && slots == 1 && cbytes <= 4) {
    for (long i = 0; i < n; ++i, p += rec) {
      std::memcpy(p, &kmers[i], 8);
      std::memcpy(p + 8, &counts[i], cbytes);
    }
    return n * rec;
  }
  for (long i = 0; i < n; ++i, p += rec) {
    std::memcpy(p, &kmers[(long)i * nw], (size_t)nw * 8);
    uint8_t* cp = p + (long)nw * 8;
    for (int s = 0; s < slots; ++s, cp += cbytes) {
      std::memcpy(cp, &counts[(long)i * slots + s], cbytes);
    }
  }
  return n * rec;
}

}  // extern "C"
