// gcio — native I/O core for the consensus engine.
//
// Replaces the role htslib plays for the reference implementation
// (reference links -lhts; this engine does not use htslib, and it
// wants a parallel decode path anyway): multithreaded BGZF inflate/deflate
// with zlib, BAM record-boundary scanning, and batched record
// assembly helpers. Exposed as a C ABI for ctypes (no pybind11 in image).
//
// Layout contract with gencore_tpu/io/bam.py:
//   decode: returns (payload bytes, record offsets) — the Python RecordBatch
//   does vectorized field gathers on top.
//   encode: takes a fully assembled uncompressed payload and writes BGZF.

#ifdef __linux__
#include <sched.h>
#endif

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// Raw-DEFLATE codec (zlib) for one BGZF block at a time, one object per
// thread.
class Inflater {
 public:
  Inflater() { ok_ = inflateInit2(&zs_, -15) == Z_OK; }
  ~Inflater() { if (ok_) inflateEnd(&zs_); }
  // true when `in` inflates to exactly out_len bytes
  bool run(const uint8_t* in, size_t in_len, uint8_t* out, size_t out_len) {
    if (!ok_ || inflateReset(&zs_) != Z_OK) return false;
    zs_.next_in = const_cast<Bytef*>(in);
    zs_.avail_in = static_cast<uInt>(in_len);
    zs_.next_out = out;
    zs_.avail_out = static_cast<uInt>(out_len);
    return inflate(&zs_, Z_FINISH) == Z_STREAM_END && zs_.total_out == out_len;
  }

 private:
  z_stream zs_{};
  bool ok_;
};

class Deflater {
 public:
  explicit Deflater(int level) {
    ok_ = deflateInit2(&zs_, level, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) == Z_OK;
  }
  ~Deflater() { if (ok_) deflateEnd(&zs_); }
  size_t bound(size_t n) { return ok_ ? deflateBound(&zs_, n) : 0; }
  // compressed size, 0 on failure
  size_t run(const uint8_t* in, size_t in_len, uint8_t* out, size_t cap) {
    if (!ok_ || deflateReset(&zs_) != Z_OK) return 0;
    zs_.next_in = const_cast<Bytef*>(in);
    zs_.avail_in = static_cast<uInt>(in_len);
    zs_.next_out = out;
    zs_.avail_out = static_cast<uInt>(cap);
    return deflate(&zs_, Z_FINISH) == Z_STREAM_END ? zs_.total_out : 0;
  }

 private:
  z_stream zs_{};
  bool ok_;
};

uint32_t block_crc32(const uint8_t* p, size_t n) {
  return static_cast<uint32_t>(crc32(0, p, static_cast<uInt>(n)));
}

struct Block {
  size_t file_off;   // offset of the block start within the file buffer
  size_t comp_off;   // offset of deflate data within file buffer
  size_t comp_len;
  size_t out_off;    // offset in output buffer
  size_t out_len;    // ISIZE
};

constexpr uint8_t kBgzfEof[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
    0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};

int hw_threads(int requested) {
  if (requested > 0) return requested;
  // respect cpu affinity (taskset-pinned multi-host processes must not
  // oversubscribe their core); hardware_concurrency ignores it
#ifdef __linux__
  cpu_set_t s;
  if (sched_getaffinity(0, sizeof(s), &s) == 0) {
    int n = CPU_COUNT(&s);
    if (n > 0) return n;
  }
#endif
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 2;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(sz);
  bool ok = sz == 0 || fread(out->data(), 1, sz, f) == static_cast<size_t>(sz);
  fclose(f);
  return ok;
}

// Parse BGZF block table. Returns false on malformed data.
bool scan_blocks(const std::vector<uint8_t>& buf, std::vector<Block>* blocks,
                 size_t* total_out) {
  size_t pos = 0;
  size_t out_off = 0;
  const size_t n = buf.size();
  while (pos + 18 <= n) {
    if (buf[pos] != 0x1f || buf[pos + 1] != 0x8b) return false;
    uint8_t flg = buf[pos + 3];
    if (!(flg & 4)) return false;  // need FEXTRA for BGZF
    uint16_t xlen;
    memcpy(&xlen, &buf[pos + 10], 2);
    size_t xpos = pos + 12, xend = xpos + xlen;
    size_t bsize = 0;
    while (xpos + 4 <= xend && xend <= n) {
      uint8_t si1 = buf[xpos], si2 = buf[xpos + 1];
      uint16_t slen;
      memcpy(&slen, &buf[xpos + 2], 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t b16;
        memcpy(&b16, &buf[xpos + 4], 2);
        bsize = static_cast<size_t>(b16) + 1;
      }
      xpos += 4 + slen;
    }
    if (bsize == 0 || pos + bsize > n) return false;
    uint32_t isize;
    memcpy(&isize, &buf[pos + bsize - 4], 4);
    Block b;
    b.file_off = pos;
    b.comp_off = pos + 12 + xlen;
    b.comp_len = bsize - (12 + xlen) - 8;
    b.out_off = out_off;
    b.out_len = isize;
    blocks->push_back(b);
    out_off += isize;
    pos += bsize;
  }
  *total_out = out_off;
  return pos == n;
}

}  // namespace

extern "C" {

// ------------------------- decompression -------------------------

// Decompress a whole BGZF file into a malloc'd buffer (caller frees with
// gc_free). Returns nullptr on error. *out_len receives the size.
uint8_t* gc_bgzf_read(const char* path, int64_t* out_len, int n_threads) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return nullptr;
  std::vector<Block> blocks;
  size_t total = 0;
  if (!scan_blocks(file, &blocks, &total)) return nullptr;
  uint8_t* out = static_cast<uint8_t*>(malloc(total ? total : 1));
  if (!out) return nullptr;

  int nt = hw_threads(n_threads);
  std::atomic<size_t> next(0);
  std::atomic<bool> failed(false);
  auto worker = [&]() {
    Inflater d;
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || failed.load(std::memory_order_relaxed)) break;
      const Block& b = blocks[i];
      if (b.out_len == 0) continue;
      if (!d.run(file.data() + b.comp_off, b.comp_len, out + b.out_off,
                 b.out_len))
        failed.store(true);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  if (failed.load()) {
    free(out);
    return nullptr;
  }
  *out_len = static_cast<int64_t>(total);
  return out;
}

// BGZF block table: fills blocks[i*2] = file offset of block i,
// blocks[i*2+1] = uncompressed (output) offset. Returns block count
// (plus total uncompressed size in *total_out), -1 on malformed data,
// -2 when cap is too small.
int64_t gc_bgzf_block_table(const char* path, int64_t* table, int64_t cap,
                            int64_t* total_out) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return -1;
  std::vector<Block> blocks;
  size_t total = 0;
  if (!scan_blocks(file, &blocks, &total)) return -1;
  if (static_cast<int64_t>(blocks.size()) > cap) return -2;
  for (size_t i = 0; i < blocks.size(); ++i) {
    // (block file start, uncompressed offset): the file start lets
    // ranged readers (gc_bgzf_read_span) pread exactly one span's bytes
    table[2 * i] = static_cast<int64_t>(blocks[i].file_off);
    table[2 * i + 1] = static_cast<int64_t>(blocks[i].out_off);
  }
  *total_out = static_cast<int64_t>(total);
  return static_cast<int64_t>(blocks.size());
}

// Decompress BGZF blocks [block_lo, block_hi) of `path` into out
// (caller-sized from the block table). Returns 0 on success.
int gc_bgzf_read_blocks(const char* path, int64_t block_lo, int64_t block_hi,
                        uint8_t* out, int64_t out_cap, int n_threads) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return -1;
  std::vector<Block> blocks;
  size_t total = 0;
  if (!scan_blocks(file, &blocks, &total)) return -1;
  if (block_lo < 0 || block_hi > static_cast<int64_t>(blocks.size()) ||
      block_lo > block_hi)
    return -2;
  size_t base = blocks.empty() || block_lo == block_hi
                    ? 0 : blocks[block_lo].out_off;
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(block_lo);
  std::atomic<bool> failed(false);
  auto worker = [&]() {
    Inflater d;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= block_hi || failed.load(std::memory_order_relaxed)) break;
      const Block& b = blocks[i];
      if (b.out_len == 0) continue;
      if (static_cast<int64_t>(b.out_off - base + b.out_len) > out_cap) {
        failed.store(true);
        break;
      }
      if (!d.run(file.data() + b.comp_off, b.comp_len,
                 out + (b.out_off - base), b.out_len))
        failed.store(true);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return failed.load() ? -3 : 0;
}

// Decompress the BGZF blocks whose bytes span [file_lo, file_hi) of
// `path` into out. Unlike gc_bgzf_read_blocks this reads ONLY that span
// from disk (file_lo must be a block start, file_hi a block start or the
// file end — both straight from the gc_bgzf_block_table output), so a
// streaming caller's I/O and residency stay O(span), not O(file).
int gc_bgzf_read_span(const char* path, int64_t file_lo, int64_t file_hi,
                      uint8_t* out, int64_t out_cap, int n_threads) {
  if (file_lo < 0 || file_hi < file_lo) return -2;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint8_t> buf(static_cast<size_t>(file_hi - file_lo));
  bool ok = true;
  if (!buf.empty()) {
    if (fseek(f, static_cast<long>(file_lo), SEEK_SET) != 0) ok = false;
    if (ok && fread(buf.data(), 1, buf.size(), f) != buf.size()) ok = false;
  }
  fclose(f);
  if (!ok) return -1;
  std::vector<Block> blocks;
  size_t total = 0;
  if (!scan_blocks(buf, &blocks, &total)) return -1;
  if (static_cast<int64_t>(total) > out_cap) return -2;
  int nt = hw_threads(n_threads);
  std::atomic<size_t> next(0);
  std::atomic<bool> failed(false);
  auto worker = [&]() {
    Inflater d;
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || failed.load(std::memory_order_relaxed)) break;
      const Block& b = blocks[i];
      if (b.out_len == 0) continue;
      if (!d.run(buf.data() + b.comp_off, b.comp_len, out + b.out_off,
                 b.out_len))
        failed.store(true);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return failed.load() ? -3 : 0;
}

// Scan a decompressed BAM payload for record boundaries starting at
// body_start. Fills offsets[0..n] (byte offsets of record bodies, relative
// to payload start; offsets[n] = payload end). Returns record count, or -1
// if the payload is truncated/corrupt. offsets_cap is the capacity of the
// offsets array (entries).
int64_t gc_bam_scan(const uint8_t* payload, int64_t len, int64_t body_start,
                    int64_t* offsets, int64_t offsets_cap) {
  int64_t p = body_start;
  int64_t n = 0;
  while (p + 4 <= len) {
    int32_t bs;
    memcpy(&bs, payload + p, 4);
    if (bs < 32 || p + 4 + bs > len) return -1;
    if (n + 1 >= offsets_cap) return -2;  // caller must grow
    offsets[n] = p + 4;
    ++n;
    p += 4 + bs;
  }
  if (p != len) return -1;
  offsets[n] = len;  // sentinel: end (note: includes the 4-byte gaps)
  return n;
}

// Like gc_bam_scan but stops cleanly at a trailing partial record instead
// of failing: used by the streaming index pass, whose fixed-size chunks cut
// records mid-stream (the caller carries the tail into the next chunk).
// *consumed = bytes of complete records handled; offsets[n] = consumed.
int64_t gc_bam_scan_partial(const uint8_t* payload, int64_t len,
                            int64_t body_start, int64_t* offsets,
                            int64_t offsets_cap, int64_t* consumed) {
  int64_t p = body_start;
  int64_t n = 0;
  while (p + 4 <= len) {
    int32_t bs;
    memcpy(&bs, payload + p, 4);
    if (bs < 32) return -1;
    if (p + 4 + bs > len) break;
    if (n + 1 >= offsets_cap) return -2;  // caller must grow
    offsets[n] = p + 4;
    ++n;
    p += 4 + bs;
  }
  offsets[n] = p;
  *consumed = p;
  return n;
}

// One-pass streaming index: boundary-scan complete records (exactly
// gc_bam_scan_partial's contract) AND extract the window-planner columns
// plus the NM tag value in the same call. The serial boundary walk is one
// compare per record; the column/NM extraction then runs threaded over
// record ranges. nm = 0 when the tag is absent (matching the engine's
// vectorized _extract_nm default); integer NM types cCsSiI are decoded
// with their signedness.
static int32_t read_nm_value(const uint8_t* p, const uint8_t* end) {
  while (p + 3 <= end) {
    uint8_t t0 = p[0], t1 = p[1];
    char ty = (char)p[2];
    const uint8_t* v = p + 3;
    int64_t sz;
    switch (ty) {
      case 'c': case 'C': case 'A': sz = 1; break;
      case 's': case 'S': sz = 2; break;
      case 'i': case 'I': case 'f': sz = 4; break;
      case 'd': sz = 8; break;
      case 'Z': case 'H': {
        const uint8_t* z =
            static_cast<const uint8_t*>(memchr(v, 0, end - v));
        sz = z ? (z - v + 1) : (end - v);
        break;
      }
      case 'B': {
        if (v + 5 > end) return 0;
        char st = (char)v[0];
        uint32_t cnt;
        memcpy(&cnt, v + 1, 4);
        int es = (st == 'c' || st == 'C') ? 1
                 : (st == 's' || st == 'S') ? 2 : 4;
        sz = 5 + (int64_t)cnt * es;
        break;
      }
      default: return 0;  // unknown type: stop walking
    }
    if (v + sz > end) return 0;
    if (t0 == 'N' && t1 == 'M') {
      switch (ty) {
        case 'C': return v[0];
        case 'c': return (int8_t)v[0];
        case 'S': { uint16_t x; memcpy(&x, v, 2); return x; }
        case 's': { int16_t x; memcpy(&x, v, 2); return x; }
        case 'I': { uint32_t x; memcpy(&x, v, 4); return (int32_t)x; }
        case 'i': { int32_t x; memcpy(&x, v, 4); return x; }
        default: return 0;
      }
    }
    p = v + sz;
  }
  return 0;
}

// Engine-side NM extraction: value + patch offset of the 1-byte 'C'
// value (-1 when absent or not C-typed — the reference patches only
// then, group.cpp:569). Same aux walk as read_nm_value.
void gc_nm_extract(const uint8_t* data, const int64_t* aux_off,
                   const int64_t* end, int64_t n, int64_t* vals,
                   int64_t* patch, int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 2048;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        vals[i] = 0;
        patch[i] = -1;
        const uint8_t* p = data + aux_off[i];
        const uint8_t* e = data + end[i];
        while (p + 3 <= e) {
          uint8_t t0 = p[0], t1 = p[1];
          char ty = (char)p[2];
          const uint8_t* v = p + 3;
          int64_t sz;
          switch (ty) {
            case 'c': case 'C': case 'A': sz = 1; break;
            case 's': case 'S': sz = 2; break;
            case 'i': case 'I': case 'f': sz = 4; break;
            case 'd': sz = 8; break;
            case 'Z': case 'H': {
              const uint8_t* z =
                  static_cast<const uint8_t*>(memchr(v, 0, e - v));
              sz = z ? (z - v + 1) : (e - v);
              break;
            }
            case 'B': {
              if (v + 5 > e) { sz = e - v; break; }
              char st = (char)v[0];
              uint32_t cnt;
              memcpy(&cnt, v + 1, 4);
              int es = (st == 'c' || st == 'C') ? 1
                       : (st == 's' || st == 'S') ? 2 : 4;
              sz = 5 + (int64_t)cnt * es;
              break;
            }
            default: sz = e - v; break;  // unknown type: stop walking
          }
          if (v + sz > e) break;
          if (t0 == 'N' && t1 == 'M') {
            switch (ty) {
              case 'C': vals[i] = v[0]; patch[i] = v - data; break;
              case 'c': vals[i] = (int8_t)v[0]; break;
              case 'S': { uint16_t x; memcpy(&x, v, 2); vals[i] = x; break; }
              case 's': { int16_t x; memcpy(&x, v, 2); vals[i] = x; break; }
              case 'I': { uint32_t x; memcpy(&x, v, 4);
                          vals[i] = (int64_t)x; break; }
              case 'i': { int32_t x; memcpy(&x, v, 4); vals[i] = x; break; }
              default: break;
            }
            break;
          }
          p = v + sz;
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

int64_t gc_bam_index(const uint8_t* payload, int64_t len, int64_t body_start,
                     int64_t* offsets, int64_t offsets_cap, int64_t* consumed,
                     int32_t* tid, int32_t* pos, int32_t* mtid, int32_t* mpos,
                     int32_t* isize, int32_t* flag, int32_t* l_qseq,
                     int32_t* nm, int n_threads) {
  int64_t p = body_start;
  int64_t n = 0;
  while (p + 4 <= len) {
    int32_t bs;
    memcpy(&bs, payload + p, 4);
    if (bs < 32) return -1;
    if (p + 4 + bs > len) break;
    if (n + 1 >= offsets_cap) return -2;  // caller must grow
    offsets[n] = p + 4;
    ++n;
    p += 4 + bs;
  }
  offsets[n] = p;
  *consumed = p;

  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 2048;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* r = payload + offsets[i];
        const uint8_t* rend =
            payload + (i + 1 < n ? offsets[i + 1] - 4 : *consumed);
        int32_t v;
        memcpy(&v, r + 0, 4); tid[i] = v;
        memcpy(&v, r + 4, 4); pos[i] = v;
        uint8_t l_read_name = r[8];
        uint16_t ncig, fl;
        memcpy(&ncig, r + 12, 2);
        memcpy(&fl, r + 14, 2);
        flag[i] = fl;
        int32_t lq;
        memcpy(&lq, r + 16, 4); l_qseq[i] = lq;
        memcpy(&v, r + 20, 4); mtid[i] = v;
        memcpy(&v, r + 24, 4); mpos[i] = v;
        memcpy(&v, r + 28, 4); isize[i] = v;
        const uint8_t* aux = r + 32 + l_read_name + 4 * (int64_t)ncig +
                             (lq + 1) / 2 + lq;
        nm[i] = (aux <= rend) ? read_nm_value(aux, rend) : 0;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return n;
}

// Genome-reference row diff for the sparse upload: row i (4-bit packed
// nibbles, lens[i] bases) is compared against NT16(genome[gpos[i]+j])
// using the engine's ASCII->NT16 map (A=1 C=2 G=4 T=8, else 0); up to
// `cap` (pos, row-nibble) edits are emitted, cnt 255 marks overflow and
// cnt 254 marks rows with gpos < 0 (ineligible). A row reconstructed on
// device as genome-slice + these edits is then bit-exact.
void gc_ref_edits(const uint8_t* packed, int64_t n, int64_t pw,
                  const int32_t* lens, const uint8_t* genome, int64_t glen,
                  const int64_t* gpos, int cap, uint8_t* cnt, uint8_t* pos,
                  uint8_t* code, int n_threads) {
  uint8_t nt16[256];
  memset(nt16, 0, sizeof(nt16));
  nt16[(unsigned char)'A'] = 1;
  nt16[(unsigned char)'C'] = 2;
  nt16[(unsigned char)'G'] = 4;
  nt16[(unsigned char)'T'] = 8;
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 512;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        int64_t g0 = gpos[i];
        int32_t l = lens[i];
        if (l > 2 * pw) l = (int32_t)(2 * pw);
        if (g0 < 0 || g0 + l > glen) {
          cnt[i] = 254;
          continue;
        }
        const uint8_t* row = packed + i * pw;
        const uint8_t* g = genome + g0;
        uint8_t* prow = pos + i * cap;
        uint8_t* crow = code + i * cap;
        int c = 0;
        bool over = false;
        int32_t nb = l / 2;
        for (int32_t k = 0; k < nb; ++k) {
          uint8_t gb = (uint8_t)((nt16[g[2 * k]] << 4) | nt16[g[2 * k + 1]]);
          uint8_t rb = row[k];
          if (rb == gb) continue;  // both bases match: one compare/2 bases
          if ((rb >> 4) != (gb >> 4)) {
            if (c < cap) { prow[c] = (uint8_t)(2 * k); crow[c] = rb >> 4; }
            if (++c > cap) { over = true; break; }
          }
          if ((rb & 0xF) != (gb & 0xF)) {
            if (c < cap) {
              prow[c] = (uint8_t)(2 * k + 1);
              crow[c] = rb & 0xF;
            }
            if (++c > cap) { over = true; break; }
          }
        }
        if (!over && (l & 1)) {
          uint8_t nib = row[nb] >> 4;
          if (nib != nt16[g[l - 1]]) {
            if (c < cap) { prow[c] = (uint8_t)(l - 1); crow[c] = nib; }
            if (++c > cap) over = true;
          }
        }
        cnt[i] = (uint8_t)(over ? 255 : c);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Per-record MI:Z-tag candidate flags: out[i] = 1 when record i's aux
// span contains the byte sequence 'M','I','Z' (same candidate predicate
// as the engine's whole-payload numpy scan it replaces — a value-byte
// false positive only costs a later per-record verification walk).
// Threaded memchr over aux spans only (~30 B/record vs the whole
// payload), reference consults MI per read via bamutil.cpp:23-38.
void gc_mi_flags(const uint8_t* data, const int64_t* aux_off,
                 const int64_t* end, int64_t n, uint8_t* out,
                 int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 4096;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        out[i] = 0;
        const uint8_t* p = data + aux_off[i];
        const uint8_t* e = data + end[i] - 3;  // need M,I,Z + 1 value byte
        while (p < e) {
          const uint8_t* m =
              static_cast<const uint8_t*>(memchr(p, 'M', e - p));
          if (!m) break;
          if (m[1] == 'I' && m[2] == 'Z') {
            out[i] = 1;
            break;
          }
          p = m + 1;
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Packed-seq value census for the =ACGTN full-bins gate: marks every
// byte value occurring within a row's lens[i]/2 full bytes in seen256,
// and the high nibble of the odd-length tail byte in seen16 (the tail's
// low nibble is padding, masked on device). One threaded memory-speed
// pass replaces the numpy LUT+mask scan over the whole matrix.
void gc_nib_seen(const uint8_t* packed, int64_t n, int64_t pw,
                 const int32_t* lens, uint8_t* seen256, uint8_t* seen16,
                 int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  std::mutex mu;
  const int64_t kChunk = 1024;
  auto worker = [&]() {
    uint8_t loc256[256] = {0};
    uint8_t loc16[16] = {0};
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* row = packed + i * pw;
        int32_t l = lens[i];
        if (l > 2 * pw) l = (int32_t)(2 * pw);
        int64_t nb = l / 2;
        for (int64_t k = 0; k < nb; ++k) loc256[row[k]] = 1;
        if (l & 1) loc16[row[nb] >> 4] = 1;
      }
    }
    std::lock_guard<std::mutex> g(mu);
    for (int v = 0; v < 256; ++v) seen256[v] |= loc256[v];
    for (int v = 0; v < 16; ++v) seen16[v] |= loc16[v];
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Duplicate-aware upload staging: per-row nibble diff vs a representative
// row of the same packed matrix. For row i with rep r = rep_idx[i], emits
// up to `cap` (pos, code) edits where the nibble at pos (< lens[i])
// differs from the rep's; cnt[i] > cap marks overflow (row ships dense).
// pos/code land in fixed [n, cap] slots; rows where rep == self get cnt 0.
void gc_seq_edits(const uint8_t* packed, int64_t n, int64_t pw,
                  const int64_t* rep_idx, const int32_t* lens, int cap,
                  uint8_t* cnt, uint8_t* pos, uint8_t* code, int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 512;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        int64_t r = rep_idx[i];
        if (r == i) { cnt[i] = 0; continue; }
        const uint8_t* x = packed + i * pw;
        const uint8_t* y = packed + r * pw;
        int32_t l = lens[i];
        if (l > 2 * pw) l = (int32_t)(2 * pw);
        int64_t nb = (l + 1) / 2;
        uint8_t* prow = pos + i * cap;
        uint8_t* crow = code + i * cap;
        int c = 0;
        for (int64_t j = 0; j < nb; ++j) {
          uint8_t d = (uint8_t)(x[j] ^ y[j]);
          if (!d) continue;
          if ((d >> 4) && 2 * j < l) {
            if (c < cap) { prow[c] = (uint8_t)(2 * j); crow[c] = x[j] >> 4; }
            ++c;
          }
          if ((d & 0xF) && 2 * j + 1 < l) {
            if (c < cap) { prow[c] = (uint8_t)(2 * j + 1); crow[c] = x[j] & 0xF; }
            ++c;
          }
          if (c > cap) break;
        }
        cnt[i] = (uint8_t)(c > cap ? 255 : c);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Qual staging: per-record base value (first byte) + up to `cap` (pos, val)
// deviations from it within lens[i]; cnt 255 marks overflow (row ships
// raw). Reads straight from the BAM payload via qual_off. `seen[256]` is
// OR-merged with every qual value encountered (distinct-value mask — lets
// callers skip a separate histogram pass); workers accumulate locally and
// merge under a mutex.
void gc_qual_edits(const uint8_t* data, const int64_t* qual_off, int64_t n,
                   const int32_t* lens, int cap, uint8_t* base, uint8_t* cnt,
                   uint8_t* pos, uint8_t* val, uint8_t* seen, int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  std::mutex seen_mu;
  const int64_t kChunk = 512;
  auto worker = [&]() {
    uint8_t local_seen[256] = {0};
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* q = data + qual_off[i];
        int32_t l = lens[i];
        if (l <= 0) { base[i] = 0; cnt[i] = 0; continue; }
        uint8_t b = q[0];
        base[i] = b;
        local_seen[b] = 1;
        uint8_t* prow = pos + i * cap;
        uint8_t* vrow = val + i * cap;
        int c = 0;
        const uint64_t bb = 0x0101010101010101ULL * b;
        int32_t j = 1;
        while (j < l) {
          // quals are overwhelmingly constant runs: skip 8-at-a-time
          if (j + 8 <= l) {
            uint64_t x;
            memcpy(&x, q + j, 8);
            if (x == bb) { j += 8; continue; }
          }
          if (q[j] != b) {
            local_seen[q[j]] = 1;
            if (c < cap) { prow[c] = (uint8_t)j; vrow[c] = q[j]; }
            if (++c > cap) break;
          }
          ++j;
        }
        if ((uint8_t)(c > cap ? 255 : c) == 255) {
          // overflow rows ship raw; the tail beyond the bailed scan still
          // contributes values — finish the value sweep
          for (int32_t j = 1; j < l; ++j) local_seen[q[j]] = 1;
        }
        cnt[i] = (uint8_t)(c > cap ? 255 : c);
      }
    }
    if (seen) {
      std::lock_guard<std::mutex> g(seen_mu);
      for (int v = 0; v < 256; ++v) seen[v] |= local_seen[v];
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// ------------------------- compression -------------------------

// Compress payload to BGZF at `path`. Returns 0 on success. Blocks of
// 65280 input bytes, compressed in parallel. append: open in append mode
// (streaming writers emit windows incrementally — BGZF blocks are
// independently concatenable); write_eof: finish with the 28-byte EOF
// marker.
int gc_bgzf_write_ex(const char* path, const uint8_t* payload, int64_t len,
                     int level, int n_threads, int append, int write_eof) {
  const size_t kChunk = 65280;
  size_t n_blocks = (len + kChunk - 1) / kChunk;
  if (len == 0) n_blocks = 0;
  std::vector<std::vector<uint8_t>> comp(n_blocks);
  int nt = hw_threads(n_threads);
  std::atomic<size_t> next(0);
  std::atomic<bool> failed(false);
  auto worker = [&]() {
    Deflater c(level);
    std::vector<uint8_t> tmp(c.bound(kChunk));
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n_blocks || failed.load(std::memory_order_relaxed)) break;
      size_t off = i * kChunk;
      size_t in_len = std::min(kChunk, static_cast<size_t>(len) - off);
      size_t c_len = c.run(payload + off, in_len, tmp.data(), tmp.size());
      if (c_len == 0 || c_len + 26 > 65536) {
        failed.store(true);
        break;
      }
      uint32_t crc = block_crc32(payload + off, in_len);
      std::vector<uint8_t>& blk = comp[i];
      blk.resize(18 + c_len + 8);
      uint8_t hdr[18] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                         6,    0,    66,   67,   2, 0, 0, 0};
      uint16_t bsize = static_cast<uint16_t>(18 + c_len + 8 - 1);
      memcpy(hdr + 16, &bsize, 2);
      memcpy(blk.data(), hdr, 18);
      memcpy(blk.data() + 18, tmp.data(), c_len);
      uint32_t isz = static_cast<uint32_t>(in_len);
      memcpy(blk.data() + 18 + c_len, &crc, 4);
      memcpy(blk.data() + 18 + c_len + 4, &isz, 4);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  if (failed.load()) return -1;

  FILE* f = fopen(path, append ? "ab" : "wb");
  if (!f) return -2;
  bool ok = true;
  for (auto& blk : comp)
    if (fwrite(blk.data(), 1, blk.size(), f) != blk.size()) ok = false;
  if (write_eof &&
      fwrite(kBgzfEof, 1, sizeof(kBgzfEof), f) != sizeof(kBgzfEof))
    ok = false;
  fclose(f);
  return ok ? 0 : -3;
}

int gc_bgzf_write(const char* path, const uint8_t* payload, int64_t len,
                  int level, int n_threads) {
  return gc_bgzf_write_ex(path, payload, len, level, n_threads, 0, 1);
}

// ------------------------- record assembly -------------------------

// Batch-assemble output record bodies: for each record i, copy
// src[src_off[i] : src_off[i]+src_len[i]] into dst at dst_off[i], preceded
// by the little-endian int32 block_size. Used by the writer to build the
// final payload from per-record edited bodies without Python overhead.
void gc_assemble(const uint8_t* src, const int64_t* src_off,
                 const int64_t* src_len, int64_t n, uint8_t* dst,
                 const int64_t* dst_off) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t bs = static_cast<int32_t>(src_len[i]);
    memcpy(dst + dst_off[i], &bs, 4);
    memcpy(dst + dst_off[i] + 4, src + src_off[i], src_len[i]);
  }
}

// Copy variable-length slices src[src_off[i] : +src_len[i]] to
// dst[dst_off[i]] (no block_size prefix; threaded).
void gc_gather_slices(const uint8_t* src, const int64_t* src_off,
                      const int64_t* src_len, int64_t n, uint8_t* dst,
                      const int64_t* dst_off, int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 4096;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i)
        memcpy(dst + dst_off[i], src + src_off[i], src_len[i]);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Unpack 4-bit BAM seq codes for n records into a dense [n, L] row matrix
// (0-padded); src_off points at each record's packed seq bytes.
void gc_unpack_seq_rows(const uint8_t* src, const int64_t* src_off,
                        const int32_t* lens, int64_t n, uint8_t* out,
                        int64_t L, int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 1024;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* p = src + src_off[i];
        uint8_t* row = out + i * L;
        int32_t l = lens[i];
        if (l > L) l = L;
        int32_t j = 0;
        for (; j + 1 < l; j += 2) {
          uint8_t b = p[j >> 1];
          row[j] = b >> 4;
          row[j + 1] = b & 0xF;
        }
        if (j < l) row[j] = p[j >> 1] >> 4;
        if (l < L) memset(row + l, 0, L - l);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Copy per-record byte runs (e.g. quals) into a dense [n, L] row matrix.
void gc_copy_rows(const uint8_t* src, const int64_t* src_off,
                  const int32_t* lens, int64_t n, uint8_t* out, int64_t L,
                  int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 1024;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        int32_t l = lens[i];
        if (l > L) l = L;
        memcpy(out + i * L, src + src_off[i], l);
        if (l < L) memset(out + i * L + l, 0, L - l);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Pack dense [n, L] code rows back to 4-bit ragged slices at dst_off.
void gc_pack_seq_rows(const uint8_t* rows, int64_t L, const int32_t* lens,
                      int64_t n, uint8_t* dst, const int64_t* dst_off,
                      int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 1024;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* row = rows + i * L;
        uint8_t* p = dst + dst_off[i];
        int32_t l = lens[i];
        int32_t j = 0;
        for (; j + 1 < l; j += 2) p[j >> 1] = (row[j] << 4) | row[j + 1];
        if (j < l) p[j >> 1] = row[j] << 4;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Byte histogram over per-record runs (e.g. qual values across all reads).
void gc_hist_rows(const uint8_t* src, const int64_t* src_off,
                  const int32_t* lens, int64_t n, int64_t* out_hist) {
  int64_t h[256] = {0};
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = src + src_off[i];
    for (int32_t j = 0; j < lens[i]; ++j) ++h[p[j]];
  }
  memcpy(out_hist, h, sizeof(h));
}

// LUT-translate per-record byte runs and pack two 4-bit codes per output
// byte (high nibble first): out[i] is a pw-wide packed row, zero-padded.
// Used to stage quals as nibble indices for compact device upload.
// UMI substring spans over a 0-padded qname byte matrix [n, w]
// (semantics mirror gencore_tpu/core/umivec.py::umi_spans, which mirrors
// reference bamutil.cpp:23-112). mode 1 = prefix (pset = 256-entry char
// class of the prefix letters): UMI starts 2 past the LAST prefix char
// and runs through valid UMI chars; mode 0 = no prefix: everything after
// the last ':', all chars valid with <= 1 underscore (a leading '_'
// after the colon is skipped). umi_ok = 256-entry {ATCG_} class.
void gc_umi_spans(const uint8_t* qmat, int64_t n, int64_t w,
                  const int64_t* qlen, const uint8_t* pset,
                  const uint8_t* umi_ok, int mode,
                  int64_t* start_out, int64_t* len_out, int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 2048;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* q = qmat + i * w;
        int64_t l = qlen[i];
        if (l > w) l = w;
        int64_t start = 0, len = 0;
        if (mode == 1) {
          int64_t pos = -1;
          for (int64_t j = 0; j < l; ++j)
            if (pset[q[j]]) pos = j;
          if (pos >= 0) {
            start = pos + 2;
            int64_t stop = l;
            for (int64_t j = start; j < w; ++j) {
              if (j >= l || !umi_ok[q[j]]) { stop = j; break; }
            }
            len = stop - start;
            if (len < 0) len = 0;  // start may sit past the name end
          } else {
            start = 0;
            len = 0;
          }
        } else {
          int64_t sep = -1;
          for (int64_t j = 0; j < l; ++j)
            if (q[j] == ':') sep = j;
          bool ok = sep >= 0 && sep < l - 1;
          start = sep + 1;
          if (ok && start < l - 1 && q[start] == '_') start += 1;
          if (ok) {
            int64_t n_us = 0;
            for (int64_t j = start; j < l; ++j) {
              if (!umi_ok[q[j]]) { ok = false; break; }
              if (q[j] == '_') ++n_us;
            }
            if (n_us > 1) ok = false;
          }
          if (ok) {
            len = l - start;
          } else {
            start = 0;
            len = 0;
          }
        }
        start_out[i] = start;
        len_out[i] = len;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Validate + byte-LUT-map rows of nibble-packed data, then pack byte
// pairs into one byte (two 4-bit items -> four 2-bit items). Row i has
// lens[i] items (2 per input byte): bytes j < lens/2 must satisfy
// ok_full[b]; the odd tail byte (lens odd) must satisfy ok_odd[b]; bytes
// beyond the row's data are 0 (lut[0] must map to 0). Returns 1 when all
// rows validated (out filled), 0 otherwise (caller falls back).
// out rows are ow = (pw+1)/2 bytes wide.
int gc_pack2_rows(const uint8_t* packed, int64_t n, int64_t pw,
                  const int32_t* lens, const uint8_t* lut,
                  const uint8_t* ok_full, const uint8_t* ok_odd,
                  uint8_t* out, int n_threads) {
  const int64_t ow = (pw + 1) / 2;
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  std::atomic<bool> failed(false);
  const int64_t kChunk = 1024;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n || failed.load(std::memory_order_relaxed)) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* row = packed + i * pw;
        int32_t l = lens[i];
        if (l > 2 * pw) l = (int32_t)(2 * pw);
        int64_t full = l / 2;
        bool ok = true;
        for (int64_t j = 0; j < full; ++j) ok &= ok_full[row[j]] != 0;
        if (l & 1) ok &= ok_odd[row[full]] != 0;
        if (!ok) {
          failed.store(true);
          return;
        }
        uint8_t* orow = out + i * ow;
        int64_t j = 0;
        for (; j + 1 < pw; j += 2)
          orow[j / 2] = (uint8_t)((lut[row[j]] << 4) | lut[row[j + 1]]);
        if (j < pw) orow[j / 2] = (uint8_t)(lut[row[j]] << 4);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return failed.load() ? 0 : 1;
}

void gc_pack_nib_rows(const uint8_t* src, const int64_t* src_off,
                      const int32_t* lens, int64_t n, const uint8_t* lut,
                      uint8_t* out, int64_t pw, int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 1024;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* p = src + src_off[i];
        uint8_t* row = out + i * pw;
        int32_t l = lens[i];
        if (l > 2 * pw) l = (int32_t)(2 * pw);
        int32_t j = 0;
        int64_t k = 0;
        for (; j + 1 < l; j += 2) row[k++] = (lut[p[j]] << 4) | lut[p[j + 1]];
        if (j < l) row[k++] = lut[p[j]] << 4;
        if (k < pw) memset(row + k, 0, pw - k);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Unpack dense packed-nibble rows [n, pw] -> [n, 2*pw] bytes through a
// 16-entry LUT (identity LUT for BAM seq codes; qual value table for
// nibble-indexed quals). Threaded.
void gc_unpack_nib_dense(const uint8_t* src, int64_t n, int64_t pw,
                         const uint8_t* lut, uint8_t* out, int n_threads) {
  int nt = hw_threads(n_threads);
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 1024;
  // expand to a 256 -> 2-byte table so each packed byte is one lookup
  uint16_t big[256];
  for (int b = 0; b < 256; ++b) {
    uint16_t pair;
    uint8_t v[2] = {lut[b >> 4], lut[b & 0xF]};
    memcpy(&pair, v, 2);
    big[b] = pair;
  }
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(kChunk);
      if (lo >= n) break;
      int64_t hi = std::min(lo + kChunk, n);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* p = src + i * pw;
        uint16_t* row = reinterpret_cast<uint16_t*>(out + i * 2 * pw);
        for (int64_t j = 0; j < pw; ++j) row[j] = big[p[j]];
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Greedy UMI grouping over unique lex-sorted UMIs (reference
// cluster.cpp:55-100): repeatedly take the most-frequent alive UMI
// (lowest index wins ties = lex-smallest, matching std::map order) and
// sweep every alive UMI with hamming(common prefix) + |len diff| <= thr
// (cluster.cpp:41-53 umiDiff). mat: [U, W] zero-padded bytes.
// Writes group ids (creation order) to group_of[U]; returns group count.
int64_t gc_greedy_group(const uint8_t* mat, const int64_t* lens,
                        const int64_t* counts, int64_t U, int64_t W,
                        int64_t thr, int64_t* group_of) {
  std::vector<int64_t> cnt(counts, counts + U);
  std::vector<uint8_t> alive(U, 1);
  int64_t ng = 0;
  int64_t n_alive = U;
  while (n_alive > 0) {
    int64_t top = 0, bc = 0;
    for (int64_t i = 0; i < U; ++i)
      if (cnt[i] > bc) { bc = cnt[i]; top = i; }
    const uint8_t* t = mat + top * W;
    const int64_t tl = lens[top];
    for (int64_t i = 0; i < U; ++i) {
      if (!alive[i]) continue;
      const int64_t li = lens[i];
      const int64_t ml = li < tl ? li : tl;
      int64_t d = li > tl ? li - tl : tl - li;
      const uint8_t* r = mat + i * W;
      for (int64_t j = 0; j < ml && d <= thr; ++j) d += (r[j] != t[j]);
      if (d <= thr) {
        group_of[i] = ng;
        alive[i] = 0;
        cnt[i] = 0;
        --n_alive;
      }
    }
    ++ng;
  }
  return ng;
}

void gc_free(void* p) { free(p); }

}  // extern "C"
