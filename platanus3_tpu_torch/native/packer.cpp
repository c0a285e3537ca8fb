// Native FASTA/FASTQ parser + 2-bit chunk packer.
//
// Host-side read loader of platanus3_tpu_torch (ctypes API, no pybind),
// ported from platanus3_tpu/native/packer.cpp.  Packs reads into the
// chunked layout of io/reads.py: fixed-width chunks, stride =
// chunk_len - k + 1, 16 bases per uint32 lane, first base most significant.
//
// p3_open maps the file read-only and indexes its records, each as the
// byte range of its sequence in the mapping and its base count.  p3_fill
// packs every chunk's words straight from the mapped text on
// `num_threads` threads, each writing (and so first touching) only its
// own rows of the output.  A record whose bases are not one run of bytes
// (a wrapped FASTA record, or one with blank lines inside) is first
// joined without its '\n's into a buffer of its thread, then packed the
// same way.
//
// Contract matched with the numpy parser of io/reads.py:
//  * format sniffed from first byte ('>' FASTA / '@' FASTQ)
//  * multi-line FASTA, strict 4-line FASTQ
//  * reads shorter than k dropped; all_bases counts kept reads only
//  * A/C/G/T (either case) -> 0/1/2/3, anything else -> 0
//
// Build: g++ -O3 -shared -fPIC -pthread (native/__init__.py, on first
// use, into build/native/).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Read {
  uint64_t off;     // byte offset of the first base in the mapping
  uint64_t end;     // end of the record's sequence bytes
  uint32_t len;     // bases
  uint32_t direct;  // 1: the bases are the bytes [off, off + len)
};

struct Handle {
  const char* map = nullptr;
  size_t size = 0;
  std::vector<Read> reads;
  std::vector<uint64_t> row0;   // first chunk row of each read, then total
  uint64_t all_bases = 0;
  uint64_t num_direct = 0;
  int k = 0;
  int chunk_len = 0;

  ~Handle() {
    if (map) munmap((void*)map, size);
  }

  void add(const char* off, const char* end, uint64_t len, bool direct) {
    if ((int64_t)len < k) return;  // drop short read
    reads.push_back({(uint64_t)(off - map), (uint64_t)(end - map),
                     (uint32_t)len, direct ? 1u : 0u});
    all_bases += len;
    num_direct += direct;
  }
};

uint8_t g_code[256];
struct CodeInit {
  CodeInit() {
    memset(g_code, 0, sizeof(g_code));
    g_code[(int)'A'] = 0; g_code[(int)'a'] = 0;
    g_code[(int)'C'] = 1; g_code[(int)'c'] = 1;
    g_code[(int)'G'] = 2; g_code[(int)'g'] = 2;
    g_code[(int)'T'] = 3; g_code[(int)'t'] = 3;
  }
} g_code_init;

// End of the line that starts at p: its '\n', or the end of the file.
inline const char* line_end(const char* p, const char* end) {
  const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
  return nl ? nl : end;
}

// FASTA: a line that starts with '>' is a header; every line up to the
// next header is sequence.  A record is direct when at most one of its
// lines is not blank: its bases are then that line's bytes.
void index_fasta(Handle* h) {
  const char* p = h->map;
  const char* end = p + h->size;
  while (p < end) {             // p is at a header
    const char* le = line_end(p, end);
    const char* q = le < end ? le + 1 : end;
    const char* first = q;
    uint64_t bases = 0;
    int lines = 0;
    while (q < end && *q != '>') {
      le = line_end(q, end);
      if (le > q) {
        if (lines++ == 0) first = q;
        bases += (uint64_t)(le - q);
      }
      q = le < end ? le + 1 : end;
    }
    h->add(first, q, bases, lines <= 1);
    p = q;
  }
}

// FASTQ: strict 4-line records (header, seq, +, quality), so a quality
// line that starts with '@' or '+' is never read as a header.
void index_fastq(Handle* h) {
  const char* p = h->map;
  const char* end = p + h->size;
  int phase = 0;
  while (p < end) {
    const char* le = line_end(p, end);
    if (phase == 1) h->add(p, le, (uint64_t)(le - p), true);
    phase = (phase + 1) & 3;
    p = le < end ? le + 1 : end;
  }
}

// 16 bases to one lane word, first base most significant.
inline uint32_t pack16(const uint8_t* s) {
  uint32_t acc = 0;
  for (int t = 0; t < 16; ++t) acc = (acc << 2) | g_code[s[t]];
  return acc;
}

struct Out {
  uint32_t* packed;
  int32_t *valid_len, *read_id, *start, *read_len;
  uint8_t *prev_base, *next_base;
};

// Pack the chunks of read `ri`, whose `len` bases are the bytes at
// `text`, into rows from `row`.
void pack_read(const uint8_t* text, uint32_t len, uint32_t ri, uint64_t row,
               int k, int chunk_len, const Out& o) {
  const uint32_t stride = (uint32_t)(chunk_len - k + 1);
  const int words = chunk_len / 16;
  const uint32_t nchunks = (len - k) / stride + 1;
  for (uint32_t ci = 0; ci < nchunks; ++ci, ++row) {
    uint32_t st = ci * stride;
    uint32_t v = len - st < (uint32_t)chunk_len ? len - st
                                                : (uint32_t)chunk_len;
    o.valid_len[row] = (int32_t)v;
    o.read_id[row] = (int32_t)ri;
    o.start[row] = (int32_t)st;
    o.read_len[row] = (int32_t)len;
    o.prev_base[row] = st > 0 ? g_code[text[st - 1]] : (uint8_t)4;
    o.next_base[row] =
        st + chunk_len < len ? g_code[text[st + chunk_len]] : (uint8_t)4;
    uint32_t* out = o.packed + row * (uint64_t)words;
    const uint8_t* src = text + st;
    int full = (int)(v / 16), w = 0;
    for (; w < full; ++w) out[w] = pack16(src + 16 * w);
    if (w < words) {
      uint32_t acc = 0;
      int rem = (int)v - 16 * w;
      for (int t = 0; t < rem; ++t)
        acc |= (uint32_t)g_code[src[16 * w + t]] << (30 - 2 * t);
      out[w++] = acc;
      for (; w < words; ++w) out[w] = 0;
    }
  }
}

}  // namespace

extern "C" {

// Map and index the file; returns an opaque handle (nullptr when the
// file is missing, empty, unreadable or starts with neither '>' nor '@').
void* p3_open(const char* path, int k, int chunk_len) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, (size_t)st.st_size, PROT_READ,
                 MAP_PRIVATE | MAP_POPULATE, fd, 0);
  close(fd);
  if (m == MAP_FAILED) return nullptr;
  Handle* h = new Handle();
  h->map = (const char*)m;
  h->size = (size_t)st.st_size;
  h->k = k;
  h->chunk_len = chunk_len;

  if (*h->map == '>') {
    index_fasta(h);
  } else if (*h->map == '@') {
    index_fastq(h);
  } else {
    delete h;
    return nullptr;
  }

  const uint64_t stride = (uint64_t)(chunk_len - k + 1);
  h->row0.resize(h->reads.size() + 1);
  h->row0[0] = 0;
  for (size_t i = 0; i < h->reads.size(); ++i)
    h->row0[i + 1] = h->row0[i] + (h->reads[i].len - k) / stride + 1;
  return h;
}

uint64_t p3_num_chunks(void* vh) { return ((Handle*)vh)->row0.back(); }
uint64_t p3_num_reads(void* vh) { return ((Handle*)vh)->reads.size(); }
uint64_t p3_all_bases(void* vh) { return ((Handle*)vh)->all_bases; }
// Kept reads whose bases are one run of bytes, packed from the mapping.
uint64_t p3_num_direct(void* vh) { return ((Handle*)vh)->num_direct; }

// Fill caller-allocated arrays (shapes from p3_num_chunks):
//   packed     [num_chunks * chunk_len/16] u32
//   valid_len, read_id, start, read_len  [num_chunks] i32
//   prev_base, next_base                 [num_chunks] u8
// The reads are split between threads by the bases they pack (chunk
// rows of chunk_len bases), not by read count.
void p3_fill(void* vh, uint32_t* packed, int32_t* valid_len,
             int32_t* read_id, int32_t* start, int32_t* read_len,
             uint8_t* prev_base, uint8_t* next_base, int num_threads) {
  const Handle* h = (const Handle*)vh;
  const Out o{packed, valid_len, read_id, start, read_len, prev_base,
              next_base};
  const size_t n_reads = h->reads.size();
  const uint64_t rows = h->row0.back();

  auto work = [&](size_t r_lo, size_t r_hi) {
    std::vector<uint8_t> joined;
    for (size_t ri = r_lo; ri < r_hi; ++ri) {
      const Read& rd = h->reads[ri];
      const uint8_t* text = (const uint8_t*)h->map + rd.off;
      if (!rd.direct) {
        joined.resize(rd.len);
        uint8_t* dst = joined.data();
        for (const uint8_t* p = text; p < (const uint8_t*)h->map + rd.end;
             ++p)
          if (*p != '\n') *dst++ = *p;
        text = joined.data();
      }
      pack_read(text, rd.len, (uint32_t)ri, h->row0[ri], h->k, h->chunk_len,
                o);
    }
  };

  size_t nt = num_threads > 0 ? (size_t)num_threads : 1;
  if (nt > n_reads) nt = n_reads;
  if (nt <= 1) {
    work(0, n_reads);
    return;
  }
  // Thread t takes the reads whose first row lies in
  // [t * rows / nt, (t + 1) * rows / nt).
  std::vector<size_t> cut(nt + 1);
  for (size_t t = 0; t <= nt; ++t)
    cut[t] = (size_t)(std::lower_bound(h->row0.begin(), h->row0.end() - 1,
                                       rows * t / nt) -
                      h->row0.begin());
  std::vector<std::thread> ths;
  for (size_t t = 0; t < nt; ++t)
    if (cut[t] < cut[t + 1]) ths.emplace_back(work, cut[t], cut[t + 1]);
  for (auto& t : ths) t.join();
}

void p3_close(void* vh) { delete (Handle*)vh; }

}  // extern "C"
