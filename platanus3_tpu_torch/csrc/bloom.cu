// Bloom-filter builds on Hopper: bloom_set_bits and bloom_blocked_set_bits.
//
// bloom_set_bits replaces platanus3_tpu/ops/bloom_pallas.py::_set_bits_kernel
// (driven by build_packed_bloom).  It computes the same packed words as
// platanus3_tpu/ops/bloom.py::bloom_add: for each masked-in k-mer and each
// n < num_hashes, bit (p & 31) of word (p >> 5) is set, where
// p = (h1 + n*h2) mod 2^log2_bits and (h1, h2) is the murmur double hash of
// hash.cuh, in native uint32 arithmetic.
//
// bloom_blocked_set_bits replaces bloom_pallas.py::_blocked_kernel (driven
// by build_blocked_bloom).  The top log2_blocks bits of h1 pick one
// 2^19-bit (16384-word, 64 KB) block, and every probe
// p = (h1 + n*h2) & (2^19 - 1) lands inside it: bit (p & 31) of word
// blk*16384 + (p >> 5).  The Pallas kernel adds in int32; the low 19 bits
// of that sum are those of the uint32 sum here, so the words are
// bit-equal.  Word offsets are 64-bit: at 2^35 bits there are 2^30 words.
//
// Design of bloom_set_bits.  Hash-partition the probes by filter region,
// then OR each region in shared memory.  A region is min(2^14, words)
// words: 64 KB, or the whole filter when it is smaller.  The partition
// (partition.cuh: count, scatter, refine) groups each probe's bit offset
// inside its region (uint32) into per-region runs of a scratch array with
// no global atomic.  Then one CTA per region copies the region of the
// input words into shared memory, applies its probes with shared atomicOr
// and writes the region to the output words, coalesced.  OR is idempotent
// and commutative, so the words do not depend on the order of the probes
// and need no dedup.  The Pallas kernel sorted probes and built SMEM
// blocks because Mosaic allows read-modify-write in SMEM alone; here the
// reason is that a probe's atomic stays on the SM instead of costing a
// sector round trip to device memory.  The input words are read, never
// written, so the wrapper needs no copy of them.
//
// Design of bloom_blocked_set_bits.  One thread per k-mer row reads the
// row's L int64 lanes (each a uint32 value) and its mask byte, hashes, and
// issues num_hashes atomicOr of 1u << (p & 31) into the probed word.  Its
// blocks are the regions above, but it does not partition yet.
//
// Bound.  Both are bound by bytes: the lanes and mask read once and the
// words written once (and, for bloom_set_bits, the old words read once).
// A 2^30-bit flat filter is 128 MB and does not fit in the H100's 50 MB
// L2, so a probe issued to device memory is a miss; bloom_set_bits instead
// reads its input twice and, a probe, writes 4 bytes of scratch twice and
// reads them three times.  The blocked layout keeps a row's probes inside
// one 64 KB block, but its 10 probes still touch 10 different 32-byte
// sectors of device memory.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// (platanus3_tpu_torch/kernels.py), bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"
#include "partition.cuh"

namespace {

constexpr uint32_t kBlockBitsMask = (1u << 19) - 1u;
constexpr int kBlockWordsLog2 = 14;
constexpr int kRegionThreads = 512;

// The partition's rows: each masked-in row's num_hashes probes, bucketed
// by region.  A probe's item is its offset inside its top bucket of
// regions (region_bits_log2 + sub_log2 bits); the refine keeps the offset
// inside its region.
struct BloomRows {
  using Item = uint32_t;
  const int64_t* kmers;
  const uint8_t* mask;
  int64_t rows;
  int lanes;
  uint32_t init1;
  uint32_t init2;
  int num_hashes;
  uint32_t pos_mask;
  int region_bits_log2;
  uint32_t top_offset_mask;

  __host__ __device__ int per_row() const { return num_hashes; }

  struct Row {
    unsigned long long key;
    uint8_t flag;
  };

  __device__ __forceinline__ Row load(int64_t i) const {
    return Row{p3::pack_row(kmers + i * lanes, lanes),
               mask != nullptr ? mask[i] : uint8_t{1}};
  }

  template <class F>
  __device__ __forceinline__ void items(const Row& row, F&& f) const {
    if (row.flag == 0) return;
    const uint32_t h1 = p3::hash_packed(row.key, lanes, init1);
    const uint32_t h2 = p3::hash_packed(row.key, lanes, init2) | 1u;
    for (int n = 0; n < num_hashes; ++n) {
      const uint32_t p = (h1 + static_cast<uint32_t>(n) * h2) & pos_mask;
      f(p >> region_bits_log2, p & top_offset_mask);
    }
  }
};

struct BloomRefine {
  int region_bits_log2;

  __device__ __forceinline__ uint32_t sub(uint32_t offset) const {
    return offset >> region_bits_log2;
  }
  __device__ __forceinline__ uint32_t final_item(uint32_t offset) const {
    return offset & ((1u << region_bits_log2) - 1u);
  }
};

BloomRows bloom_rows(const void* kmers, const void* mask, long long rows,
                     int lanes, unsigned int init1, unsigned int init2,
                     int num_hashes, unsigned int pos_mask,
                     int region_bits_log2, int sub_log2) {
  return BloomRows{static_cast<const int64_t*>(kmers),
                   static_cast<const uint8_t*>(mask), rows, lanes, init1,
                   init2, num_hashes, pos_mask, region_bits_log2,
                   (1u << (region_bits_log2 + sub_log2)) - 1u};
}

// Region OR: one CTA per region ORs the region's probes onto its words.
__global__ void __launch_bounds__(kRegionThreads)
    bloom_region_or_kernel(const uint32_t* __restrict__ part,
                           const int64_t* __restrict__ bucket_start,
                           int region_words,
                           const unsigned int* __restrict__ in_words,
                           unsigned int* __restrict__ out_words) {
  extern __shared__ unsigned int s_words[];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * region_words;
  for (int w = threadIdx.x; w < region_words; w += blockDim.x) {
    s_words[w] = in_words[first + w];
  }
  __syncthreads();
  const int64_t end = bucket_start[blockIdx.x + 1];
  for (int64_t i = bucket_start[blockIdx.x] + threadIdx.x; i < end;
       i += blockDim.x) {
    const uint32_t q = part[i];
    atomicOr(s_words + (q >> 5), 1u << (q & 31u));
  }
  __syncthreads();
  for (int w = threadIdx.x; w < region_words; w += blockDim.x) {
    out_words[first + w] = s_words[w];
  }
}

__global__ void bloom_blocked_set_bits_kernel(
    const int64_t* __restrict__ kmers, const uint8_t* __restrict__ mask,
    int64_t rows, int lanes, uint32_t init1, uint32_t init2, int num_hashes,
    int log2_blocks, unsigned int* __restrict__ words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < rows; i += stride) {
    if (mask != nullptr && mask[i] == 0) continue;
    uint32_t h1, h2;
    p3::double_hash_row(kmers + i * lanes, lanes, init1, init2, &h1, &h2);
    const uint64_t blk = log2_blocks > 0 ? (h1 >> (32 - log2_blocks)) : 0u;
    unsigned int* block = words + (blk << kBlockWordsLog2);
    for (int n = 0; n < num_hashes; ++n) {
      const uint32_t p =
          (h1 + static_cast<uint32_t>(n) * h2) & kBlockBitsMask;
      atomicOr(block + (p >> 5), 1u << (p & 31u));
    }
  }
}

unsigned int grid_for(long long rows, int threads) {
  long long blocks = (rows + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  return static_cast<unsigned int>(blocks);
}

}  // namespace

// bloom_set_bits runs as four passes, each launched on `stream` by its
// own call so that the wrapper can scan the counts in between; each
// returns cudaGetLastError() of its launch (0 = ok).  `mask` may be null
// (every row is inserted).  Probe positions are p & pos_mask; region r
// holds positions [r, r + 1) << region_bits_log2, and there are
// 2^(top_log2 + sub_log2) regions (partition.cuh).  `ctas` must be the same
// in the count and the scatter.
//
// Count: `hist` ([ctas, 2^top_log2] uint32) gets every CTA's probes per
// top bucket.
extern "C" int bloom_partition_count(const void* kmers, const void* mask,
                                     long long rows, int lanes,
                                     unsigned int init1, unsigned int init2,
                                     int num_hashes, unsigned int pos_mask,
                                     int region_bits_log2, int top_log2,
                                     int sub_log2, int ctas, void* hist,
                                     void* stream) {
  return p3::launch_partition_count(
      bloom_rows(kmers, mask, rows, lanes, init1, init2, num_hashes,
                 pos_mask, region_bits_log2, sub_log2),
      top_log2, sub_log2, ctas, hist, static_cast<cudaStream_t>(stream));
}

// Scatter: `offsets` ([ctas, 2^top_log2] uint64) holds where each CTA's
// probes of each top bucket start in `part` (at least as many uint32 as
// the count found).
extern "C" int bloom_partition_scatter(const void* kmers, const void* mask,
                                       long long rows, int lanes,
                                       unsigned int init1, unsigned int init2,
                                       int num_hashes, unsigned int pos_mask,
                                       int region_bits_log2, int top_log2,
                                       int sub_log2, int ctas,
                                       const void* offsets, void* part,
                                       void* stream) {
  return p3::launch_partition_scatter(
      bloom_rows(kmers, mask, rows, lanes, init1, init2, num_hashes,
                 pos_mask, region_bits_log2, sub_log2),
      top_log2, sub_log2, ctas, offsets, part,
      static_cast<cudaStream_t>(stream));
}

// Refine: `top_start` ([2^top_log2 + 1] int64) bounds each top bucket's
// run of `part`; writes the offsets grouped by region to `regioned` and
// where each region starts to `bucket_start` ([regions + 1] int64).
extern "C" int bloom_partition_refine(const void* part, const void* top_start,
                                      int region_bits_log2, int top_log2,
                                      int sub_log2, void* regioned,
                                      void* bucket_start, void* stream) {
  return p3::launch_partition_refine<BloomRefine, uint32_t>(
      BloomRefine{region_bits_log2}, top_log2, sub_log2, part, top_start,
      regioned, bucket_start, static_cast<cudaStream_t>(stream));
}

// Region OR: `bucket_start` ([regions + 1] int64) bounds each region's run
// of `regioned`.  Writes every word of `out_words`: `in_words` ORed with
// the probes' bits; `in_words` is only read.
extern "C" int bloom_region_or(const void* regioned, const void* bucket_start,
                               int regions, int region_words,
                               const void* in_words, void* out_words,
                               void* stream) {
  const auto kernel = bloom_region_or_kernel;
  const size_t smem = static_cast<size_t>(region_words) * sizeof(unsigned int);
  const cudaError_t err = p3::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(regions), kRegionThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(regioned),
      static_cast<const int64_t*>(bucket_start), region_words,
      static_cast<const unsigned int*>(in_words),
      static_cast<unsigned int*>(out_words));
  return static_cast<int>(cudaGetLastError());
}

// Blocked build into `words` (2^log2_blocks blocks of 16384 words, already
// zeroed or holding an earlier build).  Launches on `stream`; returns
// cudaGetLastError() of the launch (0 = ok).  `mask` may be null.
extern "C" int bloom_blocked_set_bits(const void* kmers, const void* mask,
                                      long long rows, int lanes,
                                      unsigned int init1, unsigned int init2,
                                      int num_hashes, int log2_blocks,
                                      void* words, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  bloom_blocked_set_bits_kernel<<<grid_for(rows, threads), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(kmers), static_cast<const uint8_t*>(mask),
      static_cast<int64_t>(rows), lanes, init1, init2, num_hashes,
      log2_blocks, static_cast<unsigned int*>(words));
  return static_cast<int>(cudaGetLastError());
}
