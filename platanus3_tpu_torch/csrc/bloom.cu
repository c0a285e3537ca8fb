// Bloom-filter builds on Hopper: bloom_set_bits and bloom_blocked_set_bits.
//
// bloom_set_bits replaces platanus3_tpu/ops/bloom_pallas.py::_set_bits_kernel
// (driven by build_packed_bloom).  It computes the same packed words as
// platanus3_tpu/ops/bloom.py::bloom_add below 2^32 bits, at any k and up to
// 2^35 bits: for each masked-in k-mer and each n < num_hashes, bit (p & 31)
// of word (p >> 5) is set, where p = (start + n*step) mod 2^log2_bits.  In
// a narrow filter (start, step) = (h1, h2 | 1), the murmur hashes of
// hash.cuh over all the row's lanes, in native uint32 arithmetic.  In a
// wide one (the wrapper's flag, from 2^32 bits on) they are the two
// 64-bit hashes of hash64_row (hashing.wide_probe_pair), where the JAX
// package uses hi << 32 | (h1 + n*h2) mod 2^32 with a second murmur pair
// for hi: that pair gives some k-mers a twin with every probe equal.
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
// Design of bloom_blocked_set_bits.  The same partition, then one CTA per
// block.  A row sends every probe into its own block, so the partition
// carries one item a masked-in row, not one a probe: probe n,
// (h1 + n*h2) & (2^19 - 1), depends only on the low 19 bits of h1 and of
// h2, and the item is those 38 bits in a uint64, with the block's low
// sub_log2 bits above them for the refine.  That is the point of the
// Pallas design too, which sorted one (h1, h2) pair a k-mer.  The build
// CTA zeroes its 64 KB block in shared memory (no read of device memory:
// the build always starts from an empty filter), expands each item's
// num_hashes probes with shared atomicOr and writes the block once,
// coalesced, so the output needs no fill.  No block's rows are capped:
// the refine's CTA and the build's CTA walk a run of any length, so all
// rows landing in one block only saturate its words.  The Pallas kernel
// gave each block a budget of chunks and dropped the rows past it as
// overflow; here nothing is dropped and the wrapper's overflow is 0.
//
// Bound.  Both are bound by bytes: the lanes and mask read once and the
// words written once (and, for bloom_set_bits, the old words read once).
// bloom_set_bits reads its input twice and, a probe, writes 4 bytes of
// scratch twice and reads them three times.  bloom_blocked_set_bits reads
// its input twice and, a row, writes 8 bytes of scratch twice and reads
// them three times: at the main shape (4.5M rows, 10 hashes) 36 MB of
// items against 186 MB of probes for the flat build.  A 2^30-bit filter
// is 128 MB and does not fit in the H100's 50 MB L2, so no probe goes to
// device memory: each one is a shared-memory atomic on its CTA's SM.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// (platanus3_tpu_torch/kernels.py), bound with ctypes.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "hash.cuh"
#include "partition.cuh"

namespace {

constexpr uint32_t kBlockBitsMask = (1u << 19) - 1u;
constexpr int kBlockWordsLog2 = 14;
constexpr int kBlockWords = 1 << kBlockWordsLog2;
// A blocked build's item: h1's low 19 bits, h2's above them, then the
// block's sub-bucket.
constexpr int kItemH2Shift = 19;
constexpr int kItemSubShift = 38;
constexpr int kRegionThreads = 512;

// The partition's rows: each masked-in row's num_hashes probes, bucketed
// by region.  A probe's item is its offset inside its top bucket of
// regions (region_bits_log2 + sub_log2 bits); the refine keeps the offset
// inside its region.  Every lane of a row is hashed (hashing.hash_kmers).
//
// PackedRows: one or two lanes below 2^32 bits (k <= 32, the main run).
// load() reads the row as one packed value, so for_each_loaded issues the
// lane loads of its unrolled rows together, and a probe is
// (h1 + n*h2) mod 2^log2_bits.  On the H100 this is 0.04 ms (4 %) faster
// at k = 32, 2^30 bits than BloomRows<false>, which reads the lanes in
// items() (PERF.md).
struct PackedRows {
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
  __device__ __forceinline__ void items(int64_t, const Row& row, F&& f) const {
    if (row.flag == 0) return;
    const uint32_t h1 = p3::hash_packed(row.key, lanes, init1);
    const uint32_t h2 = p3::hash_packed(row.key, lanes, init2) | 1u;
    for (int n = 0; n < num_hashes; ++n) {
      const uint32_t p = (h1 + static_cast<uint32_t>(n) * h2) & pos_mask;
      f(p >> region_bits_log2, p & top_offset_mask);
    }
  }
};

// BloomRows: any lane count, any size.  items() hashes the row from its
// lanes.  Without kWide (a narrow filter) a probe is as in PackedRows.
// With kWide the two hashes are 64-bit (hash64_row of the two seeds) and
// a probe is (start + n*step) mod 2^log2_bits in uint64: the region is at
// most 16 bits (2^35 bits in regions of 2^19) and the offset inside a top
// bucket at most 27, so both stay uint32.  Narrow and wide are two
// instantiations, so that the narrow one computes in uint32.
template <bool kWide>
struct BloomRows {
  using Item = uint32_t;
  using Hash = std::conditional_t<kWide, unsigned long long, uint32_t>;
  const int64_t* kmers;
  const uint8_t* mask;
  int64_t rows;
  int lanes;
  Hash seed[2];
  int num_hashes;
  Hash pos_mask;   // 2^log2_bits - 1
  int region_bits_log2;
  uint32_t top_offset_mask;

  __host__ __device__ int per_row() const { return num_hashes; }

  struct Row {
    uint8_t flag;
  };

  __device__ __forceinline__ Row load(int64_t i) const {
    return Row{mask != nullptr ? mask[i] : uint8_t{1}};
  }

  template <class F>
  __device__ __forceinline__ void items(int64_t i, const Row& row,
                                        F&& f) const {
    if (row.flag == 0) return;
    Hash h[2];
    if constexpr (kWide) {
      p3::hash64_row<2>(kmers + i * lanes, lanes, seed, h);
    } else {
      p3::hash_row_n<2>(kmers + i * lanes, lanes, seed, h);
    }
    const Hash step = h[1] | 1u;
    for (int n = 0; n < num_hashes; ++n) {
      const Hash p = (h[0] + static_cast<Hash>(n) * step) & pos_mask;
      f(static_cast<uint32_t>(p >> region_bits_log2),
        static_cast<uint32_t>(p) & top_offset_mask);
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

// Calls launch(rows) with the rows policy that fits `lanes`, `log2_bits`
// and `wide`, and returns its result.
template <class Launch>
int with_bloom_rows(const void* kmers, const void* mask, long long rows,
                    int lanes, const unsigned int* init, int num_hashes,
                    int log2_bits, int wide, int region_bits_log2,
                    int sub_log2, Launch&& launch) {
  const auto* k = static_cast<const int64_t*>(kmers);
  const auto* m = static_cast<const uint8_t*>(mask);
  const uint32_t top_offset_mask = (1u << (region_bits_log2 + sub_log2)) - 1u;
  if (wide) {
    // hashing.wide_seeds: hash_init of SEED_H1 and SEED_H3, then of
    // SEED_H2 and SEED_H4, high half first.
    return launch(BloomRows<true>{
        k, m, rows, lanes,
        {(static_cast<unsigned long long>(init[0]) << 32) | init[2],
         (static_cast<unsigned long long>(init[1]) << 32) | init[3]},
        num_hashes, (1ull << log2_bits) - 1ull, region_bits_log2,
        top_offset_mask});
  }
  if (log2_bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  const auto pos_mask = static_cast<uint32_t>((1ull << log2_bits) - 1u);
  if (lanes <= 2) {
    return launch(PackedRows{k, m, rows, lanes, init[0], init[1], num_hashes,
                             pos_mask, region_bits_log2, top_offset_mask});
  }
  return launch(BloomRows<false>{k, m, rows, lanes, {init[0], init[1]},
                                 num_hashes, pos_mask, region_bits_log2,
                                 top_offset_mask});
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

// The blocked build's rows: one item a masked-in row, bucketed by its
// block.  The item holds what the build needs of the double hash, the low
// 19 bits of h1 and of h2, and, above them, the block's low sub_log2 bits,
// from which the refine finds its sub-bucket.
struct BlockedRows {
  using Item = unsigned long long;
  const int64_t* kmers;
  const uint8_t* mask;
  int64_t rows;
  int lanes;
  uint32_t init1;
  uint32_t init2;
  int log2_blocks;
  uint32_t sub_mask;

  __host__ __device__ int per_row() const { return 1; }

  struct Row {
    uint32_t h1;
    uint32_t h2;
    uint8_t flag;
  };

  __device__ __forceinline__ Row load(int64_t i) const {
    Row row;
    p3::double_hash_row(kmers + i * lanes, lanes, init1, init2, &row.h1,
                        &row.h2);
    row.flag = mask != nullptr ? mask[i] : uint8_t{1};
    return row;
  }

  template <class F>
  __device__ __forceinline__ void items(int64_t, const Row& row,
                                        F&& f) const {
    if (row.flag == 0) return;
    const uint32_t blk = log2_blocks > 0 ? row.h1 >> (32 - log2_blocks) : 0u;
    f(blk, (row.h1 & kBlockBitsMask) |
               (static_cast<unsigned long long>(row.h2 & kBlockBitsMask)
                << kItemH2Shift) |
               (static_cast<unsigned long long>(blk & sub_mask)
                << kItemSubShift));
  }
};

struct BlockedRefine {
  __device__ __forceinline__ uint32_t sub(unsigned long long item) const {
    return static_cast<uint32_t>(item >> kItemSubShift);
  }
  __device__ __forceinline__ unsigned long long final_item(
      unsigned long long item) const {
    return item & ((1ull << kItemSubShift) - 1ull);
  }
};

BlockedRows blocked_rows(const void* kmers, const void* mask, long long rows,
                         int lanes, unsigned int init1, unsigned int init2,
                         int top_log2, int sub_log2) {
  return BlockedRows{static_cast<const int64_t*>(kmers),
                     static_cast<const uint8_t*>(mask), rows, lanes, init1,
                     init2, top_log2 + sub_log2, (1u << sub_log2) - 1u};
}

// Block build: one CTA per block sets the probes of the block's items
// (h1 and h2 of each, 19 bits apiece) in an empty 64 KB block of shared
// memory, then writes the whole block.
__global__ void __launch_bounds__(kRegionThreads)
    bloom_block_build_kernel(const unsigned long long* __restrict__ items,
                             const int64_t* __restrict__ bucket_start,
                             int num_hashes, unsigned int* __restrict__ words) {
  extern __shared__ __align__(16) unsigned int s_block[];
  uint4* s_block4 = reinterpret_cast<uint4*>(s_block);
  for (int w = threadIdx.x; w < kBlockWords / 4; w += blockDim.x) {
    s_block4[w] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  p3::for_each_loaded(
      bucket_start[blockIdx.x], bucket_start[blockIdx.x + 1],
      [&](int64_t i) { return items[i]; },
      [&](int64_t, unsigned long long item) {
        uint32_t p = static_cast<uint32_t>(item) & kBlockBitsMask;
        const uint32_t h2 =
            static_cast<uint32_t>(item >> kItemH2Shift) & kBlockBitsMask;
        for (int n = 0; n < num_hashes; ++n) {
          atomicOr(s_block + (p >> 5), 1u << (p & 31u));
          p = (p + h2) & kBlockBitsMask;
        }
      });
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(
      words + (static_cast<int64_t>(blockIdx.x) << kBlockWordsLog2));
  for (int w = threadIdx.x; w < kBlockWords / 4; w += blockDim.x) {
    out[w] = s_block4[w];
  }
}

}  // namespace

// bloom_set_bits runs as four passes, each launched on `stream` by its
// own call so that the wrapper can scan the counts in between; each
// returns cudaGetLastError() of its launch (0 = ok).  `mask` may be null
// (every row is inserted).  `init1`..`init4` start the four hashes
// (hashing.hash_init of SEED_H1..SEED_H4; the last two only matter in a
// wide filter).  `wide` (nonzero from bloom.WIDE_LOG2_BITS bits on, and
// required above 2^32 bits) takes the probes from the 64-bit hashes.
// Region r holds positions [r, r + 1) << region_bits_log2, and there are
// 2^(top_log2 + sub_log2) regions (partition.cuh).  `ctas` must be the
// same in the count and the scatter.
//
// Count: `hist` ([ctas, 2^top_log2] uint32) gets every CTA's probes per
// top bucket.
extern "C" int bloom_partition_count(const void* kmers, const void* mask,
                                     long long rows, int lanes,
                                     unsigned int init1, unsigned int init2,
                                     unsigned int init3, unsigned int init4,
                                     int num_hashes, int log2_bits,
                                     int wide, int region_bits_log2,
                                     int top_log2, int sub_log2, int ctas,
                                     void* hist, void* stream) {
  const unsigned int init[4] = {init1, init2, init3, init4};
  return with_bloom_rows(
      kmers, mask, rows, lanes, init, num_hashes, log2_bits, wide,
      region_bits_log2, sub_log2, [&](const auto& in) {
        return p3::launch_partition_count(in, top_log2, sub_log2, ctas, hist,
                                          static_cast<cudaStream_t>(stream));
      });
}

// Scatter: `offsets` ([ctas, 2^top_log2] uint64) holds where each CTA's
// probes of each top bucket start in `part` (at least as many uint32 as
// the count found).
extern "C" int bloom_partition_scatter(const void* kmers, const void* mask,
                                       long long rows, int lanes,
                                       unsigned int init1, unsigned int init2,
                                       unsigned int init3, unsigned int init4,
                                       int num_hashes, int log2_bits,
                                       int wide, int region_bits_log2,
                                       int top_log2, int sub_log2, int ctas,
                                       const void* offsets, void* part,
                                       void* stream) {
  const unsigned int init[4] = {init1, init2, init3, init4};
  return with_bloom_rows(
      kmers, mask, rows, lanes, init, num_hashes, log2_bits, wide,
      region_bits_log2, sub_log2, [&](const auto& in) {
        return p3::launch_partition_scatter(
            in, top_log2, sub_log2, ctas, offsets, part,
            static_cast<cudaStream_t>(stream));
      });
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

// bloom_blocked_set_bits runs as four passes too, each launched on
// `stream` by its own call and returning cudaGetLastError() of its launch.
// The filter has 2^(top_log2 + sub_log2) blocks of 16384 words, one bucket
// of the partition each.  `mask` may be null; `ctas` must be the same in
// the count and the scatter.
//
// Count: `hist` ([ctas, 2^top_log2] uint32) gets every CTA's masked-in
// rows per top bucket.
extern "C" int bloom_blocked_partition_count(
    const void* kmers, const void* mask, long long rows, int lanes,
    unsigned int init1, unsigned int init2, int top_log2, int sub_log2,
    int ctas, void* hist, void* stream) {
  return p3::launch_partition_count(
      blocked_rows(kmers, mask, rows, lanes, init1, init2, top_log2,
                   sub_log2),
      top_log2, sub_log2, ctas, hist, static_cast<cudaStream_t>(stream));
}

// Scatter: `offsets` ([ctas, 2^top_log2] uint64) holds where each CTA's
// items of each top bucket start in `part` (at least as many uint64 as the
// count found).
extern "C" int bloom_blocked_partition_scatter(
    const void* kmers, const void* mask, long long rows, int lanes,
    unsigned int init1, unsigned int init2, int top_log2, int sub_log2,
    int ctas, const void* offsets, void* part, void* stream) {
  return p3::launch_partition_scatter(
      blocked_rows(kmers, mask, rows, lanes, init1, init2, top_log2,
                   sub_log2),
      top_log2, sub_log2, ctas, offsets, part,
      static_cast<cudaStream_t>(stream));
}

// Refine: `top_start` ([2^top_log2 + 1] int64) bounds each top bucket's
// run of `part`; writes the items grouped by block to `blocked` and where
// each block starts to `bucket_start` ([blocks + 1] int64).
extern "C" int bloom_blocked_partition_refine(const void* part,
                                              const void* top_start,
                                              int top_log2, int sub_log2,
                                              void* blocked,
                                              void* bucket_start,
                                              void* stream) {
  return p3::launch_partition_refine<BlockedRefine, unsigned long long>(
      BlockedRefine{}, top_log2, sub_log2, part, top_start, blocked,
      bucket_start, static_cast<cudaStream_t>(stream));
}

// Block build: `bucket_start` ([blocks + 1] int64) bounds each block's run
// of `blocked`.  Writes every word of `words` ([blocks * 16384]).
extern "C" int bloom_block_build(const void* blocked, const void* bucket_start,
                                 int blocks, int num_hashes, void* words,
                                 void* stream) {
  const auto kernel = bloom_block_build_kernel;
  const size_t smem = kBlockWords * sizeof(unsigned int);
  const cudaError_t err = p3::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(blocks), kRegionThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(blocked),
      static_cast<const int64_t*>(bucket_start), num_hashes,
      static_cast<unsigned int*>(words));
  return static_cast<int>(cudaGetLastError());
}
