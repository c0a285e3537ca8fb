// Open-addressing k-mer count table on Hopper: oa_count_insert.
//
// Replaces platanus3_tpu/ops/count_pallas.py::_insert_kernel (driven by
// count_kmers_oa).  The table has 2^g blocks of 8192 slots.  A contributing
// k-mer row with hash h1 (hash.cuh, seed 1) goes to block h1 >> (32 - g)
// (block 0 when g = 0), starts at slot h1 & 8191 of that block and probes
// linearly, wrapping inside the block, until it finds its own key or an
// empty slot.  Each row adds 1 to its slot's count; a row whose block is
// full is counted in `overflow`.
//
// Design.  Hash-partition the rows by block, then build each block in
// shared memory.  The partition (partition.cuh: count, scatter, refine)
// groups the packed keys (lane0 << 32 | lane1) into per-block runs of a
// scratch array with no global atomic.  Then one CTA per block holds the
// block's 8192 packed keys and counts (96 KB of dynamic shared memory, two
// CTAs an SM).  In the block, a slot is claimed by a 64-bit shared
// atomicCAS and counted by a shared atomicAdd; keys are written once and
// never change, so a slot read as a key is final and only a slot read as
// empty needs the CAS.  Equal keys in a warp are merged by
// __match_any_sync first, so the group's leader probes once and adds the
// group's size: a highly repeated k-mer (a homopolymer run) does not
// serialise the warp on one counter.  The CTA then writes its block of
// lane-major keys and counts once, coalesced, empty slots included, so the
// outputs need no fill.  The Pallas kernel also sorted by hash and built
// each block in SMEM, because Mosaic has no atomics; here the reason is
// that every random access and atomic stays on the SM instead of costing a
// sector round trip to device memory.  Slot layout depends on the order of
// the atomics; the set of (key, count) pairs does not.
//
// The empty marker is the packed value with all 64 bits set.  At k = 32 it
// is T^32, whose reverse complement A^32 = 0 is smaller, so it is never a
// canonical k-mer; at k < 32 it lies outside the 2k-bit range.  A row that
// packs to it anyway is counted in `overflow`, never dropped silently.
//
// Bound.  The least traffic is the lanes and flags read once and the keys
// and counts written once; at the main run's 2^28 slots the 5.4 GB of
// outputs dominate it.  The partition adds a second read of the input and,
// a row, its 8-byte scratch key written twice and read three times; in
// exchange no access goes to device memory at random.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// (platanus3_tpu_torch/kernels.py), bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"
#include "partition.cuh"

namespace {

constexpr int kSlotsLog2 = 13;
constexpr int kSlots = 1 << kSlotsLog2;
constexpr uint32_t kSlotMask = kSlots - 1u;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kInsertThreads = 1024;
constexpr size_t kBlockSmem =
    kSlots * (sizeof(unsigned long long) + sizeof(unsigned int));

__device__ __forceinline__ uint32_t block_of(uint32_t h1, int g_log2) {
  return g_log2 > 0 ? h1 >> (32 - g_log2) : 0u;
}

// The partition's rows: each contributing row's packed key, bucketed by
// its block.  With `overflow` set (the count pass), a row that packs to
// the empty marker is added to it; it is never partitioned.
struct OARows {
  using Item = unsigned long long;
  const int64_t* kmers;
  const uint8_t* contrib;
  int64_t rows;
  int lanes;
  uint32_t init1;
  int g_log2;
  unsigned long long* overflow;

  __host__ __device__ int per_row() const { return 1; }

  struct Row {
    unsigned long long key;
    uint8_t flag;
  };

  __device__ __forceinline__ Row load(int64_t i) const {
    return Row{p3::pack_row(kmers + i * lanes, lanes), contrib[i]};
  }

  template <class F>
  __device__ __forceinline__ void items(const Row& row, F&& f) const {
    if (row.flag == 0) return;
    if (row.key == kEmpty) {
      if (overflow != nullptr) atomicAdd(overflow, 1ull);
      return;
    }
    f(block_of(p3::hash_packed(row.key, lanes, init1), g_log2), row.key);
  }
};

struct OARefine {
  int lanes;
  uint32_t init1;
  int g_log2;
  uint32_t sub_mask;

  __device__ __forceinline__ uint32_t sub(unsigned long long key) const {
    return block_of(p3::hash_packed(key, lanes, init1), g_log2) & sub_mask;
  }
  __device__ __forceinline__ unsigned long long final_item(
      unsigned long long key) const {
    return key;
  }
};

// Lane j of a packed key as the table stores it; 0xFFFFFFFF in every lane
// of an empty slot.
__device__ __forceinline__ long long lane_of(unsigned long long key, int j,
                                             int lanes) {
  if (key == kEmpty) return 0xFFFFFFFFll;
  if (lanes == 1) return static_cast<long long>(key);
  return static_cast<long long>(j == 0 ? key >> 32 : key & 0xFFFFFFFFull);
}

// Block insert: one CTA per block.  `bucket_start` ([2^g + 1]) bounds
// each block's run of `part`.
__global__ void __launch_bounds__(kInsertThreads, 2)
    oa_block_insert_kernel(const unsigned long long* __restrict__ part,
                           const int64_t* __restrict__ bucket_start,
                           int lanes, uint32_t init1, int64_t table_size,
                           int64_t* __restrict__ keys,
                           int* __restrict__ counts,
                           unsigned long long* __restrict__ overflow) {
  extern __shared__ unsigned long long s_keys[];  // [kSlots], then counts
  unsigned int* s_counts = reinterpret_cast<unsigned int*>(s_keys + kSlots);
  __shared__ unsigned int s_overflow;
  const int64_t begin = bucket_start[blockIdx.x];
  const int64_t n = bucket_start[blockIdx.x + 1] - begin;
  // Each thread's first key is read while the block is cleared, and each
  // pass reads the next pass's key ahead.
  unsigned long long next = threadIdx.x < n ? part[begin + threadIdx.x] : 0;
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    s_keys[s] = kEmpty;
    s_counts[s] = 0u;
  }
  if (threadIdx.x == 0) s_overflow = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  volatile unsigned long long* seen_keys = s_keys;
  // The loop bound is uniform across a warp, so the ballot sees all lanes.
  for (int64_t base = threadIdx.x & ~31; base < n; base += blockDim.x) {
    const bool have = base + lane < n;
    const unsigned int active = __ballot_sync(0xFFFFFFFFu, have);
    if (!have) break;  // only the warp's last pass has idle lanes
    const unsigned long long key = next;
    if (base + blockDim.x + lane < n) {
      next = part[begin + base + blockDim.x + lane];
    }
    const unsigned int group = __match_any_sync(active, key);
    if (lane != __ffs(group) - 1) continue;
    const unsigned int rows = __popc(group);
    const uint32_t home = p3::hash_packed(key, lanes, init1) & kSlotMask;
    bool placed = false;
    for (uint32_t s = 0; s <= kSlotMask; ++s) {
      const uint32_t slot = (home + s) & kSlotMask;
      unsigned long long seen = seen_keys[slot];
      if (seen == kEmpty) {
        seen = atomicCAS(s_keys + slot, kEmpty, key);
        if (seen == kEmpty) seen = key;  // claimed
      }
      if (seen == key) {
        atomicAdd(s_counts + slot, rows);
        placed = true;
        break;
      }
    }
    if (!placed) atomicAdd(&s_overflow, rows);
  }
  __syncthreads();

  // Two slots a thread, so each lane's keys and the counts go out in
  // 16- and 8-byte stores.
  const int64_t first = static_cast<int64_t>(blockIdx.x) << kSlotsLog2;
  for (int s = 2 * threadIdx.x; s < kSlots; s += 2 * blockDim.x) {
    const unsigned long long k0 = s_keys[s], k1 = s_keys[s + 1];
    const longlong2 hi = {lane_of(k0, 0, lanes), lane_of(k1, 0, lanes)};
    reinterpret_cast<longlong2*>(keys + first)[s >> 1] = hi;
    if (lanes == 2) {
      const longlong2 lo = {lane_of(k0, 1, lanes), lane_of(k1, 1, lanes)};
      reinterpret_cast<longlong2*>(keys + table_size + first)[s >> 1] = lo;
    }
    reinterpret_cast<int2*>(counts + first)[s >> 1] =
        make_int2(static_cast<int>(s_counts[s]),
                  static_cast<int>(s_counts[s + 1]));
  }
  if (threadIdx.x == 0 && s_overflow != 0u) {
    atomicAdd(overflow, static_cast<unsigned long long>(s_overflow));
  }
}

}  // namespace

// The four passes, each launched on `stream` by its own call so that the
// wrapper can scan the counts in between; each returns cudaGetLastError()
// of its launch (0 = ok).  The table has T = 2^g_log2 * 8192 slots, one
// bucket of the partition per block, with g_log2 = top_log2 + sub_log2
// (partition.cuh).  `ctas` must be the same in the count and the scatter.
//
// Count: `hist` ([ctas, 2^top_log2] uint32) gets every CTA's rows per top
// bucket, and `overflow` (one uint64, zeroed) every row that packs to the
// empty marker.
extern "C" int oa_partition_count(const void* kmers, const void* contrib,
                                  long long rows, int lanes,
                                  unsigned int init1, int top_log2,
                                  int sub_log2, int ctas, void* hist,
                                  void* overflow, void* stream) {
  const OARows in{static_cast<const int64_t*>(kmers),
                  static_cast<const uint8_t*>(contrib), rows, lanes, init1,
                  top_log2 + sub_log2,
                  static_cast<unsigned long long*>(overflow)};
  return p3::launch_partition_count(in, top_log2, sub_log2, ctas, hist,
                                    static_cast<cudaStream_t>(stream));
}

// Scatter: `offsets` ([ctas, 2^top_log2] uint64) holds where each CTA's
// rows of each top bucket start in `part` (at least as many uint64 as the
// count found).
extern "C" int oa_partition_scatter(const void* kmers, const void* contrib,
                                    long long rows, int lanes,
                                    unsigned int init1, int top_log2,
                                    int sub_log2, int ctas,
                                    const void* offsets, void* part,
                                    void* stream) {
  const OARows in{static_cast<const int64_t*>(kmers),
                  static_cast<const uint8_t*>(contrib), rows, lanes, init1,
                  top_log2 + sub_log2, nullptr};
  return p3::launch_partition_scatter(in, top_log2, sub_log2, ctas, offsets,
                                      part, static_cast<cudaStream_t>(stream));
}

// Refine: `top_start` ([2^top_log2 + 1] int64) bounds each top bucket's
// run of `part`; writes the runs grouped by block to `blocked` and where
// each block starts to `bucket_start` ([2^g + 1] int64).
extern "C" int oa_partition_refine(const void* part, const void* top_start,
                                   int lanes, unsigned int init1,
                                   int top_log2, int sub_log2, void* blocked,
                                   void* bucket_start, void* stream) {
  const OARefine refine{lanes, init1, top_log2 + sub_log2,
                        (1u << sub_log2) - 1u};
  return p3::launch_partition_refine<OARefine, unsigned long long>(
      refine, top_log2, sub_log2, part, top_start, blocked, bucket_start,
      static_cast<cudaStream_t>(stream));
}

// Block insert: `bucket_start` ([2^g + 1] int64) bounds each block's run
// of `blocked`.  Writes every slot of `counts` ([T] int32) and `keys`
// ([lanes, T] int64, 0xFFFFFFFF in each lane of an empty slot), and adds
// the rows that found their block full to `overflow`.
extern "C" int oa_block_insert(const void* blocked, const void* bucket_start,
                               int lanes, unsigned int init1, int g_log2,
                               void* keys, void* counts, void* overflow,
                               void* stream) {
  const auto kernel = oa_block_insert_kernel;
  const cudaError_t err = p3::allow_smem(kernel, kBlockSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t table_size = static_cast<int64_t>(1) << (g_log2 + kSlotsLog2);
  kernel<<<1u << g_log2, kInsertThreads, kBlockSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(blocked),
      static_cast<const int64_t*>(bucket_start), lanes, init1, table_size,
      static_cast<int64_t*>(keys), static_cast<int*>(counts),
      static_cast<unsigned long long*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
