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
// groups the packed keys (lane0 << 32 | lane1; for a row of more than two
// lanes, its index) into per-block runs of a scratch array with no global
// atomic.  Then one CTA per block holds the
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
// The empty marker is the packed value with all 64 bits set (every lane
// 0xFFFFFFFF).  Where the top lane is full it is T^k, whose reverse
// complement A^k = 0 is smaller, so it is never a canonical k-mer;
// otherwise it lies outside the 2k-bit range.  A row equal to it anyway is
// counted in `overflow`, never dropped silently.  Rows of more than two
// lanes are inserted by oa_block_insert_rows_kernel (below).
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

// True when every lane of the row is 0xFFFFFFFF: the empty marker.
__device__ __forceinline__ bool all_ones(const int64_t* row, int lanes) {
  bool ones = true;
  for (int j = 0; j < lanes; ++j) ones &= row[j] == 0xFFFFFFFFll;
  return ones;
}

// The partition's rows: each contributing row, bucketed by its block.
// With kPacked (one or two lanes) a row travels as its packed key;
// otherwise as its index, from which its lanes are read again.  With
// `overflow` set (the count pass), a row equal to the empty marker is
// added to it; it is never partitioned.  The two cases are separate
// instantiations, so that the packed one keeps its registers.
template <bool kPacked>
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
    return Row{kPacked ? p3::pack_row(kmers + i * lanes, lanes) : 0ull,
               contrib[i]};
  }

  template <class F>
  __device__ __forceinline__ void items(int64_t i, const Row& row,
                                        F&& f) const {
    if (row.flag == 0) return;
    if constexpr (kPacked) {
      if (row.key == kEmpty) {
        if (overflow != nullptr) atomicAdd(overflow, 1ull);
        return;
      }
      f(block_of(p3::hash_packed(row.key, lanes, init1), g_log2), row.key);
    } else {
      const int64_t* r = kmers + i * lanes;
      if (all_ones(r, lanes)) {
        if (overflow != nullptr) atomicAdd(overflow, 1ull);
        return;
      }
      f(block_of(p3::hash_row(r, lanes, init1), g_log2),
        static_cast<unsigned long long>(i));
    }
  }
};

template <bool kPacked>
struct OARefine {
  const int64_t* kmers;
  int lanes;
  uint32_t init1;
  int g_log2;
  uint32_t sub_mask;

  __device__ __forceinline__ uint32_t sub(unsigned long long item) const {
    uint32_t h1;
    if constexpr (kPacked) {
      h1 = p3::hash_packed(item, lanes, init1);
    } else {
      h1 = p3::hash_row(kmers + static_cast<int64_t>(item) * lanes, lanes,
                        init1);
    }
    return block_of(h1, g_log2) & sub_mask;
  }
  __device__ __forceinline__ unsigned long long final_item(
      unsigned long long item) const {
    return item;
  }
};

// Calls launch(rows) with the OARows instantiation that fits `lanes`.
template <class Launch>
int with_oa_rows(const void* kmers, const void* contrib, long long rows,
                 int lanes, unsigned int init1, int g_log2, void* overflow,
                 Launch&& launch) {
  const auto make = [&](auto rows_of) {
    using Rows = decltype(rows_of);
    return Rows{static_cast<const int64_t*>(kmers),
                static_cast<const uint8_t*>(contrib), rows, lanes, init1,
                g_log2, static_cast<unsigned long long*>(overflow)};
  };
  return lanes <= 2 ? launch(make(OARows<true>{}))
                    : launch(make(OARows<false>{}));
}

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

// Block insert of rows of more than two lanes: one CTA per block, as
// oa_block_insert_kernel, but a slot holds the index of the first row that
// claimed it, since L lanes of 8192 keys do not fit in shared memory.  A
// row compares its lanes with those of the slot's row (read again from
// device memory, mostly from L1), and equal keys are not merged in the
// warp first.  The CTA then writes each slot's key lane by lane.
__global__ void __launch_bounds__(kInsertThreads, 2)
    oa_block_insert_rows_kernel(const unsigned long long* __restrict__ part,
                                const int64_t* __restrict__ bucket_start,
                                const int64_t* __restrict__ kmers, int lanes,
                                uint32_t init1, int64_t table_size,
                                int64_t* __restrict__ keys,
                                int* __restrict__ counts,
                                unsigned long long* __restrict__ overflow) {
  extern __shared__ unsigned long long s_rows[];  // [kSlots], then counts
  unsigned int* s_counts = reinterpret_cast<unsigned int*>(s_rows + kSlots);
  __shared__ unsigned int s_overflow;
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    s_rows[s] = kEmpty;
    s_counts[s] = 0u;
  }
  if (threadIdx.x == 0) s_overflow = 0u;
  __syncthreads();

  volatile unsigned long long* seen_rows = s_rows;
  const int64_t end = bucket_start[blockIdx.x + 1];
  for (int64_t j = bucket_start[blockIdx.x] + threadIdx.x; j < end;
       j += blockDim.x) {
    const unsigned long long row = part[j];
    const int64_t* mine = kmers + static_cast<int64_t>(row) * lanes;
    const uint32_t home = p3::hash_row(mine, lanes, init1) & kSlotMask;
    bool placed = false;
    for (uint32_t s = 0; s <= kSlotMask; ++s) {
      const uint32_t slot = (home + s) & kSlotMask;
      unsigned long long seen = seen_rows[slot];
      if (seen == kEmpty) {
        seen = atomicCAS(s_rows + slot, kEmpty, row);
        if (seen == kEmpty) seen = row;  // claimed
      }
      bool same = seen == row;
      if (!same) {
        const int64_t* other = kmers + static_cast<int64_t>(seen) * lanes;
        same = true;
        for (int l = 0; l < lanes && same; ++l) same = other[l] == mine[l];
      }
      if (same) {
        atomicAdd(s_counts + slot, 1u);
        placed = true;
        break;
      }
    }
    if (!placed) atomicAdd(&s_overflow, 1u);
  }
  __syncthreads();

  const int64_t first = static_cast<int64_t>(blockIdx.x) << kSlotsLog2;
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    const unsigned long long row = s_rows[s];
    for (int l = 0; l < lanes; ++l) {
      keys[l * table_size + first + s] =
          row == kEmpty ? 0xFFFFFFFFll
                        : kmers[static_cast<int64_t>(row) * lanes + l];
    }
    counts[first + s] = static_cast<int>(s_counts[s]);
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
  return with_oa_rows(kmers, contrib, rows, lanes, init1, top_log2 + sub_log2,
                      overflow, [&](const auto& in) {
                        return p3::launch_partition_count(
                            in, top_log2, sub_log2, ctas, hist,
                            static_cast<cudaStream_t>(stream));
                      });
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
  return with_oa_rows(kmers, contrib, rows, lanes, init1, top_log2 + sub_log2,
                      nullptr, [&](const auto& in) {
                        return p3::launch_partition_scatter(
                            in, top_log2, sub_log2, ctas, offsets, part,
                            static_cast<cudaStream_t>(stream));
                      });
}

// Refine: `top_start` ([2^top_log2 + 1] int64) bounds each top bucket's
// run of `part`; writes the runs grouped by block to `blocked` and where
// each block starts to `bucket_start` ([2^g + 1] int64).  `kmers` is the
// count's input (read for rows of more than two lanes).
extern "C" int oa_partition_refine(const void* part, const void* top_start,
                                   const void* kmers, int lanes,
                                   unsigned int init1, int top_log2,
                                   int sub_log2, void* blocked,
                                   void* bucket_start, void* stream) {
  const auto refine_with = [&](auto refine) {
    return p3::launch_partition_refine<decltype(refine), unsigned long long>(
        refine, top_log2, sub_log2, part, top_start, blocked, bucket_start,
        static_cast<cudaStream_t>(stream));
  };
  const auto* rows_in = static_cast<const int64_t*>(kmers);
  const int g_log2 = top_log2 + sub_log2;
  const uint32_t sub_mask = (1u << sub_log2) - 1u;
  return lanes <= 2
             ? refine_with(
                   OARefine<true>{rows_in, lanes, init1, g_log2, sub_mask})
             : refine_with(
                   OARefine<false>{rows_in, lanes, init1, g_log2, sub_mask});
}

// Block insert: `bucket_start` ([2^g + 1] int64) bounds each block's run
// of `blocked`.  Writes every slot of `counts` ([T] int32) and `keys`
// ([lanes, T] int64, 0xFFFFFFFF in each lane of an empty slot), and adds
// the rows that found their block full to `overflow`.  `kmers` is the
// count's input (read for rows of more than two lanes).
extern "C" int oa_block_insert(const void* blocked, const void* bucket_start,
                               const void* kmers, int lanes,
                               unsigned int init1, int g_log2, void* keys,
                               void* counts, void* overflow, void* stream) {
  const int64_t table_size = static_cast<int64_t>(1) << (g_log2 + kSlotsLog2);
  if (lanes > 2) {
    const auto kernel = oa_block_insert_rows_kernel;
    const cudaError_t err = p3::allow_smem(kernel, kBlockSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<1u << g_log2, kInsertThreads, kBlockSmem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(blocked),
        static_cast<const int64_t*>(bucket_start),
        static_cast<const int64_t*>(kmers), lanes, init1, table_size,
        static_cast<int64_t*>(keys), static_cast<int*>(counts),
        static_cast<unsigned long long*>(overflow));
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = oa_block_insert_kernel;
  const cudaError_t err = p3::allow_smem(kernel, kBlockSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1u << g_log2, kInsertThreads, kBlockSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(blocked),
      static_cast<const int64_t*>(bucket_start), lanes, init1, table_size,
      static_cast<int64_t*>(keys), static_cast<int*>(counts),
      static_cast<unsigned long long*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
