// Two-level hash partition shared by oa_count_insert, bloom_set_bits and
// bloom_blocked_set_bits.
//
// All three group their items (a row's packed key; a probe's bit offset;
// a row's hash bits) by bucket (a table block; a filter region; a filter
// block) and then build each bucket in one CTA's shared memory.  The
// grouping takes three passes and no global atomic:
//
//   count:   a fixed grid of `ctas` CTAs walks the rows in tiles, tile j
//            to CTA j mod ctas, and tallies each item's top bucket (the
//            bucket's top `top_log2` bits) in shared memory, then stores
//            its row of counts;
//   scatter: the same grid walks the same tiles; each CTA writes its items
//            of each top bucket to its own range of the bucket's run (the
//            wrapper's scan of the counts, bucket-major);
//   refine:  one CTA per top bucket counts its sub-buckets, scans them and
//            scatters its run a second time, so that every bucket's items
//            lie together; it writes where each bucket starts.
//
// Both scatters go tile by tile (scatter_tile): the tile's items are read
// once, ranked per bucket, put in bucket order in shared memory, and each
// bucket's share of the tile is written as one contiguous piece.  Written
// item by item, a warp's 32 stores would go to 32 different sectors, and
// an H100's L2 serves such scattered 8-byte accesses (atomics or stores)
// at only about 25-30 G/s (chip_smoke.py's per-pass times).  A one-level partition into 2^15 buckets would leave
// too few items per bucket in a tile to form a piece; with at most 256
// top buckets a tile of 4096 items gives pieces of about 16.  The order
// inside a bucket is not deterministic.  Shared counts are 32-bit: one
// tile's items, or one top bucket's items of a sub-bucket.
//
// A Rows policy reads input row i with load(i), a `Row`, and gives its
// items with items(i, row, f), calling f(bucket, item) for each: `Item` is the
// item's type, `rows` the row count, `per_row()` the most items a row has.  A Refine policy gives an item's sub-bucket and
// the item to store after refining.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace p3 {

constexpr int kPartThreads = 1024;
constexpr int kMaxTopLog2 = 8;
constexpr int kTileItems = 4096;
constexpr int kUnroll = 4;
constexpr uint16_t kNoBucket = 0xFFFF;

// A scatter's shared memory for `n` buckets (n < kNoBucket): the global
// cursor of each bucket and its value at the start of the tile; the tile's
// items as read, with each one's bucket and rank in its bucket; the same
// items in bucket order, with their buckets; each bucket's count and
// offset in the tile, and the tile's item count.
template <class Item>
struct TileSmem {
  unsigned long long* cursor;
  unsigned long long* start;
  Item* raw;
  Item* sorted;
  unsigned int* count;
  unsigned int* offset;
  unsigned int* total;
  uint16_t* raw_bucket;
  uint16_t* raw_rank;
  uint16_t* sorted_bucket;

  static constexpr size_t bytes(int n) {
    return static_cast<size_t>(n) * (2 * sizeof(unsigned long long) +
                                     2 * sizeof(unsigned int)) +
           sizeof(unsigned int) +
           kTileItems * (2 * sizeof(Item) + 3 * sizeof(uint16_t));
  }

  __device__ static TileSmem carve(unsigned char* smem, int n) {
    TileSmem s;
    s.cursor = reinterpret_cast<unsigned long long*>(smem);
    s.start = s.cursor + n;
    s.raw = reinterpret_cast<Item*>(s.start + n);
    s.sorted = s.raw + kTileItems;
    s.count = reinterpret_cast<unsigned int*>(s.sorted + kTileItems);
    s.offset = s.count + n;
    s.total = s.offset + n;
    s.raw_bucket = reinterpret_cast<uint16_t*>(s.total + 1);
    s.raw_rank = s.raw_bucket + kTileItems;
    s.sorted_bucket = s.raw_rank + kTileItems;
    return s;
  }
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Warp 0 only: calls f(b, exclusive prefix, count[b]) for every b < n;
// returns the sum of the counts.  Each lane takes a run of consecutive
// buckets, so one shuffle scan covers them all.
template <class F>
__device__ __forceinline__ unsigned long long warp_scan(
    const unsigned int* count, int n, F&& f) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int per = (n + 31) / 32;
  const int lo = min(n, lane * per);
  const int hi = min(n, lo + per);
  unsigned long long sum = 0;
  for (int b = lo; b < hi; ++b) sum += count[b];
  unsigned long long x = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  unsigned long long excl = x - sum;
  for (int b = lo; b < hi; ++b) {
    const unsigned int c = count[b];
    f(b, excl, c);
    excl += c;
  }
  return __shfl_sync(0xFFFFFFFFu, x, 31);
}

// Calls f(i, load(i)) for this thread's i of [first, last), stepping by
// blockDim.x; the loads of kUnroll steps are issued before their uses, so
// that a thread keeps several reads in flight.
template <class Load, class F>
__device__ __forceinline__ void for_each_loaded(int64_t first, int64_t last,
                                                const Load& load, F&& f) {
  using T = decltype(load(first));
  for (int64_t i = first + threadIdx.x; i < last;
       i += static_cast<int64_t>(kUnroll) * blockDim.x) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t k = i + static_cast<int64_t>(u) * blockDim.x;
      if (k < last) v[u] = load(k);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t k = i + static_cast<int64_t>(u) * blockDim.x;
      if (k < last) f(k, v[u]);
    }
  }
}

// Scatters one tile to `out`.  `tile(f)` calls f(slot, bucket, item) for
// each item of the tile, each at its own slot < `slots` <= kTileItems.
// The items are ranked in their buckets as they are read, moved to bucket
// order in shared memory, and each bucket's share is written as one piece
// at the bucket's cursor, which moves on.
template <class Item, class Tile>
__device__ __forceinline__ void scatter_tile(const Tile& tile, int slots,
                                             int n, const TileSmem<Item>& s,
                                             Item* __restrict__ out) {
  for (int b = threadIdx.x; b < n; b += blockDim.x) s.count[b] = 0u;
  for (int j = threadIdx.x; j < slots; j += blockDim.x) {
    s.raw_bucket[j] = kNoBucket;
  }
  __syncthreads();
  tile([&](int j, uint32_t b, Item item) {
    s.raw[j] = item;
    s.raw_bucket[j] = static_cast<uint16_t>(b);
    s.raw_rank[j] = static_cast<uint16_t>(atomicAdd(s.count + b, 1u));
  });
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned long long total = warp_scan(
        s.count, n, [&](int b, unsigned long long excl, unsigned int c) {
          s.offset[b] = static_cast<unsigned int>(excl);
          s.start[b] = s.cursor[b];
          s.cursor[b] += c;
        });
    if (threadIdx.x == 0) *s.total = static_cast<unsigned int>(total);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < slots; j += blockDim.x) {
    const uint16_t b = s.raw_bucket[j];
    if (b == kNoBucket) continue;
    const unsigned int k = s.offset[b] + s.raw_rank[j];
    s.sorted[k] = s.raw[j];
    s.sorted_bucket[k] = b;
  }
  __syncthreads();
  const unsigned int total = *s.total;
  for (unsigned int k = threadIdx.x; k < total; k += blockDim.x) {
    const uint16_t b = s.sorted_bucket[k];
    out[s.start[b] + (k - s.offset[b])] = s.sorted[k];
  }
  __syncthreads();
}

// Rows per tile: whole rows of at most kTileItems items.
template <class Rows>
inline int64_t tile_rows(const Rows& in) {
  return kTileItems / (in.per_row() > 0 ? in.per_row() : 1);
}

template <class Rows>
__global__ void __launch_bounds__(kPartThreads, 2)
    partition_count_kernel(Rows in, int sub_log2, int tops, int64_t rows_per,
                           unsigned int* __restrict__ hist) {
  __shared__ unsigned int s_hist[1 << kMaxTopLog2];
  for (int t = threadIdx.x; t < tops; t += blockDim.x) s_hist[t] = 0u;
  __syncthreads();
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per;
       first < in.rows; first += static_cast<int64_t>(gridDim.x) * rows_per) {
    const int64_t last = min64(first + rows_per, in.rows);
    for_each_loaded(
        first, last, [&](int64_t i) { return in.load(i); },
        [&](int64_t i, const typename Rows::Row& row) {
          in.items(i, row, [&](uint32_t bucket, typename Rows::Item) {
            atomicAdd(s_hist + (bucket >> sub_log2), 1u);
          });
        });
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tops; t += blockDim.x) {
    hist[static_cast<int64_t>(blockIdx.x) * tops + t] = s_hist[t];
  }
}

template <class Rows>
__global__ void __launch_bounds__(kPartThreads, 2)
    partition_scatter_kernel(Rows in, int sub_log2, int tops,
                             int64_t rows_per,
                             const unsigned long long* __restrict__ offsets,
                             typename Rows::Item* __restrict__ part) {
  using Item = typename Rows::Item;
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem<Item> s = TileSmem<Item>::carve(smem, tops);
  for (int t = threadIdx.x; t < tops; t += blockDim.x) {
    s.cursor[t] = offsets[static_cast<int64_t>(blockIdx.x) * tops + t];
  }
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per;
       first < in.rows; first += static_cast<int64_t>(gridDim.x) * rows_per) {
    const int64_t last = min64(first + rows_per, in.rows);
    scatter_tile(
        [&](auto&& f) {
          for_each_loaded(
              first, last, [&](int64_t i) { return in.load(i); },
              [&](int64_t i, const typename Rows::Row& row) {
                int j = static_cast<int>(i - first) * in.per_row();
                in.items(i, row, [&](uint32_t bucket, Item item) {
                  f(j++, bucket >> sub_log2, item);
                });
              });
        },
        static_cast<int>(last - first) * in.per_row(), tops, s, part);
  }
}

template <class Refine, class Item>
__global__ void __launch_bounds__(kPartThreads, 2)
    partition_refine_kernel(Refine refine, const Item* __restrict__ part,
                            const int64_t* __restrict__ top_start, int subs,
                            Item* __restrict__ out,
                            int64_t* __restrict__ bucket_start) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem<Item> s = TileSmem<Item>::carve(smem, subs);
  const int64_t begin = top_start[blockIdx.x];
  const int64_t end = top_start[blockIdx.x + 1];
  for (int b = threadIdx.x; b < subs; b += blockDim.x) s.count[b] = 0u;
  __syncthreads();
  const auto read = [&](int64_t i) { return part[i]; };
  for_each_loaded(begin, end, read, [&](int64_t, Item item) {
    atomicAdd(s.count + refine.sub(item), 1u);
  });
  __syncthreads();
  if (threadIdx.x < 32) {
    const int64_t first = static_cast<int64_t>(blockIdx.x) * subs;
    warp_scan(s.count, subs,
              [&](int b, unsigned long long excl, unsigned int) {
                s.cursor[b] = begin + excl;
                bucket_start[first + b] = static_cast<int64_t>(begin + excl);
              });
    if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1) {
      bucket_start[first + subs] = end;
    }
  }
  __syncthreads();
  for (int64_t first = begin; first < end; first += kTileItems) {
    const int64_t last = min64(first + kTileItems, end);
    scatter_tile(
        [&](auto&& f) {
          for_each_loaded(first, last, read, [&](int64_t i, Item item) {
            f(static_cast<int>(i - first), refine.sub(item),
              refine.final_item(item));
          });
        },
        static_cast<int>(last - first), subs, s, out);
  }
}

// Allows `kernel` more than the default 48 KB of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

// Host launchers; each returns cudaGetLastError() of its launch.  `hist`
// is [ctas, 2^top_log2] uint32; `offsets` [ctas, 2^top_log2] uint64 (each
// CTA's start in each top bucket); `top_start` [2^top_log2 + 1] int64;
// `bucket_start` [2^(top_log2 + sub_log2) + 1] int64.  A row may have at
// most kTileItems items.
template <class Rows>
inline int launch_partition_count(const Rows& in, int top_log2,
                                  int sub_log2, int ctas, void* hist,
                                  cudaStream_t stream) {
  if (top_log2 > kMaxTopLog2 || in.per_row() > kTileItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in.rows <= 0) return static_cast<int>(cudaGetLastError());
  partition_count_kernel<Rows><<<ctas, kPartThreads, 0, stream>>>(
      in, sub_log2, 1 << top_log2, tile_rows(in),
      static_cast<unsigned int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

template <class Rows>
inline int launch_partition_scatter(const Rows& in, int top_log2,
                                    int sub_log2, int ctas,
                                    const void* offsets, void* part,
                                    cudaStream_t stream) {
  using Item = typename Rows::Item;
  if (top_log2 > kMaxTopLog2 || in.per_row() > kTileItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in.rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto kernel = partition_scatter_kernel<Rows>;
  const size_t smem = TileSmem<Item>::bytes(1 << top_log2);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ctas, kPartThreads, smem, stream>>>(
      in, sub_log2, 1 << top_log2, tile_rows(in),
      static_cast<const unsigned long long*>(offsets),
      static_cast<Item*>(part));
  return static_cast<int>(cudaGetLastError());
}

template <class Refine, class Item>
inline int launch_partition_refine(const Refine& refine, int top_log2,
                                   int sub_log2, const void* part,
                                   const void* top_start, void* out,
                                   void* bucket_start, cudaStream_t stream) {
  if (sub_log2 > 15) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = partition_refine_kernel<Refine, Item>;
  const size_t smem = TileSmem<Item>::bytes(1 << sub_log2);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1u << top_log2, kPartThreads, smem, stream>>>(
      refine, static_cast<const Item*>(part),
      static_cast<const int64_t*>(top_start), 1 << sub_log2,
      static_cast<Item*>(out), static_cast<int64_t*>(bucket_start));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace p3
