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
// Design.  One thread per input row, no pre-sort.  The Pallas kernel sorts
// by hash, run-aggregates and gives each block an SMEM table only because
// Mosaic has no atomics; here a slot is claimed by one 64-bit atomicCAS on
// the packed key (lane0 << 32 | lane1) and the row's contribution is an
// atomicAdd on the slot's int32 count.  Keys are written once and never
// change, so a plain (L2) read of a slot that shows a key is final; only a
// slot read as empty needs the CAS.  The CAS winner also writes the key's
// lanes into the lane-major output, so no second pass is needed.  Slot
// layout depends on the order of the atomics; the set of (key, count)
// pairs does not.
//
// The empty marker is the packed value with all 64 bits set.  At k = 32 it
// is T^32, whose reverse complement A^32 = 0 is smaller, so it is never a
// canonical k-mer; at k < 32 it lies outside the 2k-bit range.  A row that
// packs to it anyway is counted in `overflow`, never dropped silently.
//
// Bound.  Each row reads its lanes once (16 B) and touches one random
// 8-byte slot and one random 4-byte count in tables that, at the main
// run's 2^28 slots, far exceed the 50 MB L2: two random sector accesses a
// row.  The shared-memory form (one block's 8192 slots x 12 B = 96 KB fits
// in one CTA) is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// (platanus3_tpu_torch/kernels.py), bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kSlotsLog2 = 13;
constexpr uint32_t kSlotMask = (1u << kSlotsLog2) - 1u;
constexpr unsigned long long kEmpty = ~0ull;

__global__ void oa_count_insert_kernel(
    const int64_t* __restrict__ kmers, const uint8_t* __restrict__ contrib,
    int64_t rows, int lanes, uint32_t init1, int g_log2, int64_t table_size,
    unsigned long long* __restrict__ slots, int* __restrict__ counts,
    int64_t* __restrict__ keys, unsigned long long* __restrict__ overflow) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < rows; i += stride) {
    if (contrib[i] == 0) continue;
    const int64_t* row = kmers + i * lanes;
    const uint32_t lane0 = static_cast<uint32_t>(row[0]);
    const unsigned long long key =
        lanes == 1 ? lane0
                   : (static_cast<unsigned long long>(lane0) << 32) |
                         static_cast<uint32_t>(row[1]);
    if (key == kEmpty) {
      atomicAdd(overflow, 1ull);
      continue;
    }
    const uint32_t h1 = p3::hash_row(row, lanes, init1);
    const int64_t base =
        g_log2 > 0 ? static_cast<int64_t>(h1 >> (32 - g_log2)) << kSlotsLog2
                   : 0;
    const uint32_t home = h1 & kSlotMask;
    bool placed = false;
    for (uint32_t s = 0; s <= kSlotMask; ++s) {
      const int64_t slot = base + ((home + s) & kSlotMask);
      unsigned long long seen = __ldcg(slots + slot);
      if (seen == kEmpty) {
        seen = atomicCAS(slots + slot, kEmpty, key);
        if (seen == kEmpty) {  // claimed: publish the lanes
          for (int j = 0; j < lanes; ++j) keys[j * table_size + slot] = row[j];
          seen = key;
        }
      }
      if (seen == key) {
        atomicAdd(counts + slot, 1);
        placed = true;
        break;
      }
    }
    if (!placed) atomicAdd(overflow, 1ull);
  }
}

}  // namespace

// Inserts every row with contrib[i] != 0 into the table.  `slots` ([T]
// uint64) must hold the all-ones empty marker, `counts` ([T] int32) zeros,
// `keys` ([lanes, T] int64) the lanes to report for empty slots, and
// `overflow` (one uint64) zero; T = 2^g_log2 * 8192.  Launches on `stream`;
// returns cudaGetLastError() of the launch (0 = ok).
extern "C" int oa_count_insert(const void* kmers, const void* contrib,
                               long long rows, int lanes, unsigned int init1,
                               int g_log2, void* slots, void* counts,
                               void* keys, void* overflow, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  long long blocks = (rows + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  const int64_t table_size = static_cast<int64_t>(1) << (g_log2 + kSlotsLog2);
  oa_count_insert_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(kmers),
      static_cast<const uint8_t*>(contrib), static_cast<int64_t>(rows),
      lanes, init1, g_log2, table_size,
      static_cast<unsigned long long*>(slots), static_cast<int*>(counts),
      static_cast<int64_t*>(keys),
      static_cast<unsigned long long*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
