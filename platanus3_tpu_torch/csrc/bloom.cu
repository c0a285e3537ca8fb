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
// Design.  One thread per k-mer row reads the row's L int64 lanes (each a
// uint32 value) and its mask byte, hashes, and issues num_hashes atomicOr
// of 1u << (p & 31) into the probed word.  OR is idempotent and
// commutative, so the words do not depend on the order of the atomics and
// need no sort and no dedup.  The TPU kernels' sorts, SMEM blocks, overflow
// block and chunk budget existed only because Mosaic allows scalar
// read-modify-write in SMEM alone; none of them is carried over, and these
// kernels cannot leave a position uncovered.
//
// Bound.  Random 4-byte atomics to device memory.  A 2^30-bit flat filter
// is 128 MB and does not fit in the H100's 50 MB L2, so nearly every probe
// of bloom_set_bits is a miss to HBM.  The blocked layout keeps a row's
// probes inside one 64 KB block, but its 10 probes still touch 10
// different 32-byte sectors of it.  Staging a block in shared memory (a
// 64 KB block fits in one CTA) is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// (platanus3_tpu_torch/kernels.py), bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr uint32_t kBlockBitsMask = (1u << 19) - 1u;
constexpr int kBlockWordsLog2 = 14;

__global__ void bloom_set_bits_kernel(const int64_t* __restrict__ kmers,
                                      const uint8_t* __restrict__ mask,
                                      int64_t rows, int lanes,
                                      uint32_t init1, uint32_t init2,
                                      int num_hashes, uint32_t pos_mask,
                                      unsigned int* __restrict__ words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < rows; i += stride) {
    if (mask != nullptr && mask[i] == 0) continue;
    uint32_t h1, h2;
    p3::double_hash_row(kmers + i * lanes, lanes, init1, init2, &h1, &h2);
    for (int n = 0; n < num_hashes; ++n) {
      const uint32_t p = (h1 + static_cast<uint32_t>(n) * h2) & pos_mask;
      atomicOr(words + (p >> 5), 1u << (p & 31u));
    }
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

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
// `mask` may be null (every row is inserted).
extern "C" int bloom_set_bits(const void* kmers, const void* mask,
                              long long rows, int lanes, unsigned int init1,
                              unsigned int init2, int num_hashes,
                              unsigned int pos_mask, void* words,
                              void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  bloom_set_bits_kernel<<<grid_for(rows, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(kmers), static_cast<const uint8_t*>(mask),
      static_cast<int64_t>(rows), lanes, init1, init2, num_hashes, pos_mask,
      static_cast<unsigned int*>(words));
  return static_cast<int>(cudaGetLastError());
}

// Blocked build into `words` (2^log2_blocks blocks of 16384 words, already
// zeroed or holding an earlier build).  Same conventions as bloom_set_bits.
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
