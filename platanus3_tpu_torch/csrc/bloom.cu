// Packed Bloom-filter build on Hopper: bloom_set_bits.
//
// Replaces platanus3_tpu/ops/bloom_pallas.py::_set_bits_kernel (driven by
// build_packed_bloom).  It computes the same packed words as
// platanus3_tpu/ops/bloom.py::bloom_add: for each masked-in k-mer and each
// n < num_hashes, bit (p & 31) of word (p >> 5) is set, where
// p = (h1 + n*h2) mod 2^log2_bits and (h1, h2) is the murmur double hash of
// ops/hashing.py, here in native uint32 arithmetic.
//
// Design.  One thread per k-mer row reads the row's L int64 lanes (each a
// uint32 value) and its mask byte, hashes, and issues num_hashes atomicOr
// of 1u << (p & 31) into words[p >> 5].  OR is idempotent and commutative,
// so the words do not depend on the order of the atomics and need no sort
// and no dedup.  The TPU kernel's position sort, SMEM blocks, overflow
// block and chunk budget existed only because Mosaic allows scalar
// read-modify-write in SMEM alone; none of them is carried over, and this
// kernel cannot leave a position uncovered.
//
// Bound.  Random 4-byte atomics to device memory: a 2^30-bit filter is
// 128 MB, which does not fit in the H100's 50 MB L2, so nearly every probe
// is a miss to HBM.  Making it faster (a blocked layout whose probes share
// one cache line, or staging a filter block in shared memory) is later
// work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (platanus3_tpu_torch/kernels.py), bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kMix1;
  h ^= h >> 13;
  h *= kMix2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_row(const int64_t* row, int lanes,
                                             uint32_t init) {
  uint32_t h = init;
  for (int j = 0; j < lanes; ++j) {
    uint32_t kx = static_cast<uint32_t>(row[j]) * kC1;
    kx = rotl32(kx, 15) * kC2;
    h ^= kx;
    h = rotl32(h, 13) * 5u + 0xE6546B64u;
  }
  return fmix32(h ^ static_cast<uint32_t>(4 * lanes));
}

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
    const int64_t* row = kmers + i * lanes;
    const uint32_t h1 = hash_row(row, lanes, init1);
    const uint32_t h2 = hash_row(row, lanes, init2) | 1u;
    for (int n = 0; n < num_hashes; ++n) {
      const uint32_t p = (h1 + static_cast<uint32_t>(n) * h2) & pos_mask;
      atomicOr(words + (p >> 5), 1u << (p & 31u));
    }
  }
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
  long long blocks = (rows + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  bloom_set_bits_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(kmers), static_cast<const uint8_t*>(mask),
      static_cast<int64_t>(rows), lanes, init1, init2, num_hashes, pos_mask,
      static_cast<unsigned int*>(words));
  return static_cast<int>(cudaGetLastError());
}
