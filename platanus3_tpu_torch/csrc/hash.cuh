// The k-mer double hash shared by every kernel of the port.
//
// Murmur3-32-style mixing over the uint32 lanes of one k-mer row, bit-equal
// to platanus3_tpu_torch/ops/hashing.py (and so to the JAX package's
// ops/hashing.py): `init` is hashing.hash_init(k, seed), and h2 is forced
// odd so the double-hash probe sequence has full period in a power-of-two
// filter.  Lanes arrive as int64 holding uint32 values.

#pragma once

#include <cstdint>

namespace p3 {

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

__device__ __forceinline__ uint32_t mix_lane(uint32_t h, uint32_t lane) {
  uint32_t kx = lane * kC1;
  kx = rotl32(kx, 15) * kC2;
  h ^= kx;
  return rotl32(h, 13) * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t hash_row(const int64_t* row, int lanes,
                                             uint32_t init) {
  uint32_t h = init;
  for (int j = 0; j < lanes; ++j) {
    h = mix_lane(h, static_cast<uint32_t>(row[j]));
  }
  return fmix32(h ^ static_cast<uint32_t>(4 * lanes));
}

// A row's lanes packed into one value: lane0 << 32 | lane1 (lanes = 2) or
// lane0 (lanes = 1).
__device__ __forceinline__ unsigned long long pack_row(const int64_t* row,
                                                       int lanes) {
  const uint32_t lane0 = static_cast<uint32_t>(row[0]);
  return lanes == 1 ? lane0
                    : (static_cast<unsigned long long>(lane0) << 32) |
                          static_cast<uint32_t>(row[1]);
}

// hash_row of a row given packed (pack_row).
__device__ __forceinline__ uint32_t hash_packed(unsigned long long key,
                                                int lanes, uint32_t init) {
  uint32_t h = init;
  if (lanes == 2) h = mix_lane(h, static_cast<uint32_t>(key >> 32));
  h = mix_lane(h, static_cast<uint32_t>(key));
  return fmix32(h ^ static_cast<uint32_t>(4 * lanes));
}

// The N hashes of one row with the starts init[0..N), in one pass over its
// lanes (each lane read once).
template <int N>
__device__ __forceinline__ void hash_row_n(const int64_t* row, int lanes,
                                           const uint32_t* init,
                                           uint32_t* h) {
#pragma unroll
  for (int s = 0; s < N; ++s) h[s] = init[s];
  for (int j = 0; j < lanes; ++j) {
    const uint32_t lane = static_cast<uint32_t>(row[j]);
#pragma unroll
    for (int s = 0; s < N; ++s) h[s] = mix_lane(h[s], lane);
  }
#pragma unroll
  for (int s = 0; s < N; ++s) {
    h[s] = fmix32(h[s] ^ static_cast<uint32_t>(4 * lanes));
  }
}

// hashing.double_hash: (h1, h2) with h2 odd.
__device__ __forceinline__ void double_hash_row(const int64_t* row, int lanes,
                                                uint32_t init1,
                                                uint32_t init2, uint32_t* h1,
                                                uint32_t* h2) {
  *h1 = hash_row(row, lanes, init1);
  *h2 = hash_row(row, lanes, init2) | 1u;
}

// murmur3's 64-bit finaliser (a bijection of uint64).
__device__ __forceinline__ unsigned long long fmix64(unsigned long long h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ull;
  h ^= h >> 33;
  return h;
}

// hashing.hash64_kmers under the N seeds seed[0..N): the row's lanes
// packed into 64-bit words as count.pack_keys packs them (an odd lane
// count puts lane 0 alone in the first word), each folded in as
// h = fmix64(h ^ word).
template <int N>
__device__ __forceinline__ void hash64_row(const int64_t* row, int lanes,
                                           const unsigned long long* seed,
                                           unsigned long long* h) {
#pragma unroll
  for (int s = 0; s < N; ++s) h[s] = seed[s];
  int j = 0;
  if (lanes & 1) {
    const unsigned long long w = static_cast<uint32_t>(row[0]);
#pragma unroll
    for (int s = 0; s < N; ++s) h[s] = fmix64(h[s] ^ w);
    j = 1;
  }
  for (; j < lanes; j += 2) {
    const unsigned long long w =
        (static_cast<unsigned long long>(static_cast<uint32_t>(row[j]))
         << 32) |
        static_cast<uint32_t>(row[j + 1]);
#pragma unroll
    for (int s = 0; s < N; ++s) h[s] = fmix64(h[s] ^ w);
  }
}

}  // namespace p3
