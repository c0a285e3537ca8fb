// The chunk body shared by the port's CTA-a-chunk kernels (slice_kmers.cu,
// coverage_tally.cu): a chunk's packed words staged in shared memory, and
// what a thread reads of them at one chunk-local position.
//
// A chunk is `words` packed words (int64 holding uint32 values, 16 bases a
// word, first base most significant: kmer.pack_bases_np).  Staged, they are
// followed by two zero words, as kmer.extract_kmers pads the bases with
// zeros, so a k-mer that starts at any position of the chunk (k <= 32) lies
// in three staged words.

#pragma once

#include <cstddef>
#include <cstdint>

namespace p3 {

constexpr unsigned long long kPairLow = 0x5555555555555555ULL;

// Shared memory a CTA stages its chunk in: the words and the two zeros.
__host__ __device__ constexpr size_t chunk_smem_words(int words) {
  return static_cast<size_t>(words) + 2;
}

// Stage chunk c's words in `w` (chunk_smem_words(words) entries), all the
// CTA's threads taking part.  The caller synchronises before reading them.
__device__ __forceinline__ void stage_chunk(uint32_t* w, const int64_t* packed,
                                            long long c, int words) {
  for (int i = threadIdx.x; i < words + 2; i += blockDim.x) {
    w[i] = i < words ? static_cast<uint32_t>(packed[c * words + i]) : 0u;
  }
}

// The 2kk-bit forward k-mer at chunk position p: bases p..p+kk-1 of the
// staged words, first base most significant.  p % 16 + kk <= 47 bases lie
// in words p / 16 .. p / 16 + 2.
__device__ __forceinline__ unsigned long long forward(const uint32_t* w, int p,
                                                      int kk) {
  const int i = p >> 4;
  const int off = 2 * (p & 15);
  unsigned long long x =
      ((static_cast<unsigned long long>(w[i]) << 32) | w[i + 1]) << off;
  if (off) x |= static_cast<unsigned long long>(w[i + 2]) >> (32 - off);
  return x >> (64 - 2 * kk);
}

// Reverse complement of a 2kk-bit k-mer: complement, reverse the 64 bits,
// swap the two bits of every base back, then realign low.
__device__ __forceinline__ unsigned long long revcomp(unsigned long long x,
                                                      int kk) {
  const unsigned long long r = __brevll(~x);
  return (((r >> 1) & kPairLow) | ((r & kPairLow) << 1)) >> (64 - 2 * kk);
}

// The 2-bit code of the base at chunk position q.
__device__ __forceinline__ int base_at(const uint32_t* w, int q) {
  return static_cast<int>((w[q >> 4] >> (30 - 2 * (q & 15))) & 3u);
}

}  // namespace p3
