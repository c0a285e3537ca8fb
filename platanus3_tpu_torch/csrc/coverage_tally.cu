// Stage 3's node coverage and junction tallies on Hopper: coverage_tally.
//
// Replaces no TPU kernel: the JAX package computes graph/coverage.py's
// count_coverage as XLA fusions and scatter-adds.  In the port the same was
// plain PyTorch (graph/coverage.count_coverage): about 110 elementwise
// kernels over [C, P] and [C, P, L] int64 tensors a call, a binary search of
// every position over all node keys, and two boolean-mask index_add_s.  This
// kernel adds the same counts, from the packed chunks, in one launch, into
// the running tallies its caller passes in.  For every chunk-local position
// p of a chunk (P = chunk_len - k + 1 of them, k <= 32):
//
//   fw, rc  the forward k-mer of bases p..p+k-1 and its reverse complement,
//           as 2k-bit values; canon = min(fw, rc), the forward form winning
//           ties (is_fw = fw <= rc, kmer.canonical);
//   owned   p + k <= valid_len and start + p + k <= read_len;
//   id      stage 1's node id of the position where `nid` is given, else
//           the row of canon among the node keys, -1 where it is none
//           (count.lookup_id's ids);
//   node_cov[id] += 2 for a palindrome (fw == rc), else 1, where owned and
//           id >= 0;
//   at a junction (is_junction_final[id]), jun_tally[id * 8 + col] += 1:
//     left   col = b (is_fw) or 7 - b (reverse), b the base before p: base
//            p - 1, or the chunk's prev_base at p = 0 (none where >= 4);
//     right  col = 4 + b (is_fw) or 3 - b, b the base after the k-mer: base
//            p + k, or the chunk's next_base at p = P - 1 (none where >= 4);
//            none where start + p + k >= read_len.
//
// Design.  One CTA a chunk, on the chunk body of chunk.cuh (as slice_kmers):
// the chunk's packed words staged in shared memory once, each thread taking
// positions p, p + 256, ...; no [C, P, L] tensor and no unpacked base exist.
// The node lookup goes through a bucket directory over the sorted keys
// (ops/coverage_tally.node_index, built once a coverage pass): offsets[b]
// is the first key whose top `bits` bits (of 2k) are at least b, so a key
// lies in keys[offsets[b], offsets[b + 1]) with b = canon >> shift, about
// four keys a bucket; a lower bound inside that range is the lower bound
// over all keys.  One directory read and a short search, mostly in one or
// two 32-byte sectors, where a search of all keys takes log2(M) dependent
// random reads.  The adds are int64 atomics (reductions, their old value
// unread) straight into the running tallies.  Nothing is copied to the host
// and nothing waits for the device.
//
// Bound.  Bytes, every input read once and every tally word touched read
// and written once: the packed words and the six chunk arrays, stage 1's
// ids (8 bytes a position) where given, else the keys (8 bytes a node) and
// the directory (4 bytes a bucket); is_junction_final (1 byte a node); the
// node_cov word of every node hit and the 64-byte tally row of every
// junction hit.  The work is random access: each position's lookup and add
// touch a few 32-byte sectors at random.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// (platanus3_tpu_torch/kernels.py), bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "chunk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

struct Tally {
  const int64_t* packed;     // [chunks, words], uint32 values
  const int64_t* vlen;       // [chunks] valid bases
  const int64_t* start;      // [chunks] first base's offset in its read
  const int64_t* rlen;       // [chunks] read length
  const int64_t* prev_base;  // [chunks] base before the chunk, 4 for none
  const int64_t* next_base;  // [chunks] base after the chunk, 4 for none
  const int64_t* nid;        // [chunks, P] stage 1's ids, or null
  const unsigned long long* keys;  // node keys (2k-bit), sorted ascending
  const int32_t* offsets;    // [2^bits + 1] the bucket directory
  const uint8_t* is_jun;     // [M] is_junction_final
  unsigned long long* node_cov;   // [M], added to
  unsigned long long* jun_tally;  // [M * 8], added to
  long long chunks;
  int words;                 // chunk_len / 16
  int k;
  int shift;                 // 2k - bits
};

// Row of `canon` among the keys, or -1 where it is no node.
__device__ __forceinline__ long long find_node(const Tally& a,
                                               unsigned long long canon) {
  const unsigned long long b = canon >> a.shift;
  int lo = __ldg(a.offsets + b);
  int hi = __ldg(a.offsets + b + 1);
  const int end = hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a.keys + mid) < canon) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < end && __ldg(a.keys + lo) == canon ? lo : -1;
}

__global__ void __launch_bounds__(kThreads) coverage_tally_kernel(Tally a) {
  extern __shared__ uint32_t w[];
  const long long c = blockIdx.x;
  p3::stage_chunk(w, a.packed, c, a.words);
  __syncthreads();

  const int k = a.k;
  const int np = a.words * 16 - k + 1;  // positions a chunk
  const long long vlen = a.vlen[c];
  const long long start = a.start[c];
  const long long rlen = a.rlen[c];
  const long long prev = a.prev_base[c];
  const long long next = a.next_base[c];
  for (int p = threadIdx.x; p < np; p += kThreads) {
    if (p + k > vlen || start + p + k > rlen) continue;  // not owned
    const unsigned long long fw = p3::forward(w, p, k);
    const unsigned long long rc = p3::revcomp(fw, k);
    const bool is_fw = fw <= rc;
    const long long id =
        a.nid != nullptr ? a.nid[c * np + p] : find_node(a, is_fw ? fw : rc);
    if (id < 0) continue;
    atomicAdd(a.node_cov + id, fw == rc ? 2ULL : 1ULL);
    if (!__ldg(a.is_jun + id)) continue;
    unsigned long long* row = a.jun_tally + id * 8;
    const long long before = p == 0 ? prev : p3::base_at(w, p - 1);
    if (before < 4) atomicAdd(row + (is_fw ? before : 7 - before), 1ULL);
    if (start + p + k < rlen) {
      const long long after = p == np - 1 ? next : p3::base_at(w, p + k);
      if (after < 4) atomicAdd(row + (is_fw ? 4 + after : 3 - after), 1ULL);
    }
  }
}

}  // namespace

// One coverage tally over `chunks` chunks, launched on `stream`; returns
// cudaGetLastError() of the launch.  Chunk arrays are int64 [chunks] (and
// `packed` [chunks, words]); `nid` int64 [chunks, P] or null, in which case
// `keys` (uint64, sorted) and `offsets` (int32 [2^bits + 1], shift = 2k -
// bits) find the nodes; `is_jun` one byte a node.  `node_cov` ([M]) and
// `jun_tally` ([M * 8]) are int64 and are added to.
extern "C" int coverage_tally(const void* packed, const void* vlen,
                              const void* start, const void* rlen,
                              const void* prev_base, const void* next_base,
                              const void* nid, const void* keys,
                              const void* offsets, int shift,
                              const void* is_jun, void* node_cov,
                              void* jun_tally, long long chunks, int words,
                              int k, void* stream) {
  const Tally a{static_cast<const int64_t*>(packed),
                static_cast<const int64_t*>(vlen),
                static_cast<const int64_t*>(start),
                static_cast<const int64_t*>(rlen),
                static_cast<const int64_t*>(prev_base),
                static_cast<const int64_t*>(next_base),
                static_cast<const int64_t*>(nid),
                static_cast<const unsigned long long*>(keys),
                static_cast<const int32_t*>(offsets),
                static_cast<const uint8_t*>(is_jun),
                static_cast<unsigned long long*>(node_cov),
                static_cast<unsigned long long*>(jun_tally),
                chunks,
                words,
                k,
                shift};
  if (chunks == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = p3::chunk_smem_words(words) * sizeof(uint32_t);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        coverage_tally_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  coverage_tally_kernel<<<static_cast<unsigned int>(chunks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
