// What a slice pass of streaming passes 1-2 reads of its slice, on Hopper:
// slice_kmers.
//
// Replaces no TPU kernel: the JAX package runs this chain as XLA fusions
// (platanus3_tpu/ops/partitioned.py).  In the port the same chain was plain
// PyTorch, about 150 elementwise kernels over [C, P] and [C, P, L] int64
// tensors a slice pass (ops/slice_kmers.py: short_slice_plain,
// solid_slice_plain); this kernel computes its outputs, bit for bit, from
// the packed chunks in one launch a pass.  For every chunk-local position p
// of a chunk, with kk the pass's k-mer length (short_k in pass 1, k in
// pass 2):
//
//   fw     the forward k-mer of bases p..p+kk-1 (kmer.extract_kmers), as
//          its 2kk-bit value: lane0 << 32 | lane1, so kk <= 32;
//   canon  min(fw, revcomp(fw)), the forward form winning ties
//          (kmer.canonical); an unsigned compare of the values is the
//          lanes' lexicographic compare;
//   valid  p + kk <= valid_len;
//   owned  (pass 1) p < stride, or the read's last chunk for short_k < k,
//          and start + p + kk <= read_len, and valid (solid.owned_mask);
//   solid  (pass 2) valid, start + p + k <= read_len, and the min of the
//          k - short_k + 1 per-position short counts from p on
//          (windowmin.window_min) at least cov_threshold;
//   part   hashing.hash_kmers(canon, kk, PART_SEED) & (parts - 1) where the
//          row goes to a partition (valid in pass 1, solid in pass 2), else
//          parts: the row is dropped.
//
// Modes, one template body:
//   histogram (both pre-passes): no row is written; each CTA counts its
//       rows per partition in shared memory and adds them once into `hist`
//       ([parts] uint64).
//   collect-short: okey (canon ^ 1 << 63, count.order_keys), part (int64)
//       and the payload (int32 bit pattern of posid | owned << 31, posid =
//       posbase + chunk * P + p) of every position.
//   collect-solid: okey and part of every position, and per chunk the first
//       solid position's global position start + p (2^30 where there is
//       none, as NO_SEED) and its forward lanes (0 where there is none): the
//       seed reduction's input.
//
// Design.  One CTA a chunk, on the chunk body of chunk.cuh: the chunk's
// packed words (int64 holding uint32 values) are staged in shared memory
// once, with two zero words after them (kmer.extract_kmers pads the bases
// with zeros); each thread then takes positions p, p + 256, ...: the forward
// value is a 96-bit window of three shared words, the reverse complement a
// __brevll of its complement with the two bits of every base swapped back
// and realigned, and the hash hash.cuh's.  Neighbouring threads take
// neighbouring positions, so the counts reads of the window-min and the row
// writes are coalesced.
//
// Bound.  Bytes: the packed words read once (8 bytes a 16 positions), the
// counts read once in pass 2 (4 bytes a position) and the rows written once
// (collect-short 20 bytes a position, collect-solid 16): at the chromosome
// slice (4096 chunks of 4096 bases) 8.4 MB in and up to 336 MB out, about
// 0.1 ms at 3.35 TB/s.  The histograms write nothing but [parts].
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// (platanus3_tpu_torch/kernels.py), bound with ctypes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "chunk.cuh"
#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kNoSeed = 1LL << 30;
constexpr unsigned long long kSign = 1ULL << 63;
constexpr size_t kDefaultSmem = 48 * 1024;

enum Mode { kShortHistogram = 0, kSolidHistogram = 1, kShortCollect = 2,
            kSolidCollect = 3 };

struct Slice {
  const int64_t* packed;  // [chunks, words], uint32 values
  const int64_t* vlen;    // [chunks] valid bases
  const int64_t* start;   // [chunks] first base's offset in its read
  const int64_t* rlen;    // [chunks] read length
  const int32_t* counts;  // pass 2: the per-position short counts
  long long chunks;
  int words;              // chunk_len / 16
  int k;
  int short_k;
  int parts;              // a power of two
  int cov_threshold;
  long long posbase;      // global position id of the slice's first position
  uint32_t init;          // hashing.hash_init(kk, PART_SEED)
  unsigned long long* hist;  // histogram: [parts]
  int64_t* okey;          // collect: [chunks * P]
  int64_t* part;          // collect: [chunks * P]
  int32_t* pay;           // collect-short: [chunks * P]
  int64_t* chunk_min;     // collect-solid: [chunks]
  int64_t* chunk_fw;      // collect-solid: [chunks, lanes]
};

template <Mode kMode>
__global__ void __launch_bounds__(kThreads) slice_kmers_kernel(Slice a) {
  constexpr bool kSolid = kMode == kSolidHistogram || kMode == kSolidCollect;
  constexpr bool kCollect = kMode == kShortCollect || kMode == kSolidCollect;
  extern __shared__ uint32_t smem[];
  uint32_t* w = smem;                                     // words + 2
  int* scratch =
      reinterpret_cast<int*>(smem + p3::chunk_smem_words(a.words));
  const long long c = blockIdx.x;
  const int chunk_len = a.words * 16;
  const int kk = kSolid ? a.k : a.short_k;
  const int np = chunk_len - kk + 1;          // positions a chunk
  const int stride = chunk_len - a.k + 1;     // owned positions a chunk
  p3::stage_chunk(w, a.packed, c, a.words);
  if (!kCollect) {
    for (int i = threadIdx.x; i < kWarps * a.parts; i += kThreads) {
      scratch[i] = 0;
    }
  }
  __syncthreads();

  const long long vlen = a.vlen[c];
  const long long start = a.start[c];
  const long long rlen = a.rlen[c];
  // Pass 1 with short_k < k: a read's last chunk also owns its tail.
  const bool last = !kSolid && kk < a.k && start + stride > rlen - a.k;
  const int lanes = (kk + 15) >> 4;
  const int window = a.k - a.short_k + 1;
  const int32_t* cnt =
      kSolid ? a.counts + a.posbase +
                   c * static_cast<long long>(chunk_len - a.short_k + 1)
             : nullptr;
  int* warp_hist = scratch + (threadIdx.x >> 5) * a.parts;
  int first = INT_MAX;  // collect-solid: this thread's first solid position

  for (int p = threadIdx.x; p < np; p += kThreads) {
    const unsigned long long fw = p3::forward(w, p, kk);
    const unsigned long long rc = p3::revcomp(fw, kk);
    const unsigned long long canon = rc < fw ? rc : fw;
    const bool valid = p + kk <= vlen;
    const bool in_read = start + p + kk <= rlen;
    bool keep = valid;
    if (kSolid && keep) {
      keep = in_read;
      if (keep) {
        int m = cnt[p];
        for (int j = 1; j < window; ++j) m = min(m, cnt[p + j]);
        keep = m >= a.cov_threshold;
      }
    }
    const int pt =
        keep ? static_cast<int>(p3::hash_packed(canon, lanes, a.init) &
                                static_cast<uint32_t>(a.parts - 1))
             : a.parts;
    if (!kCollect) {
      if (keep) atomicAdd(&warp_hist[pt], 1);
      continue;
    }
    const long long row = c * np + p;
    a.okey[row] = static_cast<int64_t>(canon ^ kSign);
    a.part[row] = pt;
    if (!kSolid) {
      const bool owned = valid && in_read && (p < stride || last);
      a.pay[row] = static_cast<int32_t>(
          static_cast<uint32_t>(a.posbase + row) | (owned ? 0x80000000u : 0u));
    } else if (keep && first == INT_MAX) {
      first = p;
    }
  }

  if (!kCollect) {
    __syncthreads();
    for (int q = threadIdx.x; q < a.parts; q += kThreads) {
      int sum = 0;
      for (int v = 0; v < kWarps; ++v) sum += scratch[v * a.parts + q];
      if (sum) atomicAdd(&a.hist[q], static_cast<unsigned long long>(sum));
    }
  } else if (kSolid) {
    const unsigned m = __reduce_min_sync(0xFFFFFFFFu,
                                         static_cast<unsigned>(first));
    if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = static_cast<int>(m);
    __syncthreads();
    if (threadIdx.x == 0) {
      int p = INT_MAX;
      for (int v = 0; v < kWarps; ++v) p = min(p, scratch[v]);
      const bool seed = p != INT_MAX && start + p < kNoSeed;
      a.chunk_min[c] = seed ? start + p : kNoSeed;
      const unsigned long long fw = seed ? p3::forward(w, p, kk) : 0ULL;
      int64_t* out = a.chunk_fw + c * lanes;
      if (lanes == 2) {
        out[0] = static_cast<int64_t>(fw >> 32);
        out[1] = static_cast<int64_t>(fw & 0xFFFFFFFFULL);
      } else {
        out[0] = static_cast<int64_t>(fw);
      }
    }
  }
}

template <Mode kMode>
int launch(const Slice& a, cudaStream_t stream) {
  const auto kernel = slice_kmers_kernel<kMode>;
  const int scratch = kMode == kShortCollect ? 0
                      : kMode == kSolidCollect ? kWarps
                                               : kWarps * a.parts;
  const size_t smem =
      (p3::chunk_smem_words(a.words) + scratch) * sizeof(uint32_t);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(a.chunks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One slice pass: `mode` 0 short histogram, 1 solid histogram, 2
// collect-short, 3 collect-solid.  Launched on `stream`; returns
// cudaGetLastError() of the launch.  Inputs are int64 [chunks] (and
// `packed` [chunks, words]); `counts` int32, read from `posbase` on (pass 2
// only).  Outputs the mode does not write may be null; `hist` must be
// zeroed by the caller (it is added to).
extern "C" int slice_kmers(int mode, const void* packed, const void* vlen,
                           const void* start, const void* rlen,
                           const void* counts, long long chunks, int words,
                           int k, int short_k, int parts, int cov_threshold,
                           long long posbase, unsigned int init, void* hist,
                           void* okey, void* part, void* pay, void* chunk_min,
                           void* chunk_fw, void* stream) {
  const Slice a{static_cast<const int64_t*>(packed),
                static_cast<const int64_t*>(vlen),
                static_cast<const int64_t*>(start),
                static_cast<const int64_t*>(rlen),
                static_cast<const int32_t*>(counts),
                chunks,
                words,
                k,
                short_k,
                parts,
                cov_threshold,
                posbase,
                init,
                static_cast<unsigned long long*>(hist),
                static_cast<int64_t*>(okey),
                static_cast<int64_t*>(part),
                static_cast<int32_t*>(pay),
                static_cast<int64_t*>(chunk_min),
                static_cast<int64_t*>(chunk_fw)};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kShortHistogram: return launch<kShortHistogram>(a, s);
    case kSolidHistogram: return launch<kSolidHistogram>(a, s);
    case kShortCollect: return launch<kShortCollect>(a, s);
    case kSolidCollect: return launch<kSolidCollect>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
