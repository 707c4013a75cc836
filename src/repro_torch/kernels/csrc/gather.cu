// cache_gather: copy feature-cache rows by slot, zero rows for misses.
//
// Replaces the TPU kernel src/repro/kernels/gather/kernel.py:cache_gather_pallas.
//
//   slots (n,) int32, -1 = miss;  cache (C, F) of any 2- or 4-byte dtype
//   out[r]  = cache[slots[r]] if slots[r] >= 0 else 0
//   miss[r] = slots[r] < 0
//
// Bound: bytes.  The kernel moves (hits + n) * F * itemsize + 8n bytes and
// does no arithmetic, so it can only approach the card's HBM rate.  The
// Pallas design (8 scalar-prefetched ids per grid step, 512-wide feature
// blocks) exists for the TPU's sequential grid and VMEM.  At the serving
// path's 4,096- and 128-row chunks the time is latency, not bytes: a slot
// read, then a row read, then the stores.  A run of 32 rows is read as one
// block of words: each warp reads the run's 32 slots with one coalesced
// load (one lane each) and passes them by shuffle, then issues all D of its
// loads (word q of the run is row q / words, word q % words; neighbouring
// lanes take neighbouring words, so narrow rows pack several to a warp
// instruction) before it stores any.  A run is split over ceil(words / D)
// warps.  Words are the widest (16, 4 or 2 bytes) that the row's byte
// width and both base pointers allow: the kernel is a byte copy, so one
// body serves f32 and bf16.  On an H100 this layout, the warp-per-row
// kernel it replaced and a thread-per-word one took the same time at a
// 4,096-row chunk (two dependent round trips and the launch: the chunk is
// latency, whatever the layout); at a whole training batch this one is
// faster than warp-per-row.  Slots at or past C are clamped to C - 1, the
// out-of-range rule of the JAX gather this kernel stands in for.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // 4 warps a block
constexpr int kRun = 32;             // rows per run: one slot a lane
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr unsigned kFull = 0xffffffffu;

template <typename Word, int D>
__global__ void __launch_bounds__(kThreads)
cache_gather_kernel(const int32_t* __restrict__ slots, const Word* __restrict__ cache,
                    Word* __restrict__ out, int32_t* __restrict__ miss, int64_t n,
                    int64_t capacity, int words, int parts) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t items = (n + kRun - 1) / kRun * parts;
  for (int64_t item = warp; item < items; item += warps) {
    const int64_t run = item / parts;
    const int part = static_cast<int>(item - run * parts);
    const int64_t r0 = run * kRun;
    const int rows = n - r0 < kRun ? static_cast<int>(n - r0) : kRun;
    const int32_t slot = lane < rows ? slots[r0 + lane] : -1;
    if (part == 0 && lane < rows) miss[r0 + lane] = slot < 0 ? 1 : 0;
    const int64_t src = slot < 0 ? -1 : (slot < capacity ? slot : capacity - 1);
    const unsigned flat = static_cast<unsigned>(rows) * static_cast<unsigned>(words);
    const unsigned q0 = static_cast<unsigned>(part) * 32u * D + lane;
    Word buf[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {                 // every load before any store
      const unsigned q = q0 + 32u * i;
      const unsigned row = q < flat ? q / static_cast<unsigned>(words) : 0u;
      const int64_t s = __shfl_sync(kFull, src, static_cast<int>(row));
      buf[i] = Word{};
      if (q < flat && s >= 0) buf[i] = cache[s * words + (q - row * words)];
    }
    Word* dst = out + r0 * words;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const unsigned q = q0 + 32u * i;
      if (q < flat) dst[q] = buf[i];
    }
  }
}

template <typename Word, int D>
void launch(const void* slots, const void* cache, void* out, void* miss, int64_t n,
            int64_t capacity, int words, cudaStream_t stream) {
  const int parts = (words + D - 1) / D;
  const int64_t warps = (n + kRun - 1) / kRun * parts;
  int64_t blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cache_gather_kernel<Word, D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(slots), static_cast<const Word*>(cache),
      static_cast<Word*>(out), static_cast<int32_t*>(miss), n, capacity, words, parts);
}

// D = 1 word a lane spreads a serving chunk (4,096 rows at F = 100 f32:
// 3,200 warps) over every SM; larger calls take D = 4, a quarter of the slot
// reads repeated across a run's warps (on an H100, D = 4 was the slower of
// the two at 4,096 rows and the faster at 75,489)
template <typename Word>
void launch_depth(const void* slots, const void* cache, void* out, void* miss, int64_t n,
                  int64_t capacity, int64_t row_bytes, cudaStream_t stream) {
  const int words = static_cast<int>(row_bytes / static_cast<int64_t>(sizeof(Word)));
  if (n > 16384) {
    launch<Word, 4>(slots, cache, out, miss, n, capacity, words, stream);
  } else {
    launch<Word, 1>(slots, cache, out, miss, n, capacity, words, stream);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  The caller
// has checked the shapes, types and devices; n >= 1, capacity >= 1, and
// row_bytes is a multiple of 2 below 2^26 (a run's words fit 32 bits).
extern "C" int cache_gather_launch(const void* slots, const void* cache, void* out,
                                   void* miss, long long n, long long capacity,
                                   long long row_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(cache) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes >= (1ll << 26)) return static_cast<int>(cudaErrorInvalidValue);
  if (row_bytes % 16 == 0 && bases % 16 == 0) {
    launch_depth<uint4>(slots, cache, out, miss, n, capacity, row_bytes, s);
  } else if (row_bytes % 4 == 0 && bases % 4 == 0) {
    launch_depth<uint32_t>(slots, cache, out, miss, n, capacity, row_bytes, s);
  } else {
    launch_depth<uint16_t>(slots, cache, out, miss, n, capacity, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}
