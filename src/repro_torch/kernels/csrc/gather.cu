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
// blocks) exists for the TPU's sequential grid and VMEM; here one warp owns
// one output row and grid-strides over rows, so each row is one contiguous
// read and one contiguous write by 32 neighbouring lanes.  The row is copied
// in the widest word (16, 4 or 2 bytes) that its byte width and both base
// pointers allow: the kernel is a byte copy, so one body serves f32 and bf16.
// Slots at or past C are clamped to C - 1, the out-of-range rule of the
// JAX gather this kernel stands in for.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one row each per grid-stride step
constexpr int kMaxBlocks = 4096;

template <typename Word>
__global__ void cache_gather_kernel(const int32_t* __restrict__ slots,
                                    const Word* __restrict__ cache,
                                    Word* __restrict__ out,
                                    int32_t* __restrict__ miss,
                                    int64_t n, int64_t capacity,
                                    int64_t row_words) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t r = warp; r < n; r += warps) {
    const int32_t slot = slots[r];
    Word* dst = out + r * row_words;
    if (slot >= 0) {
      const int64_t s = slot < capacity ? slot : capacity - 1;
      const Word* src = cache + s * row_words;
      for (int64_t i = lane; i < row_words; i += 32) dst[i] = src[i];
    } else {
      const Word zero{};
      for (int64_t i = lane; i < row_words; i += 32) dst[i] = zero;
    }
    if (lane == 0) miss[r] = slot < 0 ? 1 : 0;
  }
}

template <typename Word>
void launch(const void* slots, const void* cache, void* out, void* miss,
            int64_t n, int64_t capacity, int64_t row_bytes, cudaStream_t stream) {
  const int64_t rows_per_block = kThreads / 32;
  int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cache_gather_kernel<Word><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(slots), static_cast<const Word*>(cache),
      static_cast<Word*>(out), static_cast<int32_t*>(miss), n, capacity,
      row_bytes / static_cast<int64_t>(sizeof(Word)));
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  The caller
// has checked the shapes, types and devices; n >= 1, capacity >= 1, and
// row_bytes is a multiple of 2.
extern "C" int cache_gather_launch(const void* slots, const void* cache, void* out,
                                   void* miss, long long n, long long capacity,
                                   long long row_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(cache) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && bases % 16 == 0) {
    launch<uint4>(slots, cache, out, miss, n, capacity, row_bytes, s);
  } else if (row_bytes % 4 == 0 && bases % 4 == 0) {
    launch<uint32_t>(slots, cache, out, miss, n, capacity, row_bytes, s);
  } else {
    launch<uint16_t>(slots, cache, out, miss, n, capacity, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}
