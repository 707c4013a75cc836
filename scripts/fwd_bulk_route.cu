// The bulk-copy route of the two GNN forwards, kept only to be timed
// against the port's kernels by scripts/fwd_bulk_route.py; no path of the
// port runs it.
//
//   neighbor_agg forward (csrc/segment_agg.cu) and gather_aggregate
//   (csrc/fused_gather_agg.cu): the same functions, sums and clamps.
//
// A block owns a tile of threads / words consecutive dst rows (16-byte
// words; rows and pointers 16-byte aligned) and stages its indices (and,
// for gather_aggregate, the enc lookups) in shared memory.  Then every
// valid entry's row, and each self row, is copied into a shared-memory
// stage by TMA's 1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx),
// one copy an entry, all counted in bytes by one mbarrier; once it
// completes, each thread adds its word of the row's entries in ascending f
// (f32, from +0; the weighted add is one fma) and writes the outputs with
// streaming stores.  The whole fanout is staged, so a tile's rows must fit
// kBulkBytes of shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStage = 2048;            // index entries a tile stages
constexpr int kBulkBytes = 96 * 1024;   // the row stage

struct alignas(16) Word {
  float v[4];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_row(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void store_stream(Word* p, const Word& v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v.v[0], v.v[1], v.v[2], v.v[3]));
}

// mode 0 mean, 1 sum, 2 weighted
__global__ void __launch_bounds__(256)
agg_fwd_bulk_kernel(const int32_t* __restrict__ idx, const float* __restrict__ h,
                    const float* __restrict__ w, float* __restrict__ out, int64_t nd, int fan,
                    int64_t ns, int64_t words, int rows, int mode) {
  extern __shared__ __align__(128) unsigned char s_dyn[];
  Word* s_rows = reinterpret_cast<Word*>(s_dyn);
  __shared__ int32_t s_src[kStage];
  __shared__ float s_w[kStage];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_valid;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(nd - r0 < rows ? nd - r0 : rows);
  const int rr = threadIdx.x / static_cast<int>(words);
  const int64_t col = threadIdx.x % words;
  const bool weighted = mode == 2;
  const uint32_t bar = smem_u32(&s_bar);
  const uint32_t row_bytes = static_cast<uint32_t>(words * sizeof(Word));
  if (threadIdx.x == 0) {
    s_valid = 0;
    bar_init(bar);
  }
  for (int e = threadIdx.x; e < nrows * fan; e += blockDim.x) {
    const int32_t s = idx[r0 * fan + e];
    s_src[e] = s < 0 ? -1 : (s < ns ? s : static_cast<int32_t>(ns - 1));
    s_w[e] = weighted && s >= 0 ? w[r0 * fan + e] : 0.f;
  }
  __syncthreads();
  int n = 0;
  for (int e = threadIdx.x; e < nrows * fan; e += blockDim.x) {
    const int32_t s = s_src[e];
    if (s >= 0) {
      bulk_row(smem_u32(s_rows + e * words), h + s * words * 4, row_bytes, bar);
      ++n;
    }
  }
  if (n) atomicAdd(&s_valid, n);
  __syncthreads();
  if (threadIdx.x == 0) bar_expect(bar, static_cast<uint32_t>(s_valid) * row_bytes);
  bar_wait(bar);
  if (rr >= nrows) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int cnt = 0;
  for (int f = 0; f < fan; ++f) {
    const int e = rr * fan + f;
    if (s_src[e] < 0) continue;
    ++cnt;
    const Word x = s_rows[e * words + col];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = weighted ? __fmaf_rn(s_w[e], x.v[j], acc[j]) : acc[j] + x.v[j];
  }
  const float denom = static_cast<float>(max(cnt, 1));
  Word o;
#pragma unroll
  for (int j = 0; j < 4; ++j) o.v[j] = mode == 0 ? acc[j] / denom : acc[j];
  store_stream(reinterpret_cast<Word*>(out) + (r0 + rr) * words + col, o);
}

struct Rows {                          // the two places a row can live
  const Word* table;
  const Word* aux;
  int64_t capacity, aux_rows, words;

  __device__ __forceinline__ const Word* row(int32_t e) const {
    if (e >= 0) return table + (e < capacity ? e : capacity - 1) * words;
    const int64_t a = -static_cast<int64_t>(e) - 1;
    return aux + (a < aux_rows ? a : aux_rows - 1) * words;
  }
};

// mode 0 mean, 1 sum; the self rows follow the neighbour rows in the stage
__global__ void __launch_bounds__(256)
gather_aggregate_bulk_kernel(const int32_t* __restrict__ enc, const int32_t* __restrict__ idx,
                             Rows rows_of, Word* __restrict__ h_dst, Word* __restrict__ agg,
                             int64_t ns, int64_t nd, int fan, int rows, int mean) {
  extern __shared__ __align__(128) unsigned char s_dyn[];
  Word* s_rows = reinterpret_cast<Word*>(s_dyn);
  __shared__ const Word* s_nb[kStage];
  __shared__ const Word* s_self[256];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_valid;
  const int64_t words = rows_of.words;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(nd - r0 < rows ? nd - r0 : rows);
  const int rr = threadIdx.x / static_cast<int>(words);
  const int64_t col = threadIdx.x % words;
  const uint32_t bar = smem_u32(&s_bar);
  const uint32_t row_bytes = static_cast<uint32_t>(words * sizeof(Word));
  if (threadIdx.x == 0) {
    s_valid = 0;
    bar_init(bar);
  }
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) s_self[r] = rows_of.row(enc[r0 + r]);
  for (int e = threadIdx.x; e < nrows * fan; e += blockDim.x) {
    const int32_t s = idx[r0 * fan + e];
    s_nb[e] = s < 0 ? nullptr : rows_of.row(enc[s < ns ? s : ns - 1]);
  }
  __syncthreads();
  int n = 0;
  for (int e = threadIdx.x; e < nrows * (fan + 1); e += blockDim.x) {
    const Word* src = e < nrows * fan ? s_nb[e] : s_self[e - nrows * fan];
    if (src != nullptr) {
      bulk_row(smem_u32(s_rows + e * words), src, row_bytes, bar);
      ++n;
    }
  }
  if (n) atomicAdd(&s_valid, n);
  __syncthreads();
  if (threadIdx.x == 0) bar_expect(bar, static_cast<uint32_t>(s_valid) * row_bytes);
  bar_wait(bar);
  if (rr >= nrows) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int cnt = 0;
  for (int f = 0; f < fan; ++f) {
    const int e = rr * fan + f;
    if (s_nb[e] == nullptr) continue;
    ++cnt;
    const Word x = s_rows[e * words + col];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += x.v[j];
  }
  store_stream(h_dst + (r0 + rr) * words + col, s_rows[(nrows * fan + rr) * words + col]);
  const float denom = static_cast<float>(max(cnt, 1));
  Word o;
#pragma unroll
  for (int j = 0; j < 4; ++j) o.v[j] = mean ? acc[j] / denom : acc[j];
  store_stream(agg + (r0 + rr) * words + col, o);
}

// the tile's rows for `threads` threads, 0 where the route does not take
// the shape: unaligned words, a row wider than the block, a stage too small
int tile_rows(int64_t f, int fan, int entries_per_row, int threads, uintptr_t bases) {
  if (f % 4 != 0 || bases % 16 != 0 || fan < 1) return 0;
  const int64_t words = f / 4;
  if (words > threads) return 0;
  const int64_t rows = threads / words;
  if (rows * fan > kStage || rows * entries_per_row * words * 16 > kBulkBytes) return 0;
  return static_cast<int>(rows);
}

}  // namespace

// Each returns cudaGetLastError() after the launch, or -1 where the route
// does not take the shape.
extern "C" int neighbor_agg_fwd_bulk_launch(const void* idx, const void* h, const void* w,
                                            void* out, long long nd, int fan, long long ns,
                                            long long d, int mode, int threads, void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  const int rows = tile_rows(d, fan, fan, threads, bases);
  if (rows == 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(agg_fwd_bulk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBulkBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(rows) * fan * (d / 4) * 16;
  agg_fwd_bulk_kernel<<<static_cast<unsigned>((nd + rows - 1) / rows), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<float*>(out), nd, fan, ns, d / 4, rows, mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_aggregate_bulk_launch(const void* enc, const void* idx, const void* table,
                                            const void* aux, void* h_dst, void* agg,
                                            long long ns, long long nd, int fan,
                                            long long capacity, long long aux_rows,
                                            long long f, int mode, int threads, void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(aux) |
                          reinterpret_cast<uintptr_t>(h_dst) | reinterpret_cast<uintptr_t>(agg);
  const int rows = tile_rows(f, fan, fan + 1, threads, bases);
  if (rows == 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(gather_aggregate_bulk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBulkBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(rows) * (fan + 1) * (f / 4) * 16;
  const Rows rows_of{static_cast<const Word*>(table), static_cast<const Word*>(aux), capacity,
                     aux_rows, f / 4};
  gather_aggregate_bulk_kernel<<<static_cast<unsigned>((nd + rows - 1) / rows), threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(enc), static_cast<const int32_t*>(idx), rows_of,
      static_cast<Word*>(h_dst), static_cast<Word*>(agg), ns, nd, fan, rows, mode == 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
