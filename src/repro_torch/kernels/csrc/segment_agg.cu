// neighbor_agg: masked mean, sum or weighted sum over a padded fanout, and
// its gradient.
//
// Replaces the TPU kernel src/repro/kernels/segment_agg/kernel.py:
// neighbor_agg_pallas (_agg_kernel, _agg_kernel_weighted; neighbor_mean_pallas),
// which is forward-only.  The backward has no TPU counterpart: the JAX step
// differentiates the jnp oracle (segment_agg/ref.py); here it is a kernel.
//
//   idx (Nd, fan) int32, -1 = pad;  h (Ns, D) f32;  w (Nd, fan) f32 or null
//   mode 0 mean:     out[r] = sum_f valid h[idx[r,f]] / max(cnt_r, 1)
//   mode 1 sum:      out[r] = sum_f valid h[idx[r,f]]
//   mode 2 weighted: out[r] = sum_f valid w[r,f] * h[idx[r,f]]
//
// Bound: bytes.  The forward reads each referenced source row, the indices
// (and weights) once and writes Nd * D floats; it does fan * D adds per row,
// far below the card's f32 rate.  The Pallas design (8 scalar-prefetched
// rows per sequential grid step, 256-wide feature blocks in VMEM) does not
// carry over.  Here one warp owns one dst row and grid-strides over rows.
// The warp loads the row's fan indices with one coalesced read (one lane
// each), counts the valid ones with a ballot and walks them in index order,
// so the sum is taken in the order of the reference.  The index read and
// the row read are dependent round trips, so the warp starts the reads of
// kInFlight neighbours before it adds any of them.  Rows are read in the
// widest word (16, 8 or 4 bytes) that D and every base pointer allow:
// D = 47 takes the 4-byte path.  Each lane keeps K words of the row in
// registers, so a column tile is 32 * K words; wider rows take several tiles.
// Indices at or past Ns clamp to Ns - 1, the out-of-range rule of the JAX
// gather.
//
// Backward, for the same three modes:
//   dh[idx[r,f]] += s * dout[r]   for every valid (r, f),
//                                 s = 1/cnt_r (mean), 1 (sum), w[r,f] (weighted)
//   dw[r,f] = valid ? <dout[r], h[idx[r,f]]> : 0          (weighted only)
// which is jax.vjp of segment_agg/ref.py: padded entries get zero gradient.
// dh is zero-filled on the stream, then one warp per dst row adds its scaled
// dout row into each valid neighbour's row with f32 atomicAdd (the compiler
// emits fire-and-forget reductions).  Two dst rows that share a neighbour
// add into one row in an order that changes from run to run, so dh is not
// bit-reproducible: it agrees with the plain version within rel 1e-5, with
// entries near zero held to 1e-5 of the largest.  dw is a warp reduction per
// valid (r, f), with no atomics.  A deterministic design (sort the edges by
// source row, or a transposed CSR) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps, one dst row each per grid-stride step
constexpr int kMaxBlocks = 4096;
constexpr int kInFlight = 4;    // neighbour rows read before any is added
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kMean = 0, kSum = 1, kWeighted = 2 };

template <int V>
struct alignas(4 * V) Pack {
  float v[V];
};

__device__ __forceinline__ int64_t warp_id() {
  return (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ int64_t warp_count() {
  return (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
}

// valid neighbours of one dst row (-1 is padding)
__device__ __forceinline__ int count_valid(const int32_t* __restrict__ ir, int fan,
                                           int lane) {
  int cnt = 0;
  for (int c0 = 0; c0 < fan; c0 += 32) {
    const int f = c0 + lane;
    cnt += __popc(__ballot_sync(kFull, f < fan && ir[f] >= 0));
  }
  return cnt;
}

// V floats per word, K words per lane per column tile
template <int V, int K>
__global__ void agg_fwd_kernel(const int32_t* __restrict__ idx,
                               const float* __restrict__ h,
                               const float* __restrict__ w,
                               float* __restrict__ out,
                               int64_t nd, int fan, int64_t ns, int64_t words,
                               int mode) {
  using P = Pack<V>;
  const P* hv = reinterpret_cast<const P*>(h);
  P* ov = reinterpret_cast<P*>(out);
  const int lane = threadIdx.x & 31;
  for (int64_t r = warp_id(); r < nd; r += warp_count()) {
    const int32_t* ir = idx + r * fan;
    const float* wr = mode == kWeighted ? w + r * fan : nullptr;
    const float denom = static_cast<float>(max(count_valid(ir, fan, lane), 1));
    for (int64_t t0 = 0; t0 < words; t0 += 32 * K) {        // column tile
      float acc[K][V];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
      for (int c0 = 0; c0 < fan; c0 += 32) {                // index chunk
        const int f = c0 + lane;
        const int32_t mine = f < fan ? ir[f] : -1;
        const float mine_w = (wr != nullptr && f < fan) ? wr[f] : 1.f;
        unsigned valid = __ballot_sync(kFull, mine >= 0);
        while (valid) {                                     // warp-uniform
          int64_t src[kInFlight];
          float ws[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            src[u] = -1;
            ws[u] = 0.f;
            if (valid) {
              const int b = __ffs(valid) - 1;
              valid &= valid - 1;
              const int64_t s = __shfl_sync(kFull, mine, b);
              src[u] = s < ns ? s : ns - 1;
              ws[u] = __shfl_sync(kFull, mine_w, b);
            }
          }
          P rows[kInFlight][K];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int64_t p = t0 + k * 32 + lane;
              if (src[u] >= 0 && p < words) {
                rows[u][k] = hv[src[u] * words + p];
              } else {
#pragma unroll
                for (int j = 0; j < V; ++j) rows[u][k].v[j] = 0.f;
              }
            }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
              for (int j = 0; j < V; ++j)
                acc[k][j] += mode == kWeighted ? ws[u] * rows[u][k].v[j]
                                               : rows[u][k].v[j];
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t p = t0 + k * 32 + lane;
        if (p < words) {
          P o;
#pragma unroll
          for (int j = 0; j < V; ++j)
            o.v[j] = mode == kMean ? acc[k][j] / denom : acc[k][j];
          ov[r * words + p] = o;
        }
      }
    }
  }
}

template <int V>
__global__ void agg_bwd_kernel(const int32_t* __restrict__ idx,
                               const float* __restrict__ dout,
                               const float* __restrict__ h,
                               const float* __restrict__ w,
                               float* __restrict__ dh,
                               float* __restrict__ dw,
                               int64_t nd, int fan, int64_t ns, int64_t words,
                               int mode) {
  using P = Pack<V>;
  const P* gv = reinterpret_cast<const P*>(dout);
  const P* hv = reinterpret_cast<const P*>(h);
  const int lane = threadIdx.x & 31;
  for (int64_t r = warp_id(); r < nd; r += warp_count()) {
    const int32_t* ir = idx + r * fan;
    const float* wr = mode == kWeighted ? w + r * fan : nullptr;
    const float denom = static_cast<float>(max(count_valid(ir, fan, lane), 1));
    for (int c0 = 0; c0 < fan; c0 += 32) {
      const int f = c0 + lane;
      const int32_t mine = f < fan ? ir[f] : -1;
      const float mine_w = (wr != nullptr && f < fan) ? wr[f] : 1.f;
      float mine_dw = 0.f;                 // padded entries keep 0
      unsigned valid = __ballot_sync(kFull, mine >= 0);
      while (valid) {                      // warp-uniform
        const int b = __ffs(valid) - 1;
        valid &= valid - 1;
        int64_t s = __shfl_sync(kFull, mine, b);
        s = s < ns ? s : ns - 1;
        const float ws = __shfl_sync(kFull, mine_w, b);
        float dot = 0.f;
        for (int64_t p = lane; p < words; p += 32) {
          const P g = gv[r * words + p];
          float* dst = dh + (s * words + p) * V;
#pragma unroll
          for (int j = 0; j < V; ++j)
            atomicAdd(dst + j, mode == kMean   ? g.v[j] / denom
                               : mode == kSum ? g.v[j]
                                              : g.v[j] * ws);
          if (dw != nullptr) {
            const P x = hv[s * words + p];
#pragma unroll
            for (int j = 0; j < V; ++j) dot += g.v[j] * x.v[j];
          }
        }
        if (dw != nullptr) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
          if (lane == b) mine_dw = dot;
        }
      }
      if (dw != nullptr && f < fan) dw[r * fan + f] = mine_dw;
    }
  }
}

int blocks_for(int64_t rows) {
  const int64_t rows_per_block = kThreads / 32;
  int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks);
}

// widest float count per word (4, 2 or 1) that d and every pointer allow
int word_floats(int64_t d, uintptr_t bases) {
  if (d % 4 == 0 && bases % 16 == 0) return 4;
  if (d % 2 == 0 && bases % 8 == 0) return 2;
  return 1;
}

template <int V, int K>
void launch_fwd(const void* idx, const void* h, const void* w, void* out, int64_t nd,
                int fan, int64_t ns, int64_t d, int mode, cudaStream_t stream) {
  agg_fwd_kernel<V, K><<<blocks_for(nd), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<float*>(out), nd, fan, ns, d / V, mode);
}

template <int V>
void launch_bwd(const void* idx, const void* dout, const void* h, const void* w,
                void* dh, void* dw, int64_t nd, int fan, int64_t ns, int64_t d,
                int mode, cudaStream_t stream) {
  agg_bwd_kernel<V><<<blocks_for(nd), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(dout),
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<float*>(dh), static_cast<float*>(dw), nd, fan, ns, d / V, mode);
}

}  // namespace

// The C entries return cudaGetLastError() after the launch (0 = launched).
// The caller has checked types, shapes and devices: nd >= 1, ns >= 1, d >= 1,
// fan >= 0, mode in {0, 1, 2}, w non-null exactly when mode == 2.

extern "C" int neighbor_agg_fwd_launch(const void* idx, const void* h, const void* w,
                                       void* out, long long nd, int fan, long long ns,
                                       long long d, int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  switch (word_floats(d, bases)) {
    case 4: launch_fwd<4, 2>(idx, h, w, out, nd, fan, ns, d, mode, s); break;
    case 2: launch_fwd<2, 4>(idx, h, w, out, nd, fan, ns, d, mode, s); break;
    default: launch_fwd<1, 8>(idx, h, w, out, nd, fan, ns, d, mode, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// dh (ns, d) is zero-filled here before the kernel adds into it; dw is
// given (non-null) exactly in mode 2.
extern "C" int neighbor_agg_bwd_launch(const void* idx, const void* dout, const void* h,
                                       const void* w, void* dh, void* dw, long long nd,
                                       int fan, long long ns, long long d, int mode,
                                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(dh, 0, static_cast<size_t>(ns) * static_cast<size_t>(d) * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(dh);
  switch (word_floats(d, bases)) {
    case 4: launch_bwd<4>(idx, dout, h, w, dh, dw, nd, fan, ns, d, mode, s); break;
    case 2: launch_bwd<2>(idx, dout, h, w, dh, dw, nd, fan, ns, d, mode, s); break;
    default: launch_bwd<1>(idx, dout, h, w, dh, dw, nd, fan, ns, d, mode, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
