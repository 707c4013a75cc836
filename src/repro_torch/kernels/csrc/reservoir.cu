// reservoir_topm: Efraimidis-Spirakis weighted top-m of each row.
//
// Replaces the TPU kernel src/repro/kernels/reservoir/kernel.py:reservoir_topm_pallas.
//
//   w, u (R, N) float32;  mask (R, N) of 1 or 4 bytes, nonzero = valid
//   key[j]  = logf(fmaxf(u[j], 1e-30f)) / fmaxf(w[j], 1e-9f)   (IEEE logf and
//             division: the build has no fast-math, so the keys are the
//             plain version's torch.log(...) / ... bit for bit)
//   out     = the m first lanes of the row under one total order, key
//             descending then lane ascending, with their keys; a round past
//             the row's last valid lane writes (N, -3.0e38f)
//
// The Pallas kernel takes m rounds of "row max, first lane attaining it,
// mask it" over (8 rows, 128 lanes) tiles.  Those rounds compute exactly the
// top-m under the order above, so this kernel keeps candidate lists under
// that order instead of rescanning: every valid key is at least
// log(1e-30)/1e-9 ~ -6.9e10, so -INFINITY is free to mark a masked lane or
// an empty slot.
//
// Bound: bytes.  Each lane is read once (8 bytes of w and u plus the mask)
// and 8 bytes a slot are written; a few flops per lane.  The sampler's hop
// gives one launch per padded width, from 6,919 rows of 8 lanes to one row of
// 131,072, so the launcher picks one of two layouts from N:
//   * N <= 1024: one warp per row, up to 32 keys a lane in registers; each
//     round every lane finds its best key after the previous winner and a
//     warp-shuffle argmax over (key, lane) pairs picks the winner;
//   * N > 1024: one block of 512 threads per row; each thread loads 4 of its
//     strided lanes at a time and keeps a sorted list of its first L of them
//     in registers (L = 8, 16 or 32, the least >= m), then m rounds of a
//     block argmax over the list heads pop the winners.  An m above 32 takes
//     ceil(m / 32) such passes, each over the lanes after the last winner.
// One hub row runs on one SM, where the per-lane logf and IEEE divide, not
// the bytes, set its time (PERF.md); splitting a row across blocks is left
// to a later change.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -3.0e38f;    // the exhausted key of the JAX kernel
constexpr int kWarpRowsPerBlock = 8;
constexpr int kMaxWarpLanes = 1024;  // widest row of the warp layout
constexpr int kBlockThreads = 512;
constexpr int kBatch = 4;           // lanes a thread loads before it sorts any
constexpr unsigned kFull = 0xffffffffu;

// (ka, ia) comes before (kb, ib): larger key, or equal key and lower lane
__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// the three loads are independent, so a caller's unrolled lanes issue them
// together rather than one dependent round trip after another
template <typename MaskT>
__device__ __forceinline__ float lane_key(const float* w, const float* u,
                                          const MaskT* mask, int64_t j) {
  const float key = logf(fmaxf(u[j], 1e-30f)) / fmaxf(w[j], 1e-9f);
  return mask[j] != 0 ? key : -INFINITY;
}

// butterfly argmax: every lane ends with the warp's first (key, lane)
__device__ __forceinline__ void warp_first(float& k, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, k, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (before(ok, oi, k, i)) {
      k = ok;
      i = oi;
    }
  }
}

__device__ void fill_exhausted(int32_t* idx, float* key, int from, int m,
                               int n, int start, int stride) {
  for (int t = from + start; t < m; t += stride) {
    idx[t] = n;
    key[t] = kNeg;
  }
}

// -- narrow rows: one warp per row, K = ceil(N / 32) keys a lane -------------
template <int K, typename MaskT>
__global__ void topm_warp_kernel(const float* __restrict__ w,
                                 const float* __restrict__ u,
                                 const MaskT* __restrict__ mask,
                                 int32_t* __restrict__ out_idx,
                                 float* __restrict__ out_key, int64_t rows,
                                 int n, int m) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpRowsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int64_t base = row * n;
  float keys[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    keys[k] = j < n ? lane_key(w + base, u + base, mask + base, j) : -INFINITY;
  }
  int32_t* idx = out_idx + row * m;
  float* key = out_key + row * m;
  float kp = INFINITY;  // the previous winner: every lane comes after it
  int ip = -1;
  for (int r = 0; r < m; ++r) {
    float bk = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      if (keys[k] > -INFINITY && before(kp, ip, keys[k], j) &&
          before(keys[k], j, bk, bi)) {
        bk = keys[k];
        bi = j;
      }
    }
    warp_first(bk, bi);
    if (bk == -INFINITY) {  // no valid lane left: uniform across the warp
      fill_exhausted(idx, key, r, m, n, lane, 32);
      return;
    }
    if (lane == 0) {
      idx[r] = bi;
      key[r] = bk;
    }
    kp = bk;
    ip = bi;
  }
}

// -- wide rows: one block per row, a sorted list of L per thread -----------
// A pass keeps each thread's first L lanes after the previous pass's last
// winner, sorted in registers (every index is a constant after unrolling),
// then pops min(L, m - done) winners by block argmax over the list heads.
template <int L, typename MaskT>
__global__ void __launch_bounds__(kBlockThreads)
topm_block_kernel(const float* __restrict__ w, const float* __restrict__ u,
                  const MaskT* __restrict__ mask, int32_t* __restrict__ out_idx,
                  float* __restrict__ out_key, int n, int m) {
  __shared__ float warp_k[kBlockThreads / 32];
  __shared__ int warp_i[kBlockThreads / 32];
  __shared__ float win_k;
  __shared__ int win_i;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const float* wr = w + row * n;
  const float* ur = u + row * n;
  const MaskT* mr = mask + row * n;
  int32_t* idx = out_idx + row * m;
  float* key = out_key + row * m;

  float kp = INFINITY;  // last winner of the previous pass
  int ip = -1;
  for (int done = 0; done < m; done += L) {
    float lk[L];
    int li[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      lk[k] = -INFINITY;
      li[k] = INT_MAX;
    }
    for (int base = tid; base < n; base += kBatch * kBlockThreads) {
      float c[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = base + b * kBlockThreads;
        c[b] = j < n ? lane_key(wr, ur, mr, j) : -INFINITY;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = base + b * kBlockThreads;
        if (c[b] == -INFINITY || !before(kp, ip, c[b], j) ||
            !before(c[b], j, lk[L - 1], li[L - 1]))
          continue;
        lk[L - 1] = c[b];  // replaces the last kept lane, then bubbles up
        li[L - 1] = j;
#pragma unroll
        for (int k = L - 1; k > 0; --k) {
          if (before(lk[k], li[k], lk[k - 1], li[k - 1])) {
            const float sk = lk[k];
            const int si = li[k];
            lk[k] = lk[k - 1];
            li[k] = li[k - 1];
            lk[k - 1] = sk;
            li[k - 1] = si;
          }
        }
      }
    }
    const int rounds = min(L, m - done);
    for (int r = 0; r < rounds; ++r) {
      float bk = lk[0];
      int bi = li[0];
      warp_first(bk, bi);
      if (lane == 0) {
        warp_k[warp] = bk;
        warp_i[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        bk = lane < kBlockThreads / 32 ? warp_k[lane] : -INFINITY;
        bi = lane < kBlockThreads / 32 ? warp_i[lane] : INT_MAX;
        warp_first(bk, bi);
        if (lane == 0) {
          win_k = bk;
          win_i = bi;
        }
      }
      __syncthreads();
      bk = win_k;
      bi = win_i;
      if (bk == -INFINITY) {  // no valid lane left: uniform across the block
        fill_exhausted(idx, key, done + r, m, n, tid, kBlockThreads);
        return;
      }
      if (tid == 0) {
        idx[done + r] = bi;
        key[done + r] = bk;
      }
      if (li[0] == bi) {  // the owner pops its head
#pragma unroll
        for (int k = 0; k < L - 1; ++k) {
          lk[k] = lk[k + 1];
          li[k] = li[k + 1];
        }
        lk[L - 1] = -INFINITY;
        li[L - 1] = INT_MAX;
      }
      kp = bk;
      ip = bi;
    }
  }
}

template <int K, typename MaskT>
void launch_warp(const float* w, const float* u, const MaskT* mask, int32_t* idx,
                 float* key, int64_t rows, int n, int m, cudaStream_t s) {
  const auto blocks =
      static_cast<unsigned>((rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock);
  topm_warp_kernel<K, MaskT><<<blocks, 32 * kWarpRowsPerBlock, 0, s>>>(
      w, u, mask, idx, key, rows, n, m);
}

template <typename MaskT>
void launch(const float* w, const float* u, const void* mask, int32_t* idx,
            float* key, int64_t rows, int n, int m, cudaStream_t s) {
  const auto* mk = static_cast<const MaskT*>(mask);
  const int per_lane = (n + 31) / 32;
  const auto grid = static_cast<unsigned>(rows);
  if (n > kMaxWarpLanes && m <= 8) {
    topm_block_kernel<8, MaskT><<<grid, kBlockThreads, 0, s>>>(w, u, mk, idx, key, n, m);
  } else if (n > kMaxWarpLanes && m <= 16) {
    topm_block_kernel<16, MaskT><<<grid, kBlockThreads, 0, s>>>(w, u, mk, idx, key, n, m);
  } else if (n > kMaxWarpLanes) {
    topm_block_kernel<32, MaskT><<<grid, kBlockThreads, 0, s>>>(w, u, mk, idx, key, n, m);
  } else if (per_lane == 1) {
    launch_warp<1>(w, u, mk, idx, key, rows, n, m, s);
  } else if (per_lane == 2) {
    launch_warp<2>(w, u, mk, idx, key, rows, n, m, s);
  } else if (per_lane <= 4) {
    launch_warp<4>(w, u, mk, idx, key, rows, n, m, s);
  } else if (per_lane <= 8) {
    launch_warp<8>(w, u, mk, idx, key, rows, n, m, s);
  } else if (per_lane <= 16) {
    launch_warp<16>(w, u, mk, idx, key, rows, n, m, s);
  } else {
    launch_warp<32>(w, u, mk, idx, key, rows, n, m, s);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  The caller
// has checked the shapes, types and devices: rows >= 1, 1 <= n <= 2^30,
// 1 <= m <= 2^30, every array contiguous; mask_bytes is 1 or 4.  NaN in w or
// u is outside the contract (fmaxf drops it where torch.clamp keeps it).
extern "C" int reservoir_topm_launch(const void* w, const void* u, const void* mask,
                                     int mask_bytes, void* idx, void* key,
                                     long long rows, int n, int m, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  auto* oi = static_cast<int32_t*>(idx);
  auto* ok = static_cast<float*>(key);
  if (mask_bytes == 4) {
    launch<int32_t>(wf, uf, mask, oi, ok, rows, n, m, s);
  } else {
    launch<uint8_t>(wf, uf, mask, oi, ok, rows, n, m, s);
  }
  return static_cast<int>(cudaGetLastError());
}
