// gather_aggregate: resolve encoded feature rows from the cache table or the
// miss sideband, write the dst self rows and the masked neighbour mean or sum,
// in one pass.
//
// Replaces the TPU kernel src/repro/kernels/fused_gather_agg/kernel.py:
// gather_aggregate_pallas (_fused_kernel, _resolve).  Forward only: its
// inputs (the feature table and the sideband) are not parameters.
//
//   enc (Ns,) int32:  enc[i] >= 0 -> table[enc[i]];  enc[i] < 0 -> aux[-enc[i]-1]
//   idx (Nd, fan) int32 into [0, Ns), -1 = pad;  Nd <= Ns
//   table (C, F) f32, aux (Na, F) f32 with Na >= 1
//   h_dst[r] = row(enc[r])
//   agg[r]   = sum_f valid row(enc[idx[r,f]])  (/ max(cnt_r, 1) in mode 0, mean)
//
// Bound: bytes.  The kernel reads each referenced row once, enc and idx once,
// and writes 2 * Nd * F floats; its fan * F adds per row are far below the
// card's f32 rate.  Before each neighbour's row read come two dependent index
// loads (idx, then enc), so the kernel is latency-bound at small Nd: the
// lanes of a warp load a whole index chunk and its enc entries at once (one
// lane per neighbour), and the warp then starts the row reads of kInFlight
// neighbours before it adds any of them.  One warp owns one dst row and
// grid-strides over rows; the self row is a straight copy (bit-exact with
// the plain version); the neighbour sum is taken in index order, in f32, in
// registers, K words per lane per column tile.  Rows are read in the widest
// word (16, 8 or 4 bytes) that F and every base pointer allow.  Out-of-range
// slots clamp (slot >= C to C - 1, sideband row >= Na to Na - 1, idx >= Ns to
// Ns - 1), the out-of-range rule of the JAX gather.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps, one dst row each per grid-stride step
constexpr int kMaxBlocks = 4096;
constexpr int kInFlight = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct alignas(4 * V) Pack {
  float v[V];
};

template <int V>
struct Rows {                          // the two places a row can live
  const Pack<V>* table;
  const Pack<V>* aux;
  int64_t capacity, aux_rows, words;

  __device__ __forceinline__ const Pack<V>* row(int32_t e) const {
    if (e >= 0) return table + (e < capacity ? e : capacity - 1) * words;
    const int64_t a = -static_cast<int64_t>(e) - 1;
    return aux + (a < aux_rows ? a : aux_rows - 1) * words;
  }
};

template <int V, int K>
__global__ void gather_aggregate_kernel(const int32_t* __restrict__ enc,
                                        const int32_t* __restrict__ idx,
                                        Rows<V> rows,
                                        Pack<V>* __restrict__ h_dst,
                                        Pack<V>* __restrict__ agg,
                                        int64_t ns, int64_t nd, int fan, int mean) {
  using P = Pack<V>;
  const int64_t words = rows.words;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t r = warp; r < nd; r += warps) {
    // self row: the dst ids are the prefix of the input ids
    const P* self = rows.row(enc[r]);
    for (int64_t p = lane; p < words; p += 32) h_dst[r * words + p] = self[p];

    const int32_t* ir = idx + r * fan;
    int cnt = 0;
    for (int c0 = 0; c0 < fan; c0 += 32) {
      const int f = c0 + lane;
      cnt += __popc(__ballot_sync(kFull, f < fan && ir[f] >= 0));
    }
    const float denom = static_cast<float>(max(cnt, 1));
    for (int64_t t0 = 0; t0 < words; t0 += 32 * K) {        // column tile
      float acc[K][V];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
      for (int c0 = 0; c0 < fan; c0 += 32) {                // index chunk
        const int f = c0 + lane;
        const int32_t mine = f < fan ? ir[f] : -1;
        // each lane resolves its own neighbour's slot: enc loads in parallel
        const int32_t mine_enc = mine >= 0 ? enc[mine < ns ? mine : ns - 1] : 0;
        unsigned valid = __ballot_sync(kFull, mine >= 0);
        while (valid) {                                     // warp-uniform
          const P* src[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            src[u] = nullptr;
            if (valid) {
              const int b = __ffs(valid) - 1;
              valid &= valid - 1;
              src[u] = rows.row(__shfl_sync(kFull, mine_enc, b));
            }
          }
          P got[kInFlight][K];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int64_t p = t0 + k * 32 + lane;
              if (src[u] != nullptr && p < words) {
                got[u][k] = src[u][p];
              } else {
#pragma unroll
                for (int j = 0; j < V; ++j) got[u][k].v[j] = 0.f;
              }
            }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
              for (int j = 0; j < V; ++j) acc[k][j] += got[u][k].v[j];
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t p = t0 + k * 32 + lane;
        if (p < words) {
          P o;
#pragma unroll
          for (int j = 0; j < V; ++j) o.v[j] = mean ? acc[k][j] / denom : acc[k][j];
          agg[r * words + p] = o;
        }
      }
    }
  }
}

template <int V, int K>
void launch(const void* enc, const void* idx, const void* table, const void* aux,
            void* h_dst, void* agg, int64_t ns, int64_t nd, int fan, int64_t capacity,
            int64_t aux_rows, int64_t f, int mean, cudaStream_t stream) {
  const int64_t rows_per_block = kThreads / 32;
  int64_t blocks = (nd + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Rows<V> rows{static_cast<const Pack<V>*>(table), static_cast<const Pack<V>*>(aux),
                     capacity, aux_rows, f / V};
  gather_aggregate_kernel<V, K><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(enc), static_cast<const int32_t*>(idx), rows,
      static_cast<Pack<V>*>(h_dst), static_cast<Pack<V>*>(agg), ns, nd, fan, mean);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  The caller has
// checked types, shapes and devices: 1 <= nd <= ns, capacity >= 1,
// aux_rows >= 1, f >= 1, fan >= 0; mode 0 = mean, 1 = sum.
extern "C" int gather_aggregate_launch(const void* enc, const void* idx, const void* table,
                                       const void* aux, void* h_dst, void* agg, long long ns,
                                       long long nd, int fan, long long capacity,
                                       long long aux_rows, long long f, int mode,
                                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int mean = mode == 0 ? 1 : 0;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(aux) |
                          reinterpret_cast<uintptr_t>(h_dst) | reinterpret_cast<uintptr_t>(agg);
  if (f % 4 == 0 && bases % 16 == 0) {
    launch<4, 2>(enc, idx, table, aux, h_dst, agg, ns, nd, fan, capacity, aux_rows, f, mean, s);
  } else if (f % 2 == 0 && bases % 8 == 0) {
    launch<2, 4>(enc, idx, table, aux, h_dst, agg, ns, nd, fan, capacity, aux_rows, f, mean, s);
  } else {
    launch<1, 8>(enc, idx, table, aux, h_dst, agg, ns, nd, fan, capacity, aux_rows, f, mean, s);
  }
  return static_cast<int>(cudaGetLastError());
}
