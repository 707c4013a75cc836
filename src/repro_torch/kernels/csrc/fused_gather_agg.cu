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
// card's f32 rate.  At layer 0 of the full-width batch (idx (90112, 5),
// F = 100) the bound is 104 MB, 0.031 ms at 3.35 TB/s, of which the two
// outputs are 72 MB.
//
// Each neighbour's row is behind two dependent index loads (idx, then enc),
// so resolving them row by row costs three or four round trips a dst row.
// Here:
//   - A block owns a tile of consecutive dst rows and resolves the tile's
//     whole index chain first: one coalesced read of the tile's idx span,
//     then, for every entry and every self row at once (a thread each), the
//     enc load and the clamp to a row pointer, kept in shared memory.  A
//     tile costs the index chain's round trips once, not once a row.
//     Fanouts past the stage (1,024 entries a tile) are staged in chunks.
//   - Each thread owns one word (16, 8 or 4 bytes: the widest that F and
//     every base pointer allow) of one row of each of the tile's passes and
//     reads that word of the self row and of U >= fan neighbours (fan <= 16)
//     before it adds any: one round trip a pass.  The lanes of a warp take
//     consecutive words of one or two rows, so F = 100 (25 words) leaves 3
//     of 128 threads idle where a warp a row left 7 of every 32 lanes, and a
//     tile writes its output rows as one contiguous span, with streaming
//     stores (written once, never read here).  Rows wider than a block are
//     cut into column tiles.
//   - 128-thread blocks of up to 4 passes (20 rows at F = 100); at a small
//     Nd the passes halve until every SM has four tiles.
//   - A bulk-copy route (TMA's cp.async.bulk of each referenced row into
//     shared memory, counted by an mbarrier) was slower on the H100
//     (scripts/fwd_bulk_route.py; PERF.md), and so, in development timing,
//     were the staged, compacted rounds of csrc/segment_agg.cu's forward.
//
// Sums: the self row is a straight copy (bit-exact with the plain
// version); the neighbour sum starts at +0 and adds the entries in
// ascending f, in f32, one rounding per add (a padded slot adds +0, which
// leaves a sum that is never -0 unchanged); the mean is one IEEE division
// by max(cnt, 1).  Out-of-range slots clamp (slot >= C to C - 1, sideband
// row >= Na to Na - 1, idx >= Ns to Ns - 1), the out-of-range rule of the
// JAX gather.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPasses = 4;        // most row passes of one tile
constexpr int kStage = 1024;      // neighbour entries a tile stages at once
constexpr int kMaxRows = kThreads * kPasses;

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

// how a launch cuts the (Nd, words) outputs into tiles: a tile is
// rows = per_pass * passes consecutive dst rows by `cols` words of them;
// thread t < per_pass * cols takes word t % cols of row t / cols of each pass
struct Geom {
  int cols;          // words of a row one tile takes
  int col_tiles;     // tiles across a row
  int per_pass;      // rows a pass takes
  int passes;        // passes a tile takes
};

// written once and not read again here: evict first (st.global.cs)
template <int V>
__device__ __forceinline__ void store_stream(Pack<V>* p, const Pack<V>& v) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v.v[0], v.v[1], v.v[2], v.v[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v.v[0], v.v[1]));
  } else {
    __stcs(reinterpret_cast<float*>(p), v.v[0]);
  }
}

// V floats per word; U neighbour words read before any is added (U covers
// the fanout up to 16), with the self row's word
template <int V, int U>
__global__ void __launch_bounds__(kThreads)
gather_aggregate_kernel(const int32_t* __restrict__ enc, const int32_t* __restrict__ idx,
                        Rows<V> rows_of, Pack<V>* __restrict__ h_dst,
                        Pack<V>* __restrict__ agg, int64_t ns, int64_t nd, int fan, Geom g,
                        int mean) {
  using P = Pack<V>;
  __shared__ const P* s_nb[kStage];        // a tile's neighbour rows, nullptr = pad
  __shared__ const P* s_self[kMaxRows];
  const int64_t words = rows_of.words;
  const int rows = g.per_pass * g.passes;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / g.col_tiles) * rows;
  const int nrows = static_cast<int>(nd - r0 < rows ? nd - r0 : rows);
  const int rr = threadIdx.x / g.cols;
  const int64_t col = static_cast<int64_t>(blockIdx.x % g.col_tiles) * g.cols +
                      threadIdx.x % g.cols;
  const bool mine = rr < g.per_pass && col < words;
  const int chunk = max(1, min(fan, kStage / rows));
  // self rows: the dst ids are the prefix of the input ids
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) s_self[r] = rows_of.row(enc[r0 + r]);
  float acc[kPasses][V];
  int cnt[kPasses];
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    cnt[k] = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  }
  int f0 = 0;
  do {
    const int fc = min(chunk, fan - f0);
    if (f0 > 0) __syncthreads();
    // the chunk's index chain, one entry a thread: idx, then enc, then the row
    for (int e = threadIdx.x; e < nrows * fc; e += blockDim.x) {
      const int r = e / fc;
      const int32_t s = idx[(r0 + r) * fan + f0 + (e - r * fc)];
      s_nb[e] = s < 0 ? nullptr : rows_of.row(enc[s < ns ? s : ns - 1]);
    }
    __syncthreads();
    if (mine) {
#pragma unroll
      for (int k = 0; k < kPasses; ++k) {
        const int r = rr + k * g.per_pass;
        if (k < g.passes && r < nrows) {
          P self;
          if (f0 == 0) self = s_self[r][col];
          const P* const* nr = s_nb + r * fc;
          for (int f = 0; f < fc; f += U) {
            P x[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const P* src = f + u < fc ? nr[f + u] : nullptr;
              cnt[k] += src != nullptr;
              if (src != nullptr) {
                x[u] = src[col];
              } else {
#pragma unroll
                for (int j = 0; j < V; ++j) x[u].v[j] = 0.f;
              }
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int j = 0; j < V; ++j) acc[k][j] += x[u].v[j];
          }
          if (f0 == 0) store_stream<V>(h_dst + (r0 + r) * words + col, self);
        }
      }
    }
    f0 += chunk;
  } while (f0 < fan);
  if (!mine) return;
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int r = rr + k * g.per_pass;
    if (k < g.passes && r < nrows) {
      const float denom = static_cast<float>(max(cnt[k], 1));
      P o;
#pragma unroll
      for (int j = 0; j < V; ++j) o.v[j] = mean ? acc[k][j] / denom : acc[k][j];
      store_stream<V>(agg + (r0 + r) * words + col, o);
    }
  }
}

int sm_count() {
  int dev = 0, n = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int V, int U>
cudaError_t launch(const void* enc, const void* idx, const void* table, const void* aux,
                   void* h_dst, void* agg, int64_t ns, int64_t nd, int fan, int64_t capacity,
                   int64_t aux_rows, int64_t f, int mean, cudaStream_t stream) {
  const int64_t words = f / V;
  // whole rows where a row fits the block, else near-equal column tiles;
  // then the most passes (up to kPasses) that still give every SM 4 tiles
  Geom g;
  g.col_tiles = static_cast<int>((words + kThreads - 1) / kThreads);
  g.cols = static_cast<int>((words + g.col_tiles - 1) / g.col_tiles);
  g.per_pass = kThreads / g.cols;
  g.passes = kPasses;
  const int64_t want = 4LL * sm_count();
  while (g.passes > 1 &&
         (nd + g.per_pass * g.passes - 1) / (g.per_pass * g.passes) * g.col_tiles < want)
    g.passes /= 2;
  const int64_t tile_rows = g.per_pass * g.passes;
  const int64_t tiles = (nd + tile_rows - 1) / tile_rows * g.col_tiles;
  const Rows<V> rows{static_cast<const Pack<V>*>(table), static_cast<const Pack<V>*>(aux),
                     capacity, aux_rows, words};
  gather_aggregate_kernel<V, U><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(enc), static_cast<const int32_t*>(idx), rows,
      static_cast<Pack<V>*>(h_dst), static_cast<Pack<V>*>(agg), ns, nd, fan, g, mean);
  return cudaGetLastError();
}

// U, the neighbour words a thread reads before it adds any: the fanout
// rounded up to 4, 8 or 16 (wider fanouts take rounds of 16)
template <int V>
cudaError_t launch_depth(const void* enc, const void* idx, const void* table, const void* aux,
                         void* h_dst, void* agg, int64_t ns, int64_t nd, int fan,
                         int64_t capacity, int64_t aux_rows, int64_t f, int mean,
                         cudaStream_t s) {
  if (fan <= 4)
    return launch<V, 4>(enc, idx, table, aux, h_dst, agg, ns, nd, fan, capacity, aux_rows, f,
                        mean, s);
  if (fan <= 8)
    return launch<V, 8>(enc, idx, table, aux, h_dst, agg, ns, nd, fan, capacity, aux_rows, f,
                        mean, s);
  return launch<V, 16>(enc, idx, table, aux, h_dst, agg, ns, nd, fan, capacity, aux_rows, f,
                       mean, s);
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
  cudaError_t err;
  if (f % 4 == 0 && bases % 16 == 0) {
    err = launch_depth<4>(enc, idx, table, aux, h_dst, agg, ns, nd, fan, capacity, aux_rows, f,
                          mean, s);
  } else if (f % 2 == 0 && bases % 8 == 0) {
    err = launch_depth<2>(enc, idx, table, aux, h_dst, agg, ns, nd, fan, capacity, aux_rows, f,
                          mean, s);
  } else {
    err = launch_depth<1>(enc, idx, table, aux, h_dst, agg, ns, nd, fan, capacity, aux_rows, f,
                          mean, s);
  }
  return static_cast<int>(err);
}
