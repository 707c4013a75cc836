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
//   dh[s] = sum over valid (r, f) with idx[r,f] -> s, in ascending e = r*fan + f,
//           of g(r, f) = dout[r] / cnt_r (mean) | dout[r] (sum) | dout[r] * w[r,f]
//   dw[r,f] = valid ? <dout[r], h[idx[r,f]]> : 0          (weighted only)
// which is jax.vjp of segment_agg/ref.py: padded entries get zero gradient.
// Bound: bytes.  dh (Ns, D) is written once, dout read once, the indices
// (and weights and, for dw, the referenced h rows) once.  An atomic scatter
// of g into a zero-filled dh writes dh twice and adds in an order that
// changes from run to run.  Here each dh row is pulled instead, and written
// once, from a transposition of the indices built on the card.  Most
// segments are short (at the first full-width batch's hop 1, 29,329
// sources take 39,175 entries, 16 take more than 32, the longest 322), so
// the transposition is a bucket of 32 ids per source, not a sorted CSR (a
// CSR's scan and sort each take a launch of their own; on an H100 they
// cost more than the pull they feed saved):
//   1. bucket: a thread per entry takes slot k = atomicAdd(cnt[src], 1)
//              (integer counts are exact, so cnt is the same every run)
//              and writes its flat id e there if k < 32; later ids go to an
//              overflow list as (src, e), and the 33rd lists src as long.
//              For the mean, cnt_r[r] counts the valid entries of row r.
//   2. long:   a block per long source gathers its bucket and overflow ids
//              into shared memory, sorts them (bitonic, up to 2,048) and
//              pulls a column a thread, 32 dout rows in flight; a longer
//              source is pulled by walking every entry in order.
//   3. short:  a warp per source row with at most 32 ids (nearly all) sorts
//              them by shuffles (bitonic), pulls the dout rows in order and
//              writes dh[s] once, zeros where no entry names s.  Rows move
//              in the widest word that D and the pointers allow.  This
//              kernel does little a row, so it is kept lean (no shared
//              memory, 4-warp blocks); one warp per row in row order was
//              faster than fewer warps taking several rows each.  It starts
//              while the long kernel runs (programmatic dependent launch).
//   4. dw (weighted only): a warp per dst row, a warp dot product per valid
//              entry, kInFlight entries' h rows read before any is reduced.
// Every g is rounded as the plain version rounds it (``scaled``: the mean's
// division by the count is a double product rounded once, which equals the
// IEEE quotient; __fdiv_rn's slow-path branch inside a column's add chain
// serialised the long kernel) and added with __fadd_rn in ascending e, the order
// of the plain version's index_add_ over neigh_idx[mask] on the CPU: dh is
// bit-equal to it, and to itself from run to run.  No float is added
// atomically.

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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kShort = 32;          // bucket ids per source: one a lane
constexpr int kLongCap = 2048;      // ids a long segment sorts in shared memory
constexpr int kLongBlocks = 128;    // long-kernel blocks: a source each
constexpr int kLongDepth = 32;      // dout rows in flight in the long kernel
constexpr int kShortThreads = 128;  // 4 warps: a block ends with its slowest row

// the wrapper's scratch buffer, carved by ``layout``; the head is zeroed
struct Plan {
  int32_t* cnt;       // ns: entries naming each source
  int32_t* cnt_r;     // nd: valid entries of each dst row (mean)
  int32_t* nlong;     // sources with more than kShort entries
  int32_t* novf;      // entries past a source's bucket
  int32_t* bucket;    // ns * kShort: a source's first kShort flat ids
  int32_t* longs;     // the long sources
  int2* ovf;          // (source, flat id) past the buckets, in no order
};

struct Layout {
  size_t cnt, cnt_r, ctr, zero_bytes, bucket, longs, ovf, total;
};

size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

Layout layout(int64_t nd, int fan, int64_t ns) {
  const size_t ne = static_cast<size_t>(nd) * static_cast<size_t>(fan);
  Layout l{};
  size_t o = 0;
  l.cnt = o;    o = align16(o + ns * sizeof(int32_t));
  l.cnt_r = o;  o = align16(o + nd * sizeof(int32_t));
  l.ctr = o;    o = align16(o + 2 * sizeof(int32_t));
  l.zero_bytes = o;
  l.bucket = o; o = align16(o + ns * kShort * sizeof(int32_t));
  l.longs = o;  o = align16(o + (ne / (kShort + 1) + 1) * sizeof(int32_t));   // long_cap
  l.ovf = o;    o = align16(o + (ne + 1) * sizeof(int2));
  l.total = o;
  return l;
}

__device__ __forceinline__ int64_t clamp_src(int32_t s, int64_t ns) {
  return s < ns ? s : ns - 1;
}

// a thread per entry: integer counts (exact, so the same every run) and
// each id into its source's bucket, or past it into the overflow list
__global__ void bwd_bucket_kernel(const int32_t* __restrict__ idx, int64_t ne, int fan,
                                  int64_t ns, Plan plan) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < ne;
       e += stride) {
    const int32_t raw = idx[e];
    if (raw < 0) continue;
    const int64_t s = clamp_src(raw, ns);
    const int k = atomicAdd(plan.cnt + s, 1);
    if (k < kShort) {
      plan.bucket[s * kShort + k] = static_cast<int32_t>(e);
    } else {
      if (k == kShort) plan.longs[atomicAdd(plan.nlong, 1)] = static_cast<int32_t>(s);
      // one atomic per warp for the overflow list (a hub's ids arrive together)
      const unsigned over = __activemask();
      const int leader = __ffs(over) - 1, lane = threadIdx.x & 31;
      int at = 0;
      if (lane == leader) at = atomicAdd(plan.novf, __popc(over));
      at = __shfl_sync(over, at, leader) + __popc(over & ((1u << lane) - 1));
      plan.ovf[at] = make_int2(static_cast<int32_t>(s), static_cast<int32_t>(e));
    }
    if (plan.cnt_r != nullptr) atomicAdd(plan.cnt_r + e / fan, 1);
  }
}

// ascending sort of one int per lane across the warp (bitonic, by shuffles)
__device__ __forceinline__ int32_t warp_sort(int32_t v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int m = k >> 1; m > 0; m >>= 1) {
      const int32_t o = __shfl_xor_sync(kFull, v, m);
      v = (((lane & m) == 0) == ((lane & k) == 0)) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// The scale of entry e, in double: 1 / cnt_r (mean), w[e] (weighted) or 1.
__device__ __forceinline__ double scale_of(int32_t e, int fan, int mode,
                                           const int32_t* __restrict__ cnt_r,
                                           const float* __restrict__ w) {
  return mode == kMean ? 1.0 / static_cast<double>(cnt_r[e / fan])
         : mode == kWeighted ? static_cast<double>(w[e]) : 1.0;
}

// g = x * sd rounded once to float, as the plain version rounds g.  Sum and
// weighted: the double product is exact, so this is x or __fmul_rn(x, w).
// Mean, sd = RN(1/c) for a count c <= 2^24: the double product is within
// 2^-52 (relative) of x / c, and x / c lies at least 2^-25 / c from every
// float rounding boundary and never on one while the quotient is normal
// (|x| >= 2^-100), so one rounding gives __fdiv_rn(x, c) with no branch on
// that path.  A smaller x (``tiny``) is divided by the caller.
__device__ __forceinline__ float scaled(float x, double sd) {
  return __double2float_rn(static_cast<double>(x) * sd);
}

__device__ __forceinline__ bool tiny(float x, int mode) {
  return mode == kMean && fabsf(x) < 0x1p-100f;
}

// rows[b0, b0 + m) of column col (dst row ids in shared memory) into x
__device__ __forceinline__ void load_batch(float (&x)[kLongDepth], const int32_t* rows, int b0,
                                           int m, const float* __restrict__ dout, int64_t d,
                                           int64_t col) {
#pragma unroll
  for (int k = 0; k < kLongDepth; ++k)
    x[k] = (k < m && col < d) ? dout[static_cast<int64_t>(rows[b0 + k]) * d + col] : 0.f;
}

// acc + the batch x, each scaled by sds[b0 + k], added in order.  The batch
// is scaled with no branch first: a branch in the add loop keeps the
// compiler from scaling ahead of the add chain.
__device__ __forceinline__ float add_batch(float acc, float (&x)[kLongDepth], const int32_t* rows,
                                           const double* sds, int b0, int m, int mode,
                                           const int32_t* __restrict__ cnt_r,
                                           const float* __restrict__ dout, int64_t d,
                                           int64_t col) {
  bool slow = false;
#pragma unroll
  for (int k = 0; k < kLongDepth; ++k) {
    slow |= tiny(x[k], mode);
    x[k] = scaled(x[k], sds[b0 + k]);
  }
  if (slow) {                            // rare: reload and divide the tiny ones
    for (int k = 0; k < m; ++k) {
      const float raw = col < d ? dout[static_cast<int64_t>(rows[b0 + k]) * d + col] : 0.f;
      if (tiny(raw, mode)) x[k] = __fdiv_rn(raw, static_cast<float>(cnt_r[rows[b0 + k]]));
    }
  }
#pragma unroll
  for (int k = 0; k < kLongDepth; ++k)
    if (k < m) acc = __fadd_rn(acc, x[k]);
  return acc;
}

// acc + rows[start, n) of one column, in order, kLongDepth rows in flight
__device__ __forceinline__ float pull_column(float acc, const int32_t* rows, const double* sds,
                                             int start, int n, const float* __restrict__ dout,
                                             int64_t d, int64_t col, int mode,
                                             const int32_t* __restrict__ cnt_r) {
  for (int b0 = start; b0 < n; b0 += kLongDepth) {
    const int m = min(kLongDepth, n - b0);
    float x[kLongDepth];
    load_batch(x, rows, b0, m, dout, d, col);
    acc = add_batch(acc, x, rows, sds, b0, m, mode, cnt_r, dout, d, col);
  }
  return acc;
}

// Programmatic dependent launch (sm_90): a kernel that triggers lets the
// next kernel of the stream, launched with launch_dependent, start before
// it ends; the dependent kernel's last block waits for it, so the stream's
// later work follows both
__device__ __forceinline__ void let_dependents_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void last_block_waits_for_prior_grid() {
  if (blockIdx.x == gridDim.x - 1) asm volatile("griddepcontrol.wait;" ::: "memory");
}

// long sources: a block per source, a thread per column; blocks with no
// source exit at once.  The list's first entry, the count, the bucket and
// the overflow list are read as soon as their address is known, so a source
// costs three round trips before its rows: list, ids, scales.
__global__ void __launch_bounds__(kThreads)
bwd_long_kernel(const int32_t* __restrict__ idx, const float* __restrict__ dout,
                const float* __restrict__ w, float* __restrict__ dh, const Plan plan,
                int64_t nd, int fan, int64_t ns, int64_t d, int mode, int64_t long_cap) {
  __shared__ int32_t s_rows[kLongCap];
  __shared__ double s_sds[kLongCap];
  __shared__ int32_t s_n, s_warp[kThreads / 32];
  let_dependents_start();
  const int tid = threadIdx.x, lane = tid & 31, wib = tid >> 5;
  const int32_t first = blockIdx.x < long_cap ? plan.longs[blockIdx.x] : 0;
  const int n_long = *plan.nlong;
  const int novf = *plan.novf;
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (int j = blockIdx.x; j < n_long; j += gridDim.x) {
    const int64_t s = j == static_cast<int>(blockIdx.x) ? first : plan.longs[j];
    const int len = plan.cnt[s];
    if (len <= kLongCap) {               // gather the ids, sort them, pull
      if (tid < kShort) s_rows[tid] = plan.bucket[s * kShort + tid];
      for (int i0 = 0; i0 < novf; i0 += kThreads) {
        const int i = i0 + tid;
        const int2 v = i < novf ? plan.ovf[i] : make_int2(-1, 0);
        const bool hit = v.x == s;
        const unsigned m = __ballot_sync(kFull, hit);   // one atomic a warp
        int at = 0;
        if (lane == 0 && m) at = atomicAdd(&s_n, __popc(m));
        at = __shfl_sync(kFull, at, 0);
        if (hit) s_rows[kShort + at + __popc(m & ((1u << lane) - 1))] = v.y;
      }
      int n2 = 1;
      while (n2 < len) n2 <<= 1;
      __syncthreads();
      for (int i = len + tid; i < n2; i += kThreads) s_rows[i] = INT32_MAX;
      __syncthreads();
      for (int k = 2; k <= n2; k <<= 1) {
        for (int m = k >> 1; m > 0; m >>= 1) {
          for (int i = tid; i < n2 / 2; i += kThreads) {
            const int lo = ((i & ~(m - 1)) << 1) | (i & (m - 1));
            const int32_t a = s_rows[lo], b = s_rows[lo + m];
            if ((a > b) == ((lo & k) == 0)) {
              s_rows[lo] = b;
              s_rows[lo + m] = a;
            }
          }
          __syncthreads();
        }
      }
      for (int i = tid; i < len; i += kThreads) {
        const int32_t e = s_rows[i];
        s_sds[i] = scale_of(e, fan, mode, plan.cnt_r, w);
        s_rows[i] = e / fan;
      }
      __syncthreads();
      for (int64_t c0 = 0; c0 < d; c0 += kThreads) {
        const int64_t col = c0 + tid;
        const float acc = pull_column(0.f, s_rows, s_sds, 0, len, dout, d, col, mode, plan.cnt_r);
        if (col < d) dh[s * d + col] = acc;
      }
    } else {                             // walk every entry, in order
      const int64_t ne = nd * fan;
      for (int64_t c0 = 0; c0 < d; c0 += kThreads) {
        const int64_t col = c0 + tid;
        float acc = 0.f;
        for (int64_t b0 = 0; b0 < ne; b0 += kThreads) {
          const int64_t e = b0 + tid;
          const int32_t v = e < ne ? idx[e] : -1;
          const bool hit = v >= 0 && clamp_src(v, ns) == s;
          const unsigned m = __ballot_sync(kFull, hit);
          if (lane == 0) s_warp[wib] = __popc(m);
          __syncthreads();
          int before = 0, total = 0;
          for (int q = 0; q < kThreads / 32; ++q) {
            before += q < wib ? s_warp[q] : 0;
            total += s_warp[q];
          }
          if (hit) {
            const int at = before + __popc(m & ((1u << lane) - 1));
            s_rows[at] = static_cast<int32_t>(e / fan);
            s_sds[at] = scale_of(static_cast<int32_t>(e), fan, mode, plan.cnt_r, w);
          }
          __syncthreads();
          acc = pull_column(acc, s_rows, s_sds, 0, total, dout, d, col, mode, plan.cnt_r);
          __syncthreads();
        }
        if (col < d) dh[s * d + col] = acc;
      }
    }
    if (tid == 0) s_n = 0;
    __syncthreads();
  }
}

// short sources: a warp per source row.  An empty row is zeroed; otherwise
// the bucket is read (lanes past the count read ids that are never used).  V floats per word, K words per lane per column tile.
template <int V, int K>
__global__ void __launch_bounds__(kShortThreads)
bwd_short_kernel(const float* __restrict__ dout, const float* __restrict__ w,
                 float* __restrict__ dh, const Plan plan, int fan, int64_t ns,
                 int64_t words, int mode) {
  using P = Pack<V>;
  let_dependents_start();
  const int lane = threadIdx.x & 31;
  const P* gv = reinterpret_cast<const P*>(dout);
  P* hv = reinterpret_cast<P*>(dh);
  const P zero{};
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t s = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5; s < ns;
       s += warps) {
    const int len = plan.cnt[s];
    if (len > kShort) continue;                      // bwd_long_kernel's
    int32_t e = len > lane ? plan.bucket[s * kShort + lane] : INT32_MAX;
    if (len > 1) e = warp_sort(e, lane);
    const bool v = lane < len;
    const int64_t r = v ? e / fan : 0;
    const double sd = v ? scale_of(e, fan, mode, plan.cnt_r, w) : 1.0;
    const float c = mode == kMean && v ? static_cast<float>(plan.cnt_r[r]) : 1.f;
    for (int64_t t0 = 0; t0 < words; t0 += 32 * K) {       // column tile
      float acc[K][V];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
      for (int u = 0; u < len; ++u) {                       // warp-uniform
        const int64_t ru = __shfl_sync(kFull, r, u);
        const double su = __shfl_sync(kFull, sd, u);
        const float cu = __shfl_sync(kFull, c, u);
        P x[K], g[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int64_t p = t0 + k * 32 + lane;
          x[k] = p < words ? gv[ru * words + p] : zero;
        }
        bool slow = false;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int j = 0; j < V; ++j) {
            slow |= tiny(x[k].v[j], mode);
            g[k].v[j] = scaled(x[k].v[j], su);
          }
        if (slow) {                      // rare: divide the tiny ones
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (tiny(x[k].v[j], mode)) g[k].v[j] = __fdiv_rn(x[k].v[j], cu);
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int j = 0; j < V; ++j) acc[k][j] = __fadd_rn(acc[k][j], g[k].v[j]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t p = t0 + k * 32 + lane;
        if (p < words) {
          P o;
#pragma unroll
          for (int j = 0; j < V; ++j) o.v[j] = acc[k][j];
          hv[s * words + p] = o;
        }
      }
    }
  }
  last_block_waits_for_prior_grid();
}

// dw (weighted): a warp per dst row, a warp dot product per valid entry,
// kInFlight entries' h rows read before any is reduced
template <int V>
__global__ void __launch_bounds__(kShortThreads)
bwd_dw_kernel(const int32_t* __restrict__ idx, const float* __restrict__ dout,
              const float* __restrict__ h, float* __restrict__ dw, int64_t nd, int fan,
              int64_t ns, int64_t words) {
  using P = Pack<V>;
  const int lane = threadIdx.x & 31;
  const P* gv = reinterpret_cast<const P*>(dout);
  const P* xv = reinterpret_cast<const P*>(h);
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5; r < nd;
       r += warps) {
    const int32_t* ir = idx + r * fan;
    for (int c0 = 0; c0 < fan; c0 += 32) {
      const int f = c0 + lane;
      const int32_t mine = f < fan ? ir[f] : -1;
      float mine_dw = 0.f;                 // padded entries keep 0
      unsigned valid = __ballot_sync(kFull, mine >= 0);
      while (valid) {                      // warp-uniform
        int b[kInFlight];
        int64_t src[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          b[u] = -1;
          src[u] = 0;
          if (valid) {
            b[u] = __ffs(valid) - 1;
            valid &= valid - 1;
            src[u] = clamp_src(__shfl_sync(kFull, mine, b[u]), ns);
          }
        }
        float dot[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) dot[u] = 0.f;
        for (int64_t p = lane; p < words; p += 32) {
          const P g = gv[r * words + p];
          P x[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
            if (b[u] >= 0) x[u] = xv[src[u] * words + p];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
            if (b[u] >= 0) {
#pragma unroll
              for (int j = 0; j < V; ++j) dot[u] += g.v[j] * x[u].v[j];
            }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) dot[u] += __shfl_xor_sync(kFull, dot[u], off);
          if (lane == b[u]) mine_dw = dot[u];
        }
      }
      if (f < fan) dw[r * fan + f] = mine_dw;
    }
  }
  last_block_waits_for_prior_grid();
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

// one thread per entry, grid-striding
int entry_blocks(int64_t ne) {
  int64_t blocks = (ne + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks);
}

// a warp per row, up to the grid-stride cap
unsigned warp_blocks(int64_t rows) {
  const int64_t per = kShortThreads / 32;
  const int64_t blocks = (rows + per - 1) / per;
  return static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20));
}

// a launch that may start while the stream's previous kernel runs (that
// kernel calls let_dependents_start)
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned grid, unsigned block,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <int V, int K>
cudaError_t launch_pull(const void* idx, const void* dout, const void* h, const void* w,
                        void* dh, void* dw, const Plan& plan, int64_t nd, int fan,
                        int64_t ns, int64_t d, int mode, cudaStream_t stream) {
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* g = static_cast<const float*>(dout);
  const auto* wt = static_cast<const float*>(w);
  const int64_t long_cap = nd * fan / (kShort + 1) + 1;   // the list's length
  bwd_long_kernel<<<kLongBlocks, kThreads, 0, stream>>>(ix, g, wt, static_cast<float*>(dh),
                                                        plan, nd, fan, ns, d, mode, long_cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_dependent(bwd_short_kernel<V, K>, warp_blocks(ns), kShortThreads, stream, g, wt,
                         static_cast<float*>(dh), plan, fan, ns, d / V, mode);
  if (err != cudaSuccess || mode != kWeighted || fan == 0) return err;
  return launch_dependent(bwd_dw_kernel<V>, warp_blocks(nd), kShortThreads, stream, ix, g,
                          static_cast<const float*>(h), static_cast<float*>(dw), nd, fan, ns,
                          d / V);
}

}  // namespace

// The C entries return 0 once every launch is queued, else the first failing
// call's cudaError_t.  The caller has checked types, shapes and devices:
// nd >= 1, ns >= 1, d >= 1, fan >= 0, nd * fan < 2^31, mode in {0, 1, 2},
// w non-null exactly when mode == 2.

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

// Bytes of scratch the backward needs (16-byte aligned base).
extern "C" long long neighbor_agg_bwd_scratch_bytes(long long nd, int fan, long long ns) {
  return static_cast<long long>(layout(nd, fan, ns).total);
}

// dh (ns, d) is written whole; dw is given (non-null) exactly in mode 2.
// A memset of the scratch's head, then bucket, long and short kernels, and
// for mode 2 the dw kernel.
extern "C" int neighbor_agg_bwd_launch(const void* idx, const void* dout, const void* h,
                                       const void* w, void* dh, void* dw, void* scratch,
                                       long long nd, int fan, long long ns, long long d,
                                       int mode, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const Layout l = layout(nd, fan, ns);
  char* base = static_cast<char*>(scratch);
  Plan plan;
  plan.cnt = reinterpret_cast<int32_t*>(base + l.cnt);
  plan.cnt_r = mode == kMean ? reinterpret_cast<int32_t*>(base + l.cnt_r) : nullptr;
  plan.nlong = reinterpret_cast<int32_t*>(base + l.ctr);
  plan.novf = plan.nlong + 1;
  plan.bucket = reinterpret_cast<int32_t*>(base + l.bucket);
  plan.longs = reinterpret_cast<int32_t*>(base + l.longs);
  plan.ovf = reinterpret_cast<int2*>(base + l.ovf);
  const int64_t ne = static_cast<int64_t>(nd) * fan;
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.zero_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ne > 0) {
    bwd_bucket_kernel<<<entry_blocks(ne), kThreads, 0, st>>>(static_cast<const int32_t*>(idx),
                                                             ne, fan, ns, plan);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const uintptr_t bases = reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(dh);
  switch (word_floats(d, bases)) {
    case 4: err = launch_pull<4, 2>(idx, dout, h, w, dh, dw, plan, nd, fan, ns, d, mode, st); break;
    case 2: err = launch_pull<2, 4>(idx, dout, h, w, dh, dw, plan, nd, fan, ns, d, mode, st); break;
    default: err = launch_pull<1, 8>(idx, dout, h, w, dh, dw, plan, nd, fan, ns, d, mode, st); break;
  }
  return static_cast<int>(err);
}
