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
// top-m under the order above, and the top-m of a row lies inside the union
// of the top-m of any partition of its lanes into chunks.  So this kernel
// selects per chunk and merges the chunks' sorted lists.
//
// The order as one integer: score = (ordered bits of the key) << 32 | ~lane,
// larger = earlier; -0 and +0 get the same bits (they tie, as floats do),
// and 0 marks a masked lane or an empty slot (every valid key is at least
// log(1e-30)/1e-9 ~ -6.9e10, so no valid score is 0).  A warp's argmax of a
// score is two `redux.sync` maxima (high word, then low word among the lanes
// holding it) in place of a five-step shuffle butterfly.
//
// Bound: bytes.  The mask is read whole, w and u only where it is set, 8
// bytes a slot written; a few flops a lane.  The sampler's hop gives one
// launch per padded width, from ~7,000 rows of 8 lanes to one row of
// 131,072, so the launcher (kernels/reservoir/ops.py:layout) picks a layout
// from N, each the fastest of the layouts below on those buckets.  What
// held the first kernel back, and what this one does about it:
//   1. one SM a wide row: a row past 2,048 lanes is cut into P chunks, one
//      block each (chunks of 256..1,024 lanes, 32 a row up to 32,768 lanes,
//      up to 256 past it): the 131,072-lane hub row is 256 blocks.
//      A chunk's block writes its sorted list to scratch; after a
//      __threadfence it takes a ticket from its row's integer counter, and
//      the last block to arrive merges the row's P lists (warp w first
//      merges lists w, w + W, ... past 32 of them) into the output and
//      leaves the counter at 0 (atomicInc wraps).  No float is added
//      atomically.  A row longer than 32*W chunks makes each block walk S
//      sub-chunks, keeping a running list.
//   2. mid widths under-filling the card: a row of 512..2,048 lanes is one
//      block of 8 warps, each warp 32*K lanes of it (K keys a lane in
//      registers); a warp's top-m comes from rounds of the redux argmax
//      (only the winning lane rescans its K keys), and warp 0 merges the
//      warps' sorted lists, one a lane, by the same rounds over list heads.
//      Up to 256 lanes a row is one warp (K = 2, 4 or 8).
//   3. narrow rows wasting the warp: rows of N <= 32 are segments of S =
//      2^k >= N lanes of a warp, one lane a key; each lane's rank in its
//      segment comes from S width-S shuffles (no rounds), and the lane of
//      rank r < m writes slot r.
//   4. masked lanes read: all K mask loads are issued first, then the w
//      and u loads of the set lanes only (predicated `ld.global.nc`), so a
//      masked lane costs its mask byte and a thread has up to 3K loads in
//      flight, not 4.
// Lists of a block live in shared memory, or in global scratch when m makes
// them too long for it.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u32 = unsigned;
using u64 = unsigned long long;

constexpr float kNeg = -3.0e38f;    // the exhausted key of the JAX kernel
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrowThreads = 256;
constexpr int kMaxWarps = 8;        // warps of a chunked block
constexpr int kArenaSmemBytes = 48 * 1024;

struct __align__(8) Rec {
  float key;
  int col;
};

__device__ __forceinline__ Rec empty_rec() { return {-INFINITY, INT_MAX}; }

// key bits in an order that unsigned compares follow; -0 counts as +0
__device__ __forceinline__ u32 order_bits(float k) {
  u32 b = __float_as_uint(k);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ u64 score_of(float k, int col) {
  return k == -INFINITY
             ? 0ull
             : (static_cast<u64>(order_bits(k)) << 32) | static_cast<u32>(~col);
}

__device__ __forceinline__ u64 warp_max(u64 s) {
  const u32 hi = __reduce_max_sync(kFull, static_cast<u32>(s >> 32));
  const u32 lo = __reduce_max_sync(
      kFull, static_cast<u32>(s >> 32) == hi ? static_cast<u32>(s) : 0u);
  return (static_cast<u64>(hi) << 32) | lo;
}

__device__ __forceinline__ float lane_key(float w, float u) {
  return logf(fmaxf(u, 1e-30f)) / fmaxf(w, 1e-9f);
}

// predicated read-only loads in inline asm: issued where they stand, so a
// thread's loads are all in flight before the first key needs one; 0 where
// `on` is false (the address is then never touched)
__device__ __forceinline__ float load_f32_if(const float* p, bool on) {
  float x = 0.f;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p ld.global.nc.f32 %0, [%2];\n}\n"
      : "+f"(x)
      : "r"(static_cast<int>(on)), "l"(p));
  return x;
}

__device__ __forceinline__ u32 load_mask_if(const uint8_t* p, bool on) {
  u32 x = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p ld.global.nc.u8 %0, [%2];\n}\n"
      : "+r"(x)
      : "r"(static_cast<int>(on)), "l"(p));
  return x;
}

__device__ __forceinline__ u32 load_mask_if(const int32_t* p, bool on) {
  u32 x = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p ld.global.nc.u32 %0, [%2];\n}\n"
      : "+r"(x)
      : "r"(static_cast<int>(on)), "l"(p));
  return x;
}

// a list record; `cg` reads another block's scratch at L2 (never a stale L1)
__device__ __forceinline__ Rec load_rec(const Rec* p, bool cg) {
  if (cg) {
    const int2 v = __ldcg(reinterpret_cast<const int2*>(p));
    return {__int_as_float(v.x), v.y};
  }
  return *p;
}

// Where a warp's selected records go, slot r in order.  `end(r)`, called by
// every lane of the warp once r slots are written, closes the output.
struct ListSink {  // a list of `cap` records, ended by an empty record
  Rec* p;
  int cap;
  __device__ void put(int r, float k, int c) const { p[r] = {k, c}; }
  __device__ void end(int r) const {
    if (r < cap && (threadIdx.x & 31) == 0) p[r] = empty_rec();
  }
};

struct OutSink {  // one row of the outputs; slots past r are exhausted
  int32_t* idx;
  float* key;
  int m, n;
  __device__ void put(int r, float k, int c) const {
    idx[r] = c;
    key[r] = k;
  }
  __device__ void end(int r) const {
    for (int t = r + (threadIdx.x & 31); t < m; t += 32) {
      idx[t] = n;
      key[t] = kNeg;
    }
  }
};

// The first `limit` of the warp's 32*K register keys, in order.  Only the
// lane holding a round's winner rescans its keys.
template <int K, class Sink>
__device__ void warp_select(u64 (&sc)[K], const float (&kf)[K], int limit,
                            const Sink& out) {
  u64 best = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) best = sc[k] > best ? sc[k] : best;
  int r = 0;
  for (; r < limit; ++r) {
    const u64 win = warp_max(best);
    if (win == 0) break;  // no valid key left: uniform across the warp
    if (best == win) {
      float kk = 0.f;
      best = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (sc[k] == win) {
          kk = kf[k];
          sc[k] = 0;
        }
        best = sc[k] > best ? sc[k] : best;
      }
      out.put(r, kk, static_cast<int>(~static_cast<u32>(win)));
    }
  }
  out.end(r);
}

// The first `limit` records of up to 32 sorted lists, lane i owning the
// list at p (cap records, ended early by an empty record; cap 0 = none).
// Each lane holds its head and the record after it, so a lane that wins
// twice in a row finds its next head already loaded.
template <class Sink>
__device__ void warp_merge(const Rec* p, int cap, bool cg, int limit,
                           const Sink& out) {
  Rec h = cap > 0 ? load_rec(p, cg) : empty_rec();
  Rec nx = cap > 1 ? load_rec(p + 1, cg) : empty_rec();
  int at = 1;  // the index of nx
  u64 best = score_of(h.key, h.col);
  int r = 0;
  for (; r < limit; ++r) {
    const u64 win = warp_max(best);
    if (win == 0) break;
    if (best == win) {
      out.put(r, h.key, h.col);
      h = nx;
      ++at;
      nx = at < cap ? load_rec(p + at, cg) : empty_rec();
      best = score_of(h.key, h.col);
    }
  }
  out.end(r);
}

// -- N <= 32: rows as segments of S lanes, a lane's rank from S shuffles -----
template <int S, typename MaskT>
__global__ void __launch_bounds__(kNarrowThreads)
topm_narrow_kernel(const float* __restrict__ w, const float* __restrict__ u,
                   const MaskT* __restrict__ mask, int32_t* __restrict__ out_idx,
                   float* __restrict__ out_key, int64_t rows, int n, int m) {
  constexpr int kRowsPerWarp = 32 / S;
  const int lane = threadIdx.x & 31, j = lane & (S - 1), seg = lane / S;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * (kNarrowThreads / 32) +
       (threadIdx.x >> 5)) * kRowsPerWarp + seg;
  const int64_t at = row * n + j;
  const bool valid = load_mask_if(mask + at, row < rows && j < n) != 0;
  const float wv = load_f32_if(w + at, valid);
  const float uv = load_f32_if(u + at, valid);
  const float k = valid ? lane_key(wv, uv) : -INFINITY;
  const u32 ob = valid ? order_bits(k) : 0u;  // every valid lane's is > 0
  int rank = 0;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const u32 o = __shfl_sync(kFull, ob, t, S);
    rank += (o > ob) || (o == ob && t < j);
  }
  const u32 seg_bits = S == 32 ? kFull : ((1u << S) - 1u) << (seg * S);
  const int n_valid = __popc(__ballot_sync(kFull, valid) & seg_bits);
  if (row >= rows) return;
  int32_t* idx = out_idx + row * m;
  float* key = out_key + row * m;
  if (valid && rank < m) {
    idx[rank] = j;
    key[rank] = k;
  }
  for (int t = n_valid + j; t < m; t += S) {
    idx[t] = n;
    key[t] = kNeg;
  }
}

// -- N > 32: a block of W warps a chunk, P chunks a row ----------------------
struct Chunked {
  int K, W, P, S;     // keys a lane, warps a block, chunks a row, sub-chunks
  int lw, lb, lf;     // list lengths: a warp's, a chunk's, a merge warp's
  int64_t arena;      // list records a block keeps
  bool arena_global;  // the block's lists in scratch, not shared memory
  int64_t blocks;
  int64_t list_recs;  // chunk lists in scratch (P > 1)
};

template <int K, typename MaskT>
__global__ void __launch_bounds__(32 * kMaxWarps)
topm_chunk_kernel(const float* __restrict__ w, const float* __restrict__ u,
                  const MaskT* __restrict__ mask, int32_t* __restrict__ out_idx,
                  float* __restrict__ out_key, int n, int m, int P, int S,
                  int lw, int lb, int lf, Rec* __restrict__ lists,
                  unsigned* __restrict__ counters, Rec* __restrict__ arena_g,
                  int64_t arena) {
  extern __shared__ Rec smem[];
  __shared__ int is_last;
  const int W = blockDim.x >> 5, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x / P;
  const int c = static_cast<int>(blockIdx.x % P);
  const float* wr = w + row * n;
  const float* ur = u + row * n;
  const MaskT* mr = mask + row * n;
  const OutSink out{out_idx + row * m, out_key + row * m, m, n};
  Rec* a = arena_g ? arena_g + blockIdx.x * arena : smem;
  Rec* wl = a;               // W lists of lw: each warp's sub-chunk
  Rec* bl = wl + W * lw;     // 2 lists of lb: the running list (S > 1)
  Rec* fl = bl + (S > 1 ? 2 * lb : 0);  // W lists of lf: the final merge
  Rec* mine = lists + (row * P + c) * lb;
  const int64_t span = static_cast<int64_t>(S) * W * 32 * K;

  for (int s = 0; s < S; ++s) {
    const int64_t base =
        c * span + (static_cast<int64_t>(s) * W + warp) * 32 * K + lane;
    u32 mk[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      mk[k] = load_mask_if(mr + base + 32 * k, base + 32 * k < n);
    float wk[K], uk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wk[k] = load_f32_if(wr + base + 32 * k, mk[k] != 0);
      uk[k] = load_f32_if(ur + base + 32 * k, mk[k] != 0);
    }
    u64 sc[K];
    float kf[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      kf[k] = mk[k] != 0 ? lane_key(wk[k], uk[k]) : -INFINITY;
      sc[k] = score_of(kf[k], static_cast<int>(base + 32 * k));
    }
    if (P == 1 && S == 1 && W == 1) {  // a warp owns the row
      warp_select(sc, kf, m, out);
      return;
    }
    warp_select(sc, kf, lw, ListSink{wl + warp * lw, lw});
    __syncthreads();
    if (warp == 0) {  // W warp lists and the running list, one a lane
      const bool more = s > 0 && lane == W;
      const Rec* src = more ? bl + ((s - 1) & 1) * lb : wl + lane * lw;
      const int cap = more ? lb : (lane < W ? lw : 0);
      if (s + 1 < S)
        warp_merge(src, cap, false, lb, ListSink{bl + (s & 1) * lb, lb});
      else if (P == 1)
        warp_merge(src, cap, false, m, out);
      else
        warp_merge(src, cap, false, lb, ListSink{mine, lb});
    }
    __syncthreads();
  }
  if (P == 1) return;

  // the last of the row's P blocks to arrive merges their lists
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicInc(counters + row, static_cast<unsigned>(P - 1)) ==
              static_cast<unsigned>(P - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const Rec* row_lists = lists + row * P * lb;
  if (P <= 32) {
    if (warp == 0)
      warp_merge(row_lists + lane * lb, lane < P ? lb : 0, true, m, out);
    return;
  }
  const int li = warp + W * lane;  // warp w merges lists w, w + W, ...
  warp_merge(row_lists + static_cast<int64_t>(li) * lb, li < P ? lb : 0, true,
             lf, ListSink{fl + warp * lf, lf});
  __syncthreads();
  if (warp == 0) warp_merge(fl + lane * lf, lane < W ? lf : 0, false, m, out);
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The chunked layout for (K, W, P, S) from the launcher, or false when it
// does not cover the row exactly once.
bool chunked(int64_t rows, int n, int m, int K, int W, int P, int S,
             Chunked* c) {
  if (!(K == 1 || K == 2 || K == 4 || K == 8) || W < 1 || W > kMaxWarps ||
      P < 1 || S < 1 || P > 32 * W)
    return false;
  const int64_t span = static_cast<int64_t>(S) * W * 32 * K;
  if ((P - 1) * span >= n || P * span < n) return false;
  c->K = K, c->W = W, c->P = P, c->S = S;
  c->lw = static_cast<int>(std::min<int64_t>(m, 32 * K));
  c->lb = static_cast<int>(std::min<int64_t>(m, span));
  c->lf = static_cast<int>(std::min<int64_t>(m, 32 * static_cast<int64_t>(c->lb)));
  c->arena = (W == 1 && P == 1 && S == 1)  // a warp a row keeps no list
                 ? 0
                 : static_cast<int64_t>(W) * c->lw + (S > 1 ? 2 * c->lb : 0) +
                       (P > 32 ? static_cast<int64_t>(W) * c->lf : 0);
  c->arena_global = c->arena * static_cast<int64_t>(sizeof(Rec)) > kArenaSmemBytes;
  c->blocks = rows * P;
  c->list_recs = P > 1 ? rows * P * c->lb : 0;
  return c->blocks <= INT_MAX;
}

template <int K, typename MaskT>
void launch_chunked(const float* w, const float* u, const MaskT* mask,
                    int32_t* idx, float* key, int n, int m, const Chunked& c,
                    void* scratch, unsigned* counters, cudaStream_t s) {
  Rec* lists = static_cast<Rec*>(scratch);
  Rec* arena_g = c.arena_global ? lists + c.list_recs : nullptr;
  const size_t smem = c.arena_global ? 0 : c.arena * sizeof(Rec);
  topm_chunk_kernel<K, MaskT><<<static_cast<unsigned>(c.blocks), 32 * c.W, smem, s>>>(
      w, u, mask, idx, key, n, m, c.P, c.S, c.lw, c.lb, c.lf, lists, counters,
      arena_g, c.arena);
}

template <int S, typename MaskT>
void launch_narrow(const float* w, const float* u, const MaskT* mask,
                   int32_t* idx, float* key, int64_t rows, int n, int m,
                   cudaStream_t s) {
  constexpr int64_t kRowsPerBlock = (kNarrowThreads / 32) * (32 / S);
  topm_narrow_kernel<S, MaskT>
      <<<static_cast<unsigned>(cdiv(rows, kRowsPerBlock)), kNarrowThreads, 0, s>>>(
          w, u, mask, idx, key, rows, n, m);
}

template <typename MaskT>
void launch(const float* w, const float* u, const void* mask, int32_t* idx,
            float* key, int64_t rows, int n, int m, int seg, const Chunked& c,
            void* scratch, unsigned* counters, cudaStream_t s) {
  const auto* mk = static_cast<const MaskT*>(mask);
  switch (seg) {
    case 1: return launch_narrow<1>(w, u, mk, idx, key, rows, n, m, s);
    case 2: return launch_narrow<2>(w, u, mk, idx, key, rows, n, m, s);
    case 4: return launch_narrow<4>(w, u, mk, idx, key, rows, n, m, s);
    case 8: return launch_narrow<8>(w, u, mk, idx, key, rows, n, m, s);
    case 16: return launch_narrow<16>(w, u, mk, idx, key, rows, n, m, s);
    case 32: return launch_narrow<32>(w, u, mk, idx, key, rows, n, m, s);
    default: break;
  }
  switch (c.K) {
    case 1: return launch_chunked<1>(w, u, mk, idx, key, n, m, c, scratch, counters, s);
    case 2: return launch_chunked<2>(w, u, mk, idx, key, n, m, c, scratch, counters, s);
    case 4: return launch_chunked<4>(w, u, mk, idx, key, n, m, c, scratch, counters, s);
    default: return launch_chunked<8>(w, u, mk, idx, key, n, m, c, scratch, counters, s);
  }
}

}  // namespace

// The layout is the launcher's (kernels/reservoir/ops.py:layout): `seg` > 0
// takes the narrow kernel with segments of seg lanes (a power of two, n <=
// seg <= 32); else the chunked kernel with K keys a lane, W warps a block,
// P chunks a row of S sub-chunks each.  Returns the scratch bytes the launch
// needs (chunk lists, and the lists of each block where shared memory is too
// small), or -1 for a layout that does not fit the row.  The launch also
// needs `rows` zeroed unsigned counters when P > 1, which it leaves zeroed.
extern "C" long long reservoir_topm_scratch_bytes(long long rows, int n, int m,
                                                  int seg, int K, int W, int P,
                                                  int S) {
  if (seg > 0)
    return (seg <= 32 && (seg & (seg - 1)) == 0 && n <= seg) ? 0 : -1;
  Chunked c;
  if (!chunked(rows, n, m, K, W, P, S, &c)) return -1;
  return (c.list_recs + (c.arena_global ? c.blocks * c.arena : 0)) *
         static_cast<long long>(sizeof(Rec));
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a layout the function above refuses.  The
// caller has checked the shapes, types and devices: rows >= 1, 1 <= n <=
// 2^30, 1 <= m <= 2^30, every array contiguous; mask_bytes is 1 or 4.  NaN
// in w or u is outside the contract (fmaxf drops it where torch.clamp keeps
// it).
extern "C" int reservoir_topm_launch(const void* w, const void* u, const void* mask,
                                     int mask_bytes, void* idx, void* key,
                                     long long rows, int n, int m, int seg, int K,
                                     int W, int P, int S, void* scratch,
                                     void* counters, void* stream) {
  if (reservoir_topm_scratch_bytes(rows, n, m, seg, K, W, P, S) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Chunked c{};
  if (seg == 0) chunked(rows, n, m, K, W, P, S, &c);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  auto* oi = static_cast<int32_t*>(idx);
  auto* ok = static_cast<float*>(key);
  auto* ctr = static_cast<unsigned*>(counters);
  if (mask_bytes == 4) {
    launch<int32_t>(wf, uf, mask, oi, ok, rows, n, m, seg, c, scratch, ctr, s);
  } else {
    launch<uint8_t>(wf, uf, mask, oi, ok, rows, n, m, seg, c, scratch, ctr, s);
  }
  return static_cast<int>(cudaGetLastError());
}
