// flash_attention_bwd: the gradient of flash_attention (flash_attention.cu),
// for LM training.
//
// No TPU kernel to replace: the JAX package differentiates its jnp
// attention (src/repro/models/layers.py, _attend_seq) and its Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py:60) has no backward.  The
// port's training path runs the forward kernel, so it needs this one.
//
//   q, o, do, dq (B, S, H, Dh), k/v, dk/dv (B, S, Hkv, Dh), lse (B, H, S)
//   f32 (natural log, from the forward), G = H / Hkv, scale = Dh^-1/2:
//   P = exp(S.scale - lse), S = Q.K^T masked (key <= row when causal),
//   D = rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T - D),
//   dQ = dS K . scale, dK = dS^T Q . scale; dK and dV of a kv head sum the
//   G q-heads that read it.
//
// Bound: operations.  The causal backward does 2.5x the forward's FLOP
// (the two products of the forward again, to recompute S and form dP, and
// three more for dV, dK and dQ: 5 products of 2 Dh S(S+1)/2 against the
// forward's 2), on inputs each read once; at llama3.2-3b's prefill shape
// (2, 4096, 24, 8, 128) bf16 that is 5.16e11 FLOP against ~0.2 GB.  Only
// wgmma reaches the card's bf16 rate, so bf16 runs the Hopper kernels below
// (namespace wg); f32 runs the SIMT kernels (no tensor-core type keeps f32).
//
// Shared by both: deterministic and free of float atomics, like the
// neighbor_agg backward: every output element is summed by one thread in a
// fixed order and written once.  Two kernels, launched in this order on the
// caller's stream:
//   dq: one (batch, head) and a tile of query rows.  It forms D from its
//     own O and dO rows (written to a (B, H, S) scratch for the next
//     kernel), then walks the kv tiles (to the diagonal when causal),
//     recomputes P and dP, and accumulates dQ += dS K in registers; dQ is
//     written once.
//   dkv: one (batch, kv head) and a tile of keys.  dK and dV stay in
//     registers while it walks the group's G q-heads in ascending order
//     and, for each, the q tiles (from the diagonal on when causal); they
//     are written once.  GQA is by index: no repeated k/v.
// The price of determinism: S and dP are recomputed in both kernels.  (One
// kernel would sum dQ across key tiles: float atomics, or a
// read-modify-write ordered by semaphores.)
//
// Head widths: templates DH in {16, 32, 64, 128}, given the real dh (a
// multiple of 8 no wider), as the forward: columns dh .. DH-1 read as zeros
// and are never stored.  Rows >= S read as zeros and are masked.
//
// bf16, Hopper (sm_90a): TMA ring, wgmma, warp-specialised consumers.
//   Both kernels are persistent (one block per SM walking its share of the
//   items, heaviest first, in the forward's snake order) with 3 warpgroups:
//   warpgroup 0 is the producer (one thread issues every TMA load),
//   warpgroups 1 and 2 the consumers, 64 rows (dq: query rows; dkv: keys)
//   each.  setmaxnreg splits the block's 384 x 168 registers: dq 40 for the
//   producer and 232 for each consumer; dkv 24 and 240, since its consumers
//   keep dK and dV (Dh f32 a thread) beside a tile's scores and fragments
//   (at 232 they spilled at Dh 128; a producer that also staged the lse and
//   D rows with plain loads spilled at 24 and at 40).  An item's own tiles
//   load once into one slot; the tiles it walks stream through a ring of 3
//   stages.  Each slot has a full and an empty mbarrier: the copies
//   complete the full one by their byte count, and the 256 consumer threads
//   arrive on the empty one once the products that read the slot have
//   completed.  A consumer waits for every full slot, also of a tile it
//   skips, before it releases it: a release must not count toward an
//   earlier phase of the slot.
//   dq: an item is 128 query rows of one head; Q and dO are its tiles, K and
//     V stream in 64-key tiles.  A consumer forms D from global memory (its
//     two rows' columns, then the quad's sums), then per tile:
//       S = Q.K^T and dP = dO.V^T, wgmma m64n64k16 from shared memory (SS),
//         Dh/16 k-steps each;
//       P = exp2(S scale log2 e - lse log2 e) by ex2.approx, 0 where
//         masked, and dS = P (dP - D), in registers;
//       dS in bf16 in the accumulator's layout, which is the A fragment
//         layout of m64nNk16, and dQ += dS.K by wgmma m64nDHk16 with A from
//         registers (RS) and K read MN-major through the descriptor's
//         transpose bit.
//     As the forward pipelines its tiles, S and dP of tile t are issued
//     with dQ's product of tile t-1, and dS(t) is formed while that product
//     runs (wait_group 1, then 0).  Under causal masking the tile past
//     consumer 0's diagonal is consumer 1's alone.  Shared memory at Dh 128:
//     Q and dO 2 x 32 KB, the ring 3 x 32 KB: 161 KB.
//   dkv: an item is 128 keys of one kv head; K and V are its tiles, and the
//     producer streams the Q and dO tiles of 64 rows with their lse and D
//     rows over the group's G q-heads, the q tiles from the diagonal on.
//     Per tile a consumer computes S^T = K.Q^T and dP^T = V.dO^T (SS,
//     m64n64), P^T and dS^T in registers, and dV += P^T.dO and dK += dS^T.Q
//     (RS, m64nDH), Q and dO read MN-major from the same TMA tiles; dV's
//     products run while dS^T is converted.  Under causal masking the first
//     q tile is consumer 0's alone.  dK and dV stay in registers over the
//     walk.  The lse and D rows come by 1-D tensor maps over the flat
//     (B, H, S) arrays; a 1-D copy must start 16-byte aligned (one from row
//     37 faulted on the card), so a tile's rows load as the 68 rows from its
//     first row rounded down to a multiple of 4, read from that offset.
//     Shared memory at Dh 128: K and V 2 x 32 KB, the ring 3 x 32.75 KB.
//   Item counts: at (2, 4096, 24, 8, 128) 1,536 dq and 512 dkv items; at the
//   train step's (8, 128, 24, 8, 128) 192 and 64, against 132 SMs.
//   Rounding: P and dS enter their products as two bf16 halves, hi =
//   bf16(x) and lo = bf16(x - hi), each product run with hi and then lo;
//   every sum is f32 and each output is rounded to bf16 once.  With P and dS
//   rounded once to bf16 (as the forward rounds P) the gradients missed the
//   check that holds them to twice the plain version's own error against
//   f64: dK by 1.57x at (2, 1500, 4, 4, 64) full on the card, where a CPU
//   emulation of that rounding gave 1.535x (and 1.018x on dQ at
//   (1, 257, 8, 2, 112)): one dominant term's rounding is as large as the
//   output's own.  The halves cost three more products per pair of tiles:
//   10 where the work is 5 (dq 2 SS + 2 RS, dkv 2 SS + 4 RS; 7 without
//   them), so the design reaches at most half of the bound.
//   Descriptors, swizzle and fences follow the forward (flash_attention.cu
//   notes 2-5; the helpers are hopper.cuh's).  A 64-row box wholly past S
//   is not loaded (its rows are never read: the consumer that owns them
//   skips every tile).
//
// f32 (SIMT, per-thread FMA): thread (ty, tx) of 16 x 16 owns rows
// 4 ty .. 4 ty + 3 of a 64 x 64 score tile against columns tx + 16 j, and
// rows 4 ty .. of the output against columns tx + 16 c, over tiles of 64
// rows; grid (B*H, S/64) for dq, (B*Hkv, S/64) for dkv.  Tiles are staged in
// shared memory as f32, rows padded by 4 floats and read as float4.  Shared
// memory at Dh = 128: 150 KB (dq) and 167 KB (dkv), one block per SM.
// Registers: the launch bounds ask for one block of 256 threads per SM (up
// to 255 registers a thread), and the loops over the head width and over a
// tile's 64 rows are not unrolled (their bodies are): with ptxas's own
// choices the dkv kernels spilled, at Dh 32 and 64 when it aimed at two
// blocks (128 registers), at Dh 16 when it unrolled into 255 (chip_smoke.py
// phase 1 fails on a spill).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPLD = kT + 4;    // row stride (floats) of a staged score tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DH>
struct Lay {
  static constexpr int LD = DH + 4;       // row stride (floats) of a staged tile
  static constexpr int TILE = kT * LD;    // floats of one staged tile
  static constexpr int NC = DH / 16;      // output columns of a thread: tx + 16 c
  static constexpr int DQ_SMEM = (4 * TILE + kT * kPLD + 2 * kT) * 4;
  static constexpr int DKV_SMEM = (4 * TILE + 2 * kT * kPLD + 2 * kT) * 4;
};

// rows s0 .. s0 + 63 of one head of a (B, S, heads, dh) tensor, as f32, into
// shared memory [kT][DH + 4]; rows >= S and columns >= dh read as zeros
template <int DH, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int64_t row_stride,
                                      int s0, int S, int dh) {
  for (int e = threadIdx.x; e < kT * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    float x = 0.f;
    if (s0 + r < S && c < dh) x = to_f32(src[(s0 + r) * row_stride + c]);
    dst[r * Lay<DH>::LD + c] = x;
  }
}

// acc[i][j] = a[4 ty + i] . b[tx + 16 j] over DH columns of two staged tiles
template <int DH>
__device__ __forceinline__ void dots(float (&acc)[4][4], const float* a, const float* b, int ty,
                                     int tx) {
  constexpr int LD = Lay<DH>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int d = 0; d < DH; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

__device__ __forceinline__ float lane(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
             T* __restrict__ dq, float* __restrict__ d_rows, int S, int H, int Hkv, int dh,
             int causal, float scale) {
  using L = Lay<DH>;
  constexpr int LD = L::LD;
  extern __shared__ float4 smem_dq[];
  float* Qs = reinterpret_cast<float*>(smem_dq);
  float* dOs = Qs + L::TILE;
  float* Ks = dOs + L::TILE;
  float* Vs = Ks + L::TILE;
  float* dSs = Vs + L::TILE;     // [kT][kPLD]
  float* lse2 = dSs + kT * kPLD;  // the rows' log-sum-exp in log2 units
  float* Ds = lse2 + kT;          // the rows' D

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;   // causal: the longest rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int64_t qs = static_cast<int64_t>(H) * dh, kvs = static_cast<int64_t>(Hkv) * dh;
  const int64_t qoff = static_cast<int64_t>(b) * S * qs + h * dh;
  const int64_t kvoff = static_cast<int64_t>(b) * S * kvs + hk * dh;
  const float scale_log2 = scale * kLog2e;

  stage<DH>(Qs, q + qoff, qs, q0, S, dh);
  stage<DH>(dOs, dout + qoff, qs, q0, S, dh);
  stage<DH>(Ks, o + qoff, qs, q0, S, dh);   // O, in K's slot until D is formed
  __syncthreads();
  {  // D = rowsum(dO o O): 4 threads a row, each every 4th column, then the quad's sum
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float acc = 0.f;
    for (int c = part; c < DH; c += 4) acc = fmaf(dOs[r * LD + c], Ks[r * LD + c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const int row = q0 + r;
      Ds[r] = acc;
      lse2[r] = row < S ? lse[static_cast<int64_t>(bh) * S + row] * kLog2e : 0.f;
      if (row < S) d_rows[static_cast<int64_t>(bh) * S + row] = acc;
    }
  }

  float acc[4][L::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::NC; ++c) acc[i][c] = 0.f;

  const int n_kv = (S + kT - 1) / kT;
  const int n_tiles = causal ? min(n_kv, q0 / kT + 1) : n_kv;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kT;
    __syncthreads();   // the last tile's K, V and dS (at t = 0: O) are consumed
    stage<DH>(Ks, k + kvoff, kvs, k0, S, dh);
    stage<DH>(Vs, v + kvoff, kvs, k0, S, dh);
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<DH>(s, Qs, Ks, ty, tx);
    dots<DH>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = row < S && key < S && (!causal || key <= row);
        const float p = ok ? exp2f(fmaf(s[i][j], scale_log2, -lse2[r])) : 0.f;
        dSs[r * kPLD + tx + 16 * j] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
    // dQ += dS K: keys in ascending order
#pragma unroll 1
    for (int j = 0; j < kT; j += 4) {
      float4 ds4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds4[i] = *reinterpret_cast<const float4*>(dSs + (4 * ty + i) * kPLD + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* krow = Ks + (j + jj) * LD + tx;
#pragma unroll
        for (int c = 0; c < L::NC; ++c) {
          const float kv = krow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(lane(ds4[i], jj), kv, acc[i][c]);
        }
      }
    }
  }
  T* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < L::NC; ++c)
      if (tx + 16 * c < dh) dqb[row * qs + tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ lse, const T* __restrict__ dout,
              const float* __restrict__ d_rows, T* __restrict__ dk, T* __restrict__ dv, int S,
              int H, int Hkv, int dh, int causal, float scale) {
  using L = Lay<DH>;
  constexpr int LD = L::LD;
  extern __shared__ float4 smem_dkv[];
  float* Ks = reinterpret_cast<float*>(smem_dkv);
  float* Vs = Ks + L::TILE;
  float* Qs = Vs + L::TILE;
  float* dOs = Qs + L::TILE;
  float* Ps = dOs + L::TILE;      // P^T: [keys][queries], kPLD apart
  float* dSs = Ps + kT * kPLD;    // dS^T
  float* lse2 = dSs + kT * kPLD;
  float* Ds = lse2 + kT;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.y * kT;   // causal: the first keys have the most q tiles
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = H / Hkv;
  const int64_t qs = static_cast<int64_t>(H) * dh, kvs = static_cast<int64_t>(Hkv) * dh;
  const int64_t kvoff = static_cast<int64_t>(b) * S * kvs + hk * dh;
  const float scale_log2 = scale * kLog2e;

  stage<DH>(Ks, k + kvoff, kvs, k0, S, dh);
  stage<DH>(Vs, v + kvoff, kvs, k0, S, dh);

  float dk_acc[4][L::NC], dv_acc[4][L::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (S + kT - 1) / kT;
  const int first = causal ? k0 / kT : 0;   // q tiles from the diagonal on
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    const int64_t qoff = static_cast<int64_t>(b) * S * qs + h * dh;
    for (int qt = first; qt < n_q; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();   // the last tile's Q, dO, P and dS are consumed
      stage<DH>(Qs, q + qoff, qs, q0, S, dh);
      stage<DH>(dOs, dout + qoff, qs, q0, S, dh);
      if (threadIdx.x < kT) {
        const int row = q0 + threadIdx.x;
        lse2[threadIdx.x] = row < S ? lse[bh * S + row] * kLog2e : 0.f;
        Ds[threadIdx.x] = row < S ? d_rows[bh * S + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dots<DH>(s, Ks, Qs, ty, tx);     // S^T: keys 4 ty + i against queries tx + 16 j
      dots<DH>(dp, Vs, dOs, ty, tx);   // dP^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i, key = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, row = q0 + c;
          const bool ok = key < S && row < S && (!causal || key <= row);
          const float p = ok ? exp2f(fmaf(s[i][j], scale_log2, -lse2[c])) : 0.f;
          Ps[r * kPLD + c] = p;
          dSs[r * kPLD + c] = p * (dp[i][j] - Ds[c]);
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: queries in ascending order
#pragma unroll 1
      for (int j = 0; j < kT; j += 4) {
        float4 p4[4], ds4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p4[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * kPLD + j);
          ds4[i] = *reinterpret_cast<const float4*>(dSs + (4 * ty + i) * kPLD + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* dorow = dOs + (j + jj) * LD + tx;
          const float* qrow = Qs + (j + jj) * LD + tx;
#pragma unroll
          for (int c = 0; c < L::NC; ++c) {
            const float dov = dorow[16 * c], qv = qrow[16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dv_acc[i][c] = fmaf(lane(p4[i], jj), dov, dv_acc[i][c]);
              dk_acc[i][c] = fmaf(lane(ds4[i], jj), qv, dk_acc[i][c]);
            }
          }
        }
      }
    }
  }
  T* dkb = dk + kvoff;
  T* dvb = dv + kvoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < L::NC; ++c) {
      if (tx + 16 * c >= dh) continue;
      dkb[key * kvs + tx + 16 * c] = from_f32<T>(dk_acc[i][c] * scale);
      dvb[key * kvs + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma (sm_90a)
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kThreads = 384;   // producer + 2 consumer warpgroups
constexpr int kStages = 3;      // ring depth of both kernels
// setmaxnreg budgets (a block's 384 x 168): the dkv consumers keep dK and
// dV (Dh f32) beside the tile's scores and fragments
constexpr int kDqProducerRegs = 40, kDqConsumerRegs = 232;
constexpr int kDkvProducerRegs = 24, kDkvConsumerRegs = 240;
constexpr int kDqRows = 128;    // query rows of a dq item: 2 consumers x 64
constexpr int kDkvKeys = 128;   // keys of a dkv item: 2 consumers x 64
constexpr int kT = 64;          // a consumer's rows; the streamed tiles' rows
// a 1-D copy must start 16-byte aligned: a q tile's lse and D rows load as
// the 68 rows from its first row rounded down to a multiple of 4
constexpr int kRowBox = kT + 4;

// One block's share of n items: rounds of gridDim.x items, the block taking
// position blockIdx.x of even rounds and the mirror position of odd ones (a
// snake), so that the heavy and light ends of each round even out.
__device__ __forceinline__ int rounds(int n) { return (n + gridDim.x - 1) / gridDim.x; }
__device__ __forceinline__ int item_at(int r, int n) {
  const int c = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int i = r * gridDim.x + c;
  return i < n ? i : -1;
}

// The 64-row boxes of a ROWS-row tile from row r0 that hold a row < S (a box
// wholly past S is not loaded: no one reads its rows), and their bytes
template <int ROWS>
__device__ __forceinline__ int boxes(int r0, int S) {
  return min(ROWS / kT, (S - r0 + kT - 1) / kT);
}
template <int DH, int ROWS>
__device__ __forceinline__ uint32_t tile_bytes(int r0, int S) {
  return boxes<ROWS>(r0, S) * (Tile<DH, ROWS>::BYTES / (ROWS / kT));
}

// rows r0 .. r0 + ROWS - 1 of one head into a ROWS-row tile, in boxes of 64
// rows (two boxes stacked lie as one box of 128 rows); rows >= S of a box
// that starts below S are zero-filled
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int r0, int b, int S) {
  using T = Tile<DH, ROWS>;
  const int halves = boxes<ROWS>(r0, S);
#pragma unroll
  for (int c = 0; c < DH / T::BOX_COLS; ++c)
#pragma unroll
    for (int half = 0; half < ROWS / kT; ++half)
      if (half < halves)
        tma_load(dst + c * T::BOX + half * kT * T::SPAN, map, bar, c * T::BOX_COLS, head,
                 r0 + kT * half, b);
}

// K-major operand at rows row0.. of a ROWS-row tile, k-step kk: columns
// 16kk.. of box 16kk / BOX_COLS
template <int DH, int ROWS>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int row0, int kk) {
  using T = Tile<DH, ROWS>;
  return desc(tile + row0 * T::SPAN + (kk * 16 / T::BOX_COLS) * T::BOX +
                  (kk * 16 % T::BOX_COLS) * 2,
              16, 8 * T::SPAN, T::LAYOUT);
}

// MN-major operand (through the transpose bit): rows 16s .. 16s + 15 of a
// ROWS-row tile are the depth of k-step s, its columns the product's N
template <int DH, int ROWS>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int s) {
  using T = Tile<DH, ROWS>;
  return desc(tile + 16 * s * T::SPAN, T::BOX, 8 * T::SPAN, T::LAYOUT);
}

// X (64 x 64 scores, f32) = A.B^T over DH columns, A at rows a0.. of an
// A_ROWS-row tile and B a 64-row tile, both K-major.  The first k-step
// writes X without reading it, so X holds nothing live between tiles.
template <int DH, int A_ROWS>
__device__ __forceinline__ void issue_scores(float (&x)[32], uint32_t a, int a0, uint32_t b) {
  mma_ss_n64_first(x, k_major<DH, A_ROWS>(a, a0, 0), k_major<DH, kT>(b, 0, 0));
#pragma unroll
  for (int kk = 1; kk < DH / 16; ++kk)
    mma_ss_n64(x, k_major<DH, A_ROWS>(a, a0, kk), k_major<DH, kT>(b, 0, kk));
}

// acc (64 x DH) += X (64 x 64) . B, X as its bf16 halves hi and lo (hi's
// k-steps, then lo's), B a 64 x DH tile read MN-major: its 64 rows are the
// product's depth
template <int DH>
__device__ __forceinline__ void issue_acc(float (&acc)[DH / 2], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], uint32_t b) {
#pragma unroll
  for (int s = 0; s < kT / 16; ++s) mma_rs(acc, hi[s], mn_major<DH, kT>(b, s));
#pragma unroll
  for (int s = 0; s < kT / 16; ++s) mma_rs(acc, lo[s], mn_major<DH, kT>(b, s));
}

// The thread's outputs of an accumulator (rows a and b = a + 8, columns
// 8j + col0, + 1) times `mul`, rounded to bf16, into rows of `stride`
// elements; rows >= S and columns >= dh (the template's padding) unstored
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[DH / 2],
                                           float mul, int row_a, int row_b, int S, int dh,
                                           int64_t stride) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (8 * j >= dh) break;
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(out + row_a * stride + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(out + row_b * stride + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// The mbarriers of a kernel: the item's tile pair (full, empty), then the
// ring's full and empty of each stage
struct Bars {
  uint32_t base;
  __device__ uint32_t item_full() const { return base; }
  __device__ uint32_t item_empty() const { return base + 8; }
  __device__ uint32_t full(int s) const { return base + 8 * (2 + s); }
  __device__ uint32_t empty(int s) const { return base + 8 * (2 + kStages + s); }
  static constexpr int BYTES = 8 * (2 + 2 * kStages);
  // one arrival with the byte count (the producer's) on a full one, all
  // 256 consumer threads on an empty one
  __device__ void init() const {
    bar_init(item_full(), 1);
    bar_init(item_empty(), 2 * 128);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// the ring's slot of the n-th streamed tile, and the parities to wait for
__device__ __forceinline__ int slot(int n) { return n % kStages; }
__device__ __forceinline__ uint32_t filled(int n) { return (n / kStages) & 1; }
__device__ __forceinline__ uint32_t freed(int n) { return (n / kStages - 1) & 1; }

// ---- dq: Q and dO of 128 rows an item, K and V streamed 64 keys a tile --

template <int DH>
struct DqSmem {
  using Q = Tile<DH, kDqRows>;
  using KV = Tile<DH, kT>;
  static constexpr int BYTES = 2 * Q::BYTES + 2 * kStages * KV::BYTES + Bars::BYTES + 1024;
  uint32_t q, dout, bars;
  __device__ explicit DqSmem(uint32_t base)
      : q(base), dout(base + Q::BYTES), bars(base + 2 * Q::BYTES + 2 * kStages * KV::BYTES) {}
  __device__ uint32_t k(int s) const { return q + 2 * Q::BYTES + s * KV::BYTES; }
  __device__ uint32_t v(int s) const { return q + 2 * Q::BYTES + (kStages + s) * KV::BYTES; }
};

struct DqItem {
  int q0, b, h, n_tiles;   // n_tiles: the 64-key tiles the item's last row reaches
  __device__ DqItem(int i, int S, int B, int H, int causal) {
    const int nq = (S + kDqRows - 1) / kDqRows;
    q0 = (nq - 1 - i / (B * H)) * kDqRows;   // causal: the longest rows first
    b = i % (B * H) / H;
    h = i % H;
    n_tiles = (S + kT - 1) / kT;
    if (causal) n_tiles = min(n_tiles, (q0 + kDqRows - 1) / kT + 1);
  }
};

template <int DH>
__device__ __forceinline__ void dq_produce(const DqSmem<DH>& sm, const CUtensorMap* tq,
                                           const CUtensorMap* tdo, const CUtensorMap* tk,
                                           const CUtensorMap* tv, int B, int S, int H, int Hkv,
                                           int causal) {
  const Bars bars{sm.bars};
  const int items = (S + kDqRows - 1) / kDqRows * B * H;
  int n = 0, done = 0;   // tiles loaded, items loaded
  for (int r = 0; r < rounds(items); ++r) {
    const int i = item_at(r, items);
    if (i < 0) continue;
    const DqItem w(i, S, B, H, causal);
    const int hk = w.h / (H / Hkv);
    if (done > 0) bar_wait(bars.item_empty(), (done - 1) & 1);
    bar_expect(bars.item_full(), 2 * tile_bytes<DH, kDqRows>(w.q0, S));
    load_tile<DH, kDqRows>(sm.q, tq, bars.item_full(), w.h, w.q0, w.b, S);
    load_tile<DH, kDqRows>(sm.dout, tdo, bars.item_full(), w.h, w.q0, w.b, S);
    for (int t = 0; t < w.n_tiles; ++t, ++n) {
      const int s = slot(n);
      if (n >= kStages) bar_wait(bars.empty(s), freed(n));
      bar_expect(bars.full(s), 2 * DqSmem<DH>::KV::BYTES);
      load_tile<DH, kT>(sm.k(s), tk, bars.full(s), hk, t * kT, w.b, S);
      load_tile<DH, kT>(sm.v(s), tv, bars.full(s), hk, t * kT, w.b, S);
    }
    ++done;
  }
}

// A consumer warpgroup (cw = 0 or 1) owns query rows q0 + 64 cw .. + 63.
// Per 64-key tile: S = Q.K^T and dP = dO.V^T (SS), then in registers
// P = exp2(S scale_log2 - lse log2 e) (0 where masked) and dS = P (dP - D),
// dS rounded to bf16 as the A fragments of dQ += dS.K (RS, K MN-major).
template <int DH>
__device__ __forceinline__ void dq_consume(const DqSmem<DH>& sm, const __nv_bfloat16* __restrict__ o,
                                           const __nv_bfloat16* __restrict__ dout,
                                           const float* __restrict__ lse,
                                           __nv_bfloat16* __restrict__ dq,
                                           float* __restrict__ d_rows, int cw, int tid, int B,
                                           int S, int H, int dh, int causal, float scale) {
  const Bars bars{sm.bars};
  const int warp = tid >> 5, g = (tid & 31) >> 2, key0 = 2 * (tid & 3);
  const float scale_log2 = scale * kLog2e;
  const int64_t stride = static_cast<int64_t>(H) * dh;
  const int items = (S + kDqRows - 1) / kDqRows * B * H;
  float acc[DH / 2];
  int n = 0, item = 0;
  for (int r = 0; r < rounds(items); ++r) {
    const int i = item_at(r, items);
    if (i < 0) continue;
    const DqItem w(i, S, B, H, causal);
    const int rc = w.q0 + kT * cw;                     // this consumer's first row
    const int row_a = rc + 16 * warp + g, row_b = row_a + 8;
    const int64_t bh = static_cast<int64_t>(w.b) * H + w.h;
    const int64_t base = static_cast<int64_t>(w.b) * S * stride + w.h * dh + key0;
    // D = rowsum(dO o O) of the thread's rows: its columns in order, then
    // the quad's four partial sums
    float d_a = 0.f, d_b = 0.f;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (8 * j >= dh) break;
      if (row_a < S) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + base + row_a * stride + 8 * j));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + base + row_a * stride + 8 * j));
        d_a = fmaf(x.y, y.y, fmaf(x.x, y.x, d_a));
      }
      if (row_b < S) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + base + row_b * stride + 8 * j));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + base + row_b * stride + 8 * j));
        d_b = fmaf(x.y, y.y, fmaf(x.x, y.x, d_b));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
      d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
    }
    if (key0 == 0) {
      if (row_a < S) d_rows[bh * S + row_a] = d_a;
      if (row_b < S) d_rows[bh * S + row_b] = d_b;
    }
    const float l_a = row_a < S ? lse[bh * S + row_a] * kLog2e : 0.f;
    const float l_b = row_b < S ? lse[bh * S + row_b] * kLog2e : 0.f;
    // the tiles this consumer's rows reach: none past S, to the diagonal
    // when causal
    const int mine = rc >= S ? 0 : causal ? min(w.n_tiles, rc / kT + 1) : w.n_tiles;
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) acc[x] = 0.f;

    // dS of tile t in place of its dP: P = exp2(S scale_log2 - lse2), 0
    // where masked (only the diagonal and ragged tiles need the test)
    auto grad = [&](const float (&sc)[32], float (&dp)[32], int t) {
      const int k0 = t * kT;
      const bool masked = (causal && k0 + kT - 1 > rc) || k0 + kT > S || rc + kT > S;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e, key = k0 + 8 * j + key0 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          float p = ex2(fmaf(sc[x], scale_log2, -(e < 2 ? l_a : l_b)));
          if (masked && !(key < S && row < S && (!causal || key <= row))) p = 0.f;
          dp[x] = p * (dp[x] - (e < 2 ? d_a : d_b));
        }
    };

    // Tile t's S and dP are issued back to back with tile t-1's dQ product,
    // and dS(t) is formed while that product is still on the tensor cores
    // (wait_group 1, then 0); a slot is released once its dQ product is done.
    bar_wait(bars.item_full(), item & 1);
    const int n0 = n;
    if (mine > 0) {
      float sc[32], dp[32];
      uint32_t ds[4][4], ds_lo[4][4];
      bar_wait(bars.full(slot(n0)), filled(n0));
      mma_fence();
      issue_scores<DH, kDqRows>(sc, sm.q, kT * cw, sm.k(slot(n0)));
      issue_scores<DH, kDqRows>(dp, sm.dout, kT * cw, sm.v(slot(n0)));
      mma_commit();
      mma_wait<0>();
      pin(sc);
      pin(dp);
      grad(sc, dp, 0);
      to_bf16_split<kT>(ds, ds_lo, dp);
      for (int t = 1; t < mine; ++t) {
        const int s = slot(n0 + t), prev = slot(n0 + t - 1);
        bar_wait(bars.full(s), filled(n0 + t));
        mma_fence();
        issue_scores<DH, kDqRows>(sc, sm.q, kT * cw, sm.k(s));
        issue_scores<DH, kDqRows>(dp, sm.dout, kT * cw, sm.v(s));
        mma_commit();
        pin(acc);
        pin(ds);
        pin(ds_lo);
        mma_fence();
        issue_acc<DH>(acc, ds, ds_lo, sm.k(prev));
        mma_commit();
        mma_wait<1>();   // S(t) and dP(t) are done, dQ(t-1) may still run
        pin(sc);
        pin(dp);
        grad(sc, dp, t);
        mma_wait<0>();
        pin(acc);
        pin(ds);
        pin(ds_lo);
        bar_arrive(bars.empty(prev));
        to_bf16_split<kT>(ds, ds_lo, dp);
      }
      const int last = slot(n0 + mine - 1);
      pin(acc);
      pin(ds);
      pin(ds_lo);
      mma_fence();
      issue_acc<DH>(acc, ds, ds_lo, sm.k(last));
      mma_commit();
      mma_wait<0>();
      pin(acc);
      pin(ds);
      pin(ds_lo);
      bar_arrive(bars.empty(last));
    }
    // the tiles past this consumer's rows (the other's diagonal): waited
    // for, then released
    for (int t = mine; t < w.n_tiles; ++t) {
      bar_wait(bars.full(slot(n0 + t)), filled(n0 + t));
      bar_arrive(bars.empty(slot(n0 + t)));
    }
    n = n0 + w.n_tiles;
    bar_arrive(bars.item_empty());
    store_rows<DH>(dq + base, acc, scale, row_a, row_b, S, dh, stride);
    ++item;
  }
}

// The two roles are the two arms of one if/else that never rejoin: ptxas
// then gives each arm its setmaxnreg budget.  Persistent: one block per SM.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                   float* __restrict__ d_rows, int B, int S, int H, int Hkv, int dh, int causal,
                   float scale) {
  extern __shared__ uint8_t smem_dq_wg[];
  const DqSmem<DH> sm((smem_u32(smem_dq_wg) + 1023u) & ~1023u);   // swizzle atoms: 1024 B
  if (threadIdx.x == 0) Bars{sm.bars}.init();
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kDqProducerRegs));
    if (threadIdx.x == 0) dq_produce<DH>(sm, &tq, &tdo, &tk, &tv, B, S, H, Hkv, causal);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kDqConsumerRegs));
    dq_consume<DH>(sm, o, dout, lse, dq, d_rows, wgi - 1, threadIdx.x - 128 * wgi, B, S, H, dh,
                   causal, scale);
  }
}

// ---- dkv: K and V of 128 keys an item, Q, dO, lse and D streamed ---------

template <int DH>
struct DkvSmem {
  using KV = Tile<DH, kDkvKeys>;
  using Q = Tile<DH, kT>;
  static constexpr int ROW_BOX_BYTES = kRowBox * 4;
  static constexpr int ROWS_BYTES = 2 * 384;   // a stage's lse and D boxes of 272 B, 128-byte aligned
  static constexpr int BYTES =
      2 * KV::BYTES + 2 * kStages * Q::BYTES + kStages * ROWS_BYTES + Bars::BYTES + 1024;
  uint32_t k, v, rows, bars;
  uint8_t* gen;   // the generic address of shared byte 0 of the layout
  __device__ DkvSmem(uint32_t base, uint8_t* generic)
      : k(base), v(base + KV::BYTES), rows(base + 2 * KV::BYTES + 2 * kStages * Q::BYTES),
        bars(rows + kStages * ROWS_BYTES), gen(generic) {}
  __device__ uint32_t q(int s) const { return k + 2 * KV::BYTES + s * Q::BYTES; }
  __device__ uint32_t dout(int s) const { return k + 2 * KV::BYTES + (kStages + s) * Q::BYTES; }
  __device__ uint32_t lse(int s) const { return rows + s * ROWS_BYTES; }
  __device__ uint32_t d(int s) const { return lse(s) + ROWS_BYTES / 2; }
  __device__ float* rows_at(uint32_t addr) const {
    return reinterpret_cast<float*>(gen + (addr - k));
  }
};

struct DkvItem {
  int k0, b, hk, first, nq;   // q tiles first .. nq - 1 of each q head of the group
  __device__ DkvItem(int i, int S, int B, int Hkv, int causal) {
    k0 = i / (B * Hkv) * kDkvKeys;   // causal: the first keys have the most q tiles
    b = i % (B * Hkv) / Hkv;
    hk = i % Hkv;
    nq = (S + kT - 1) / kT;
    first = causal ? k0 / kT : 0;
  }
};

// The producer's one thread: per item K and V once their slot is free, then
// per q tile of the walk Q, dO and the tile's lse and D rows (1-D maps over
// the flat (B, H, S) rows, boxes of kRowBox rows from the tile's first row
// rounded down to a multiple of 4; rows of other heads in the box are never
// read, or read for rows >= S, which the mask ignores).
template <int DH>
__device__ __forceinline__ void dkv_produce(const DkvSmem<DH>& sm, const CUtensorMap* tq,
                                            const CUtensorMap* tdo, const CUtensorMap* tk,
                                            const CUtensorMap* tv, const CUtensorMap* tl,
                                            const CUtensorMap* td, int B, int S, int H, int Hkv,
                                            int causal) {
  const Bars bars{sm.bars};
  const int G = H / Hkv, items = (S + kDkvKeys - 1) / kDkvKeys * B * Hkv;
  const int nr = rounds(items);
  int n = 0, done = 0;   // tiles loaded, items loaded
  for (int r = 0; r < nr; ++r) {
    const int i = item_at(r, items);
    if (i < 0) continue;
    const DkvItem w(i, S, B, Hkv, causal);
    if (done > 0) bar_wait(bars.item_empty(), (done - 1) & 1);
    bar_expect(bars.item_full(), 2 * tile_bytes<DH, kDkvKeys>(w.k0, S));
    load_tile<DH, kDkvKeys>(sm.k, tk, bars.item_full(), w.hk, w.k0, w.b, S);
    load_tile<DH, kDkvKeys>(sm.v, tv, bars.item_full(), w.hk, w.k0, w.b, S);
    for (int h = w.hk * G; h < (w.hk + 1) * G; ++h)
      for (int qt = w.first; qt < w.nq; ++qt, ++n) {
        const int s = slot(n);
        if (n >= kStages) bar_wait(bars.empty(s), freed(n));
        bar_expect(bars.full(s), 2 * DkvSmem<DH>::Q::BYTES + 2 * DkvSmem<DH>::ROW_BOX_BYTES);
        load_tile<DH, kT>(sm.q(s), tq, bars.full(s), h, qt * kT, w.b, S);
        load_tile<DH, kT>(sm.dout(s), tdo, bars.full(s), h, qt * kT, w.b, S);
        const int row = ((w.b * H + h) * S + qt * kT) & ~3;   // of the flat (B, H, S) rows
        tma_load_1d(sm.lse(s), tl, bars.full(s), row);
        tma_load_1d(sm.d(s), td, bars.full(s), row);
      }
    ++done;
  }
}

// A consumer warpgroup (cw = 0 or 1) owns keys k0 + 64 cw .. + 63 and keeps
// their dK and dV in f32 registers over the whole walk.  Per q tile:
// S^T = K.Q^T and dP^T = V.dO^T (SS), P^T and dS^T in registers, both
// rounded to bf16 as A fragments of dV += P^T.dO and dK += dS^T.Q (RS, Q and
// dO read MN-major from the same tiles).
template <int DH>
__device__ __forceinline__ void dkv_consume(const DkvSmem<DH>& sm, __nv_bfloat16* __restrict__ dk,
                                            __nv_bfloat16* __restrict__ dv, int cw, int tid,
                                            int B, int S, int H, int Hkv, int dh, int causal,
                                            float scale) {
  const Bars bars{sm.bars};
  const int warp = tid >> 5, g = (tid & 31) >> 2, key0 = 2 * (tid & 3);
  const float scale_log2 = scale * kLog2e;
  const int G = H / Hkv, items = (S + kDkvKeys - 1) / kDkvKeys * B * Hkv;
  const int64_t stride = static_cast<int64_t>(Hkv) * dh;
  float acc_k[DH / 2], acc_v[DH / 2];
  int n = 0, item = 0;
  for (int r = 0; r < rounds(items); ++r) {
    const int i = item_at(r, items);
    if (i < 0) continue;
    const DkvItem w(i, S, B, Hkv, causal);
    const int kc = w.k0 + kT * cw;                     // this consumer's first key
    const int key_a = kc + 16 * warp + g, key_b = key_a + 8;
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) acc_k[x] = acc_v[x] = 0.f;
    bar_wait(bars.item_full(), item & 1);
    for (int h = 0; h < G; ++h)
      for (int qt = w.first; qt < w.nq; ++qt, ++n) {
        const int s = slot(n), q0 = qt * kT;
        bar_wait(bars.full(s), filled(n));
        // the tile reaches these keys: some key < S, and causal, some row
        // at or past them (q tiles start at multiples of 64)
        if (kc < S && (!causal || q0 >= kc)) {
          float st[32], dpt[32];
          uint32_t pf[4][4], pf_lo[4][4], dsf[4][4], dsf_lo[4][4];
          mma_fence();
          issue_scores<DH, kDkvKeys>(st, sm.k, kT * cw, sm.q(s));
          issue_scores<DH, kDkvKeys>(dpt, sm.v, kT * cw, sm.dout(s));
          mma_commit();
          mma_wait<0>();
          pin(st);
          pin(dpt);
          // the tile's rows in the boxes: past the rounding to 4
          const int off = ((w.b * H + w.hk * G + h) * S + q0) & 3;
          const float* lse_rows = sm.rows_at(sm.lse(s)) + off;
          const float* d_rows = sm.rows_at(sm.d(s)) + off;
          const bool masked = (causal && q0 < kc + kT - 1) || q0 + kT > S || kc + kT > S;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l = make_float2(lse_rows[8 * j + key0], lse_rows[8 * j + key0 + 1]);
            const float2 d = make_float2(d_rows[8 * j + key0], d_rows[8 * j + key0 + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = 4 * j + e, row = q0 + 8 * j + key0 + (e & 1);
              const int key = e < 2 ? key_a : key_b;
              float p = ex2(fmaf(st[x], scale_log2, -((e & 1) ? l.y : l.x) * kLog2e));
              if (masked && !(key < S && row < S && (!causal || key <= row))) p = 0.f;
              st[x] = p;
              dpt[x] = p * (dpt[x] - ((e & 1) ? d.y : d.x));
            }
          }
          // dV's products run while dS^T is split
          to_bf16_split<kT>(pf, pf_lo, st);
          pin(acc_v);
          pin(pf);
          pin(pf_lo);
          mma_fence();
          issue_acc<DH>(acc_v, pf, pf_lo, sm.dout(s));
          to_bf16_split<kT>(dsf, dsf_lo, dpt);
          pin(acc_k);
          pin(dsf);
          pin(dsf_lo);
          mma_fence();
          issue_acc<DH>(acc_k, dsf, dsf_lo, sm.q(s));
          mma_commit();
          mma_wait<0>();
          pin(acc_v);
          pin(acc_k);
          pin(pf);
          pin(pf_lo);
          pin(dsf);
          pin(dsf_lo);
        }
        bar_arrive(bars.empty(s));
      }
    bar_arrive(bars.item_empty());
    const int64_t base = static_cast<int64_t>(w.b) * S * stride + w.hk * dh + key0;
    store_rows<DH>(dk + base, acc_k, scale, key_a, key_b, S, dh, stride);
    store_rows<DH>(dv + base, acc_v, 1.f, key_a, key_b, S, dh, stride);
    ++item;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap td,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int S,
                    int H, int Hkv, int dh, int causal, float scale) {
  extern __shared__ uint8_t smem_dkv_wg[];
  const uint32_t raw = smem_u32(smem_dkv_wg), base = (raw + 1023u) & ~1023u;
  const DkvSmem<DH> sm(base, smem_dkv_wg + (base - raw));
  if (threadIdx.x == 0) Bars{sm.bars}.init();
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kDkvProducerRegs));
    if (threadIdx.x == 0)
      dkv_produce<DH>(sm, &tq, &tdo, &tk, &tv, &tl, &td, B, S, H, Hkv, causal);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kDkvConsumerRegs));
    dkv_consume<DH>(sm, dk, dv, wgi - 1, threadIdx.x - 128 * wgi, B, S, H, Hkv, dh, causal,
                    scale);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using hopper::EncodeTiled;
using hopper::grant;
using hopper::kEncodeError;

// one grant per kernel, at its first launch (thread-safe static initialisation)
template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, void* dq, void* dk, void* dv, float* d_rows, int B, int S, int H,
               int Hkv, int dh, int causal, float scale, cudaStream_t stream) {
  using L = Lay<DH>;
  static const cudaError_t g_dq = grant(flash_bwd_dq<DH, float>, L::DQ_SMEM);
  static const cudaError_t g_dkv = grant(flash_bwd_dkv<DH, float>, L::DKV_SMEM);
  if (g_dq != cudaSuccess) return static_cast<int>(g_dq);
  if (g_dkv != cudaSuccess) return static_cast<int>(g_dkv);
  const int tiles = (S + kT - 1) / kT;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  flash_bwd_dq<DH, float><<<dim3(B * H, tiles), kThreads, L::DQ_SMEM, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), lse, dot, static_cast<float*>(dq), d_rows, S, H,
      Hkv, dh, causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv<DH, float><<<dim3(B * Hkv, tiles), kThreads, L::DKV_SMEM, stream>>>(
      qt, kt, vt, lse, dot, d_rows, static_cast<float*>(dk), static_cast<float*>(dv), S, H, Hkv,
      dh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const float* lse,
                 const void* dout, void* dq, void* dk, void* dv, float* d_rows, int B, int S,
                 int H, int Hkv, int dh, int causal, float scale, cudaStream_t stream) {
  static const cudaError_t g_dq = grant(wg::flash_bwd_dq_wgmma<DH>, wg::DqSmem<DH>::BYTES);
  static const cudaError_t g_dkv = grant(wg::flash_bwd_dkv_wgmma<DH>, wg::DkvSmem<DH>::BYTES);
  static const EncodeTiled fn = hopper::encoder();
  if (g_dq != cudaSuccess) return static_cast<int>(g_dq);
  if (g_dkv != cudaSuccess) return static_cast<int>(g_dkv);
  if (fn == nullptr) return kEncodeError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  // boxes of 64 rows for every bf16 tensor (a 128-row tile loads two), and
  // lse and D as flat f32 rows
  CUtensorMap tq, tdo, tk, tv, tl, td;
  const int64_t rows = static_cast<int64_t>(B) * H * S;
  CUresult r = hopper::encode<DH>(fn, &tq, q, dh, H, S, B, wg::kT);
  if (r == CUDA_SUCCESS) r = hopper::encode<DH>(fn, &tdo, dout, dh, H, S, B, wg::kT);
  if (r == CUDA_SUCCESS) r = hopper::encode<DH>(fn, &tk, k, dh, Hkv, S, B, wg::kT);
  if (r == CUDA_SUCCESS) r = hopper::encode<DH>(fn, &tv, v, dh, Hkv, S, B, wg::kT);
  if (r == CUDA_SUCCESS) r = hopper::encode_1d(fn, &tl, lse, rows, wg::kRowBox);
  if (r == CUDA_SUCCESS) r = hopper::encode_1d(fn, &td, d_rows, rows, wg::kRowBox);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int dq_items = (S + wg::kDqRows - 1) / wg::kDqRows * B * H;
  const int dkv_items = (S + wg::kDkvKeys - 1) / wg::kDkvKeys * B * Hkv;
  const int dq_grid = dq_items < sms ? dq_items : sms;
  const int dkv_grid = dkv_items < sms ? dkv_items : sms;
  const auto* ot = static_cast<const __nv_bfloat16*>(o);
  const auto* dot = static_cast<const __nv_bfloat16*>(dout);
  wg::flash_bwd_dq_wgmma<DH><<<dq_grid, wg::kThreads, wg::DqSmem<DH>::BYTES, stream>>>(
      tq, tdo, tk, tv, ot, dot, lse, static_cast<__nv_bfloat16*>(dq), d_rows, B, S, H, Hkv, dh,
      causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wg::flash_bwd_dkv_wgmma<DH>
      <<<dkv_grid, wg::kThreads, wg::DkvSmem<DH>::BYTES, stream>>>(
          tq, tdo, tk, tv, tl, td, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), B, S, H, Hkv, dh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int dispatch(bool bf16, const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, void* dq, void* dk, void* dv, float* d_rows,
             int B, int S, int H, int Hkv, int dh, int causal, float scale, cudaStream_t stream) {
  if (bf16)
    return launch_wgmma<DH>(q, k, v, o, lse, dout, dq, dk, dv, d_rows, B, S, H, Hkv, dh, causal,
                            scale, stream);
  return launch_f32<DH>(q, k, v, o, lse, dout, dq, dk, dv, d_rows, B, S, H, Hkv, dh, causal,
                        scale, stream);
}

template <int DH>
int smem_bytes(int kernel) {
  switch (kernel) {
    case 0: return Lay<DH>::DQ_SMEM;
    case 1: return Lay<DH>::DKV_SMEM;
    case 2: return wg::DqSmem<DH>::BYTES;
    case 3: return wg::DkvSmem<DH>::BYTES;
    default: return 0;
  }
}

}  // namespace

// Returns 0 when both kernels were launched, else the CUDA error of the
// launch, or kEncodeError (100000) + the CUresult of a failed tensor-map
// encode (bf16).  The caller (ops.py, flash_attention_bwd) has checked
// shapes, types, devices, contiguity and 16-byte alignment, allocated dq,
// dk, dv and the (B, H, S) f32 scratch d_rows, and names the template (16,
// 32, 64 or 128) that runs head_dim, a multiple of 8 no wider.  scale is
// head_dim^-1/2.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const float* lse, const void* dout,
                                          void* dq, void* dk, void* dv, float* d_rows, int batch,
                                          int seq, int heads, int kv_heads, int head_dim,
                                          int width, int bf16, int causal, float scale,
                                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int d = head_dim;
  if (d < 8 || d % 8 != 0 || d > width || seq < 1 || kv_heads < 1 || heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (width) {
    case 16: return dispatch<16>(bf16, q, k, v, o, lse, dout, dq, dk, dv, d_rows, batch, seq, heads, kv_heads, d, causal, scale, s);
    case 32: return dispatch<32>(bf16, q, k, v, o, lse, dout, dq, dk, dv, d_rows, batch, seq, heads, kv_heads, d, causal, scale, s);
    case 64: return dispatch<64>(bf16, q, k, v, o, lse, dout, dq, dk, dv, d_rows, batch, seq, heads, kv_heads, d, causal, scale, s);
    case 128: return dispatch<128>(bf16, q, k, v, o, lse, dout, dq, dk, dv, d_rows, batch, seq, heads, kv_heads, d, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of a block of the template of this width (bytes):
// kernel 0 the f32 dq kernel, 1 the f32 dkv kernel, 2 the bf16 dq kernel,
// 3 the bf16 dkv kernel; 0 for no template.  ptxas reports static shared
// memory only.
extern "C" int flash_attention_bwd_smem_bytes(int width, int kernel) {
  switch (width) {
    case 16: return smem_bytes<16>(kernel);
    case 32: return smem_bytes<32>(kernel);
    case 64: return smem_bytes<64>(kernel);
    case 128: return smem_bytes<128>(kernel);
    default: return 0;
  }
}
