// flash_attention: blockwise self-attention forward with an online softmax,
// for the block prefill of the dense LMs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (_flash_kernel).
//
//   q (B, S, H, Dh), k/v (B, S, Hkv, Dh), H % Hkv == 0, row-major
//   o[b,i,h] = sum_j softmax_j(q[b,i,h] . k[b,j,h/G] * Dh^-1/2) v[b,j,h/G]
//   over j <= i when causal, else over every j < S; G = H / Hkv
//
// Bound: operations.  The causal prefill does 4 Dh S(S+1)/2 FLOP per
// (batch, head) and reads each input once: at the qwen3-4b prefill
// (B=2, S=4096, H=32, Hkv=8, Dh=128, bf16) that is 275 GFLOP against
// 168 MB, some 1,600 FLOP per byte, far above the card's ~295.
//
// Design, shared by both kernels.  One thread block owns one (batch, head)
// and a tile of 64 query rows, and walks the key/value tiles of its kv head
// in order, so the Pallas kernel's sequential KV loop stays a loop inside
// the block.  Heads index the (B, S, H, Dh) strides directly: no transposes
// and no repeated kv (the G q-heads of one kv head read the same tiles,
// which L2 serves).  The running max, sum and accumulator stay in f32
// registers; the scores are scaled into the log2 domain and exponentiated
// with exp2f.  Masked scores are set to -1e30, the value of the JAX kernel,
// so a row that no key reaches stays finite, as in the plain version.  Causal
// tiles past the block's last row are skipped by the loop bound; the
// diagonal tile and a ragged last tile (keys >= S, rows >= S) are masked,
// and rows >= S are never stored.  Query blocks are issued heaviest first.
// The output is divided by max(l, 1e-30) and written once.
//
//   bf16 inputs: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//     accumulate).  4 warps x 16 query rows; K/V tiles of 64 keys staged
//     in shared memory with 16-byte loads (rows padded by 8 elements so the
//     fragment loads meet 32 distinct banks).  Q fragments stay in
//     registers for the whole loop; the probabilities go from the score
//     accumulators to the A fragments of P.V without shared memory, rounded
//     to bf16 as the JAX model rounds them before its P.V product.  52 KB
//     of shared memory at Dh=128.
//   f32 inputs: per-thread f32 FMA (no tensor-core type keeps f32
//     exactly).  256 threads, each owning 4 query rows x 2 keys of a
//     64 x 32 score tile and 4 rows x Dh/16 columns of the output; Q, K, V
//     and P staged in shared memory as f32 (rows padded by 4 floats), read
//     as float4.  77 KB of shared memory at Dh=128.
//
// No cp.async, TMA or wgmma yet: the loads of a tile and its products do not
// overlap.  Making the kernel fast is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;   // query rows per block (both kernels)

__device__ __forceinline__ int tile_count(int S, int q0, int bk, int causal) {
  const int n = (S + bk - 1) / bk;
  if (!causal) return n;
  const int last = (q0 + kBQ - 1) / bk + 1;
  return last < n ? last : n;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBK = 64;
constexpr int kThreads = 128;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
constexpr int smem_bytes() { return (kBQ + 2 * kBK) * (DH + 8) * 2; }

// rows [s0, s0 + rows) of one head into a tile of stride LD; rows >= S zero
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t row_stride, int s0, int rows, int S) {
  constexpr int LD = DH + 8, VEC = DH / 8;
  for (int e = threadIdx.x; e < rows * VEC; e += kThreads) {
    const int r = e / VEC, c = e % VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (s0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int S, int H, int Hkv, int causal, float scale_log2) {
  constexpr int LD = DH + 8;     // smem row stride (elements): 16-byte rows, bank skew
  constexpr int KS = DH / 16;    // k-steps of Q.K^T
  constexpr int NT = kBK / 8;    // 8-key n-tiles of the score tile
  constexpr int DT = DH / 8;     // 8-column n-tiles of the output
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * DH;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * DH;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * S * q_stride + h * DH;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * S * kv_stride + hk * DH;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * S * kv_stride + hk * DH;
  __nv_bfloat16* ob = o + static_cast<int64_t>(b) * S * q_stride + h * DH;

  load_tile<DH>(Qs, qb, q_stride, q0, kBQ, S);
  __syncthreads();
  const int r0 = warp * 16 + g;   // this thread's rows in the tile: r0, r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* p = Qs + r0 * LD + kk * 16 + 2 * tq;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }
  const int row0 = q0 + r0, row1 = row0 + 8;

  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int n_tiles = tile_count(S, q0, kBK, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();               // the previous tile is consumed
    load_tile<DH>(Ks, kb, kv_stride, k0, kBK, S);
    load_tile<DH>(Vs, vb, kv_stride, k0, kBK, S);
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* p = Ks + (j * 8 + g) * LD + kk * 16 + 2 * tq;
        mma(sc[j], qf[kk], ld32(p), ld32(p + 8));
      }
    }
    // scale, mask, row max (the 4 lanes of a group hold one row pair)
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tq + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool ok = key < S && (!causal || key <= row);
        sc[j][e] = ok ? sc[j][e] * scale_log2 : kNeg;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mn0);
      sc[j][1] = exp2f(sc[j][1] - mn0);
      sc[j][2] = exp2f(sc[j][2] - mn1);
      sc[j][3] = exp2f(sc[j][3] - mn1);
      s0 += sc[j][0] + sc[j][1];
      s1 += sc[j][2] + sc[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= a0;
      acc[d][1] *= a0;
      acc[d][2] *= a1;
      acc[d][3] *= a1;
    }
    // P.V: the score accumulators of n-tiles 2s, 2s+1 are the A fragment of
    // k-step s; V's B fragments pair two keys of one column
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      const uint32_t pa[4] = {pack(sc[2 * s][0], sc[2 * s][1]),
                              pack(sc[2 * s][2], sc[2 * s][3]),
                              pack(sc[2 * s + 1][0], sc[2 * s + 1][1]),
                              pack(sc[2 * s + 1][2], sc[2 * s + 1][3])};
      const __nv_bfloat16* vr = Vs + (s * 16 + 2 * tq) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* p = vr + d * 8;
        mma(acc[d], pa, pack(p[0], p[LD]), pack(p[8 * LD], p[9 * LD]));
      }
    }
  }
  const float i0 = fmaxf(l0, 1e-30f), i1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * tq;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_stride + col) =
          __floats2bfloat162_rn(acc[d][0] / i0, acc[d][1] / i0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * q_stride + col) =
          __floats2bfloat162_rn(acc[d][2] / i1, acc[d][3] / i1);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: per-thread FMA
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kPLD = kBK + 4;   // P tile row stride (floats)

template <int DH>
constexpr int smem_bytes() { return ((kBQ + 2 * kBK) * (DH + 4) + kBQ * kPLD) * 4; }

template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row_stride,
                                          int s0, int rows, int S) {
  constexpr int LD = DH + 4, VEC = DH / 4;
  for (int e = threadIdx.x; e < rows * VEC; e += kThreads) {
    const int r = e / VEC, c = e % VEC;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (s0 + r) * row_stride + c * 4);
    *reinterpret_cast<float4*>(dst + r * LD + c * 4) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              int S, int H, int Hkv, int causal, float scale_log2) {
  constexpr int LD = DH + 4;     // smem row stride (floats): 16-byte rows, bank skew
  constexpr int NC = DH / 16;    // output columns per thread: tx + 16 c
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;   // rows 4 ty .. 4 ty + 3
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * DH;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * DH;
  const float* qb = q + static_cast<int64_t>(b) * S * q_stride + h * DH;
  const float* kb = k + static_cast<int64_t>(b) * S * kv_stride + hk * DH;
  const float* vb = v + static_cast<int64_t>(b) * S * kv_stride + hk * DH;
  float* ob = o + static_cast<int64_t>(b) * S * q_stride + h * DH;

  load_tile<DH>(Qs, qb, q_stride, q0, kBQ, S);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = tile_count(S, q0, kBK, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();               // the previous tile's K, V and P are consumed
    load_tile<DH>(Ks, kb, kv_stride, k0, kBK, S);
    load_tile<DH>(Vs, vb, kv_stride, k0, kBK, S);
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = sc[i][j];
          s = fmaf(qv[i].x, kv[j].x, s);
          s = fmaf(qv[i].y, kv[j].y, s);
          s = fmaf(qv[i].z, kv[j].z, s);
          s = fmaf(qv[i].w, kv[j].w, s);
          sc[i][j] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = key < S && (!causal || key <= row);
        sc[i][j] = ok ? sc[i][j] * scale_log2 : kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)      // the 16 lanes of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = exp2f(sc[i][j] - mn);
        Ps[(ty * 4 + i) * kPLD + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();               // P complete
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kPLD + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * LD + tx;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = vrow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][c] = fmaf(p, vv, acc[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[row * q_stride + tx + 16 * c] = acc[i][c] / lm;
  }
}

}  // namespace simt

template <typename Kernel>
cudaError_t grant(Kernel kernel, int smem) {
  // above 48 KB a block's shared memory must be granted explicitly
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, typename Kernel>
int launch(cudaError_t granted, Kernel kernel, int smem, int threads, const void* q,
           const void* k, const void* v, void* o, int B, int S, int H, int Hkv, int causal,
           float scale_log2, cudaStream_t stream) {
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// one grant per kernel, at its first launch (thread-safe static initialisation)
template <int DH>
int dispatch(bool bf16, const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int causal, float scale_log2, cudaStream_t stream) {
  if (bf16) {
    static const cudaError_t granted = grant(tc::flash_fwd_bf16<DH>, tc::smem_bytes<DH>());
    return launch<__nv_bfloat16>(granted, tc::flash_fwd_bf16<DH>, tc::smem_bytes<DH>(),
                                 tc::kThreads, q, k, v, o, B, S, H, Hkv, causal,
                                 scale_log2, stream);
  }
  static const cudaError_t granted = grant(simt::flash_fwd_f32<DH>, simt::smem_bytes<DH>());
  return launch<float>(granted, simt::flash_fwd_f32<DH>, simt::smem_bytes<DH>(),
                       simt::kThreads, q, k, v, o, B, S, H, Hkv, causal, scale_log2,
                       stream);
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched).  The caller has
// checked shapes, types, devices, contiguity and 16-byte alignment;
// head_dim is 16, 32, 64 or 128 and B * H <= 65535.  scale_log2 is
// head_dim^-1/2 * log2(e).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int batch, int seq, int heads, int kv_heads,
                                      int head_dim, int bf16, int causal, float scale_log2,
                                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return dispatch<16>(bf16, q, k, v, o, batch, seq, heads, kv_heads, causal, scale_log2, s);
    case 32: return dispatch<32>(bf16, q, k, v, o, batch, seq, heads, kv_heads, causal, scale_log2, s);
    case 64: return dispatch<64>(bf16, q, k, v, o, batch, seq, heads, kv_heads, causal, scale_log2, s);
    case 128: return dispatch<128>(bf16, q, k, v, o, batch, seq, heads, kv_heads, causal, scale_log2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
