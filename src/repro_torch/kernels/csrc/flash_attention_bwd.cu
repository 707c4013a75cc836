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
// (2, 4096, 24, 8, 128) bf16 that is 5.16e11 FLOP against ~0.2 GB.
//
// Design: simple and right first (no wgmma or TMA yet), deterministic and
// free of float atomics, like the neighbor_agg backward: every output
// element is summed by one thread in a fixed order and written once.  Two
// kernels, launched in this order on the caller's stream:
//   flash_bwd_dq: grid (B*H, S/64), one q tile of 64 rows of one head.  It
//     forms D from its own O and dO tiles (written to a (B, H, S) scratch
//     for the next kernel), then walks the kv tiles (to the diagonal when
//     causal), recomputes P and dP, and accumulates dQ += dS K in
//     registers; dQ is written once.
//   flash_bwd_dkv: grid (B*Hkv, S/64), one kv tile of 64 keys of one kv
//     head.  dK and dV stay in registers while the block walks the group's
//     G q-heads in ascending order and, for each, the q tiles (from the
//     diagonal on when causal); they are written once.  GQA is by index:
//     no repeated k/v.
// Both are SIMT f32 FMA kernels of 256 threads: thread (ty, tx) of 16 x 16
// owns rows 4 ty .. 4 ty + 3 of a 64 x 64 score tile against columns
// tx + 16 j, and rows 4 ty .. of the output against columns tx + 16 c.
// Tiles are staged in shared memory as f32 (bf16 inputs are widened as
// they are staged; outputs rounded once when stored), rows padded by 4
// floats and read as float4.  Shared memory at Dh = 128: 150 KB (dq) and
// 167 KB (dkv), one block per SM.  Registers: the launch bounds ask for one
// block of 256 threads per SM (up to 255 registers a thread), and the loops
// over the head width and over a tile's 64 rows are not unrolled (their
// bodies are): with ptxas's own choices the dkv kernels spilled, at Dh 32
// and 64 when it aimed at two blocks (128 registers), at Dh 16 when it
// unrolled into 255 (chip_smoke.py phase 1 fails on a spill).
//
// Head widths: templates DH in {16, 32, 64, 128}, given the real dh (a
// multiple of 8 no wider), as the forward: columns dh .. DH-1 are staged
// as zeros and never stored.  Rows >= S are staged as zeros and masked.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename Kernel>
cudaError_t grant(Kernel kernel, int smem) {
  // above 48 KB a block's shared memory must be granted explicitly
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// one grant per kernel, at its first launch (thread-safe static initialisation)
template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* d_rows, int B, int S, int H,
           int Hkv, int dh, int causal, float scale, cudaStream_t stream) {
  using L = Lay<DH>;
  static const cudaError_t g_dq = grant(flash_bwd_dq<DH, T>, L::DQ_SMEM);
  static const cudaError_t g_dkv = grant(flash_bwd_dkv<DH, T>, L::DKV_SMEM);
  if (g_dq != cudaSuccess) return static_cast<int>(g_dq);
  if (g_dkv != cudaSuccess) return static_cast<int>(g_dkv);
  const int tiles = (S + kT - 1) / kT;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq<DH, T><<<dim3(B * H, tiles), kThreads, L::DQ_SMEM, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), lse, dot, static_cast<T*>(dq), d_rows, S, H, Hkv, dh,
      causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv<DH, T><<<dim3(B * Hkv, tiles), kThreads, L::DKV_SMEM, stream>>>(
      qt, kt, vt, lse, dot, d_rows, static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, dh,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int dispatch(bool bf16, const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, void* dq, void* dk, void* dv, float* d_rows,
             int B, int S, int H, int Hkv, int dh, int causal, float scale, cudaStream_t stream) {
  if (bf16)
    return launch<DH, __nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, d_rows, B, S, H, Hkv, dh,
                                     causal, scale, stream);
  return launch<DH, float>(q, k, v, o, lse, dout, dq, dk, dv, d_rows, B, S, H, Hkv, dh, causal,
                           scale, stream);
}

}  // namespace

// Returns 0 when both kernels were launched, else the CUDA error of the
// launch.  The caller (ops.py, flash_attention_bwd) has checked shapes,
// types, devices and contiguity, allocated dq, dk, dv and the (B, H, S) f32
// scratch d_rows, and names the template (16, 32, 64 or 128) that runs
// head_dim, a multiple of 8 no wider.  scale is head_dim^-1/2.
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

// Dynamic shared memory of a block of the dq (kernel 0) or dkv (kernel 1)
// kernel of the template of this width (bytes), 0 for no template; ptxas
// reports static shared memory only.
extern "C" int flash_attention_bwd_smem_bytes(int width, int kernel) {
  switch (width) {
    case 16: return kernel ? Lay<16>::DKV_SMEM : Lay<16>::DQ_SMEM;
    case 32: return kernel ? Lay<32>::DKV_SMEM : Lay<32>::DQ_SMEM;
    case 64: return kernel ? Lay<64>::DKV_SMEM : Lay<64>::DQ_SMEM;
    case 128: return kernel ? Lay<128>::DKV_SMEM : Lay<128>::DQ_SMEM;
    default: return 0;
  }
}
