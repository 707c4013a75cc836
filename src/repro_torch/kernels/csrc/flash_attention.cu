// flash_attention: blockwise self-attention forward with an online softmax,
// for the block prefill of the dense LMs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:60,
// flash_attention_pallas (_flash_kernel).
//
//   q (B, S, H, Dh), k/v (B, S, Hkv, Dh), H % Hkv == 0, row-major
//   o[b,i,h] = sum_j softmax_j(q[b,i,h] . k[b,j,h/G] * Dh^-1/2) v[b,j,h/G]
//   over j <= i when causal, else over every j < S; G = H / Hkv
//
// Bound: operations.  The causal prefill does 4 Dh S(S+1)/2 FLOP per
// (batch, head) and reads each input once: at the qwen3-4b prefill
// (B=2, S=4096, H=32, Hkv=8, Dh=128, bf16) that is 275 GFLOP against
// 168 MB, some 1,600 FLOP per byte, far above the card's ~295.  Only the
// tensor cores through wgmma reach the card's bf16 rate, and the exp2 of
// the softmax (16 per clock per SM) costs half as much again as the two
// products of a tile: the design keeps both units fed.
//
// Which kernel runs where: bf16 at every head width is the Hopper kernel
// below (namespace wg); f32 is the SIMT kernel (namespace simt), which is
// off the prefill's path (no tensor-core type keeps f32).
//
// Head widths.  Each kernel is a template of width DH in {16, 32, 64, 128};
// the caller names the template a head width dh runs on (ops.py's
// TEMPLATE_WIDTH: 8 runs the DH = 16 instance and 112 the DH = 128 one;
// zamba2-7b and kimi-k2 have Dh = 112, glm4-9b's smoke config 8).  The
// tensors keep their real width: the tensor maps and strides are dh's
// (dh*2 and heads*dh*2 bytes, multiples of 16 for a dh that is a multiple
// of 8), the boxes the template's, so TMA fills columns dh..DH-1 of every
// tile with zeros, which add nothing to Q.K^T and give output columns that
// are never stored; the f32 kernel's PAD instances load those columns as
// zeros themselves (at dh = DH the unmasked instance runs).
// The scale is dh^-1/2.  The cost: the products of a dh = 112 call run
// over 128 columns, 128/112 of the arithmetic (2x at dh = 8).
//
// Shared by both.  A block (in the bf16 kernel, each work item of a
// persistent block) owns one (batch, head) and a tile of query rows, and
// walks the key/value tiles of its kv head in order: the Pallas
// kernel's sequential KV loop stays a loop inside the block.  Heads are
// indexed through the (B, S, H, Dh) strides: no transposes and no repeated
// kv (the G q-heads of one kv head read the same tiles, which L2 serves).
// The running max, sum and accumulator stay in f32 registers; scores are
// exponentiated in the log2 domain.  Masked scores are -1e30, the value of
// the JAX kernel, so a row that no key reaches stays finite, as in the plain
// version.  Causal tiles past the tile's last query row are skipped by the
// loop bound; only the diagonal tile and a ragged last tile are masked, and
// rows >= S are never stored.  The output is divided by max(l, 1e-30).
//
// bf16, Hopper (sm_90a): TMA ring, wgmma, warp-specialised consumers (the
// TMA, mbarrier and wgmma helpers and the tensor maps are hopper.cuh's,
// shared with the backward, flash_attention_bwd.cu).
//   Work item: one (batch, head) and a tile of 128 query rows.  The grid
//   is persistent, one block of 3 warpgroups (384 threads) per SM walking
//   its share of the items.  Warpgroup 0 is the producer: after setmaxnreg
//   gives its registers to the consumers (40 left, 232 each for the
//   others), one thread issues TMA loads of each item's Q tile, then of
//   its K and V tiles of 128 keys into a ring of 2 stages.
//   Q and each K and V slot have a full and an empty mbarrier: the copies
//   complete the full barriers by their byte count (expect_tx), and the 256
//   consumer threads arrive on an empty barrier once the products that
//   read the slot have completed, which lets the producer refill it.  Q's
//   slot is released after an item's last S, so the next item's Q and first
//   K/V tiles load during this item's last P.V and its stores.
//   Warpgroups 1 and 2 are the consumers, 64 query rows each.  Per tile:
//     S = Q.K^T by wgmma m64n128k16 with both operands in shared memory
//       (SS), Dh/16 k-steps;
//     the online softmax on the accumulators in registers: row max across
//       the 4 lanes of a quad, p = exp2(s * scale_log2 - m * scale_log2) by
//       ex2.approx, the row sums kept per thread and reduced once at the end;
//     P rounded to bf16 in registers (as the JAX model rounds it before
//       P.V): the m64nN accumulator layout is the A-fragment layout of
//       m64nNk16, so the scores of keys 16s..16s+15 are A of k-step s;
//     O += P.V by wgmma m64nDhk16 with A from registers (RS) and V read
//       from shared memory through the descriptor's transpose bit: V stays
//       (keys, Dh) as it lies in memory, with no scalar loads.
//   Scheduling (FA3's two overlaps).  Within a consumer, S(t) and
//   P(t-1).V(t-1) are issued back to back and the softmax of S(t) runs
//   while P(t-1).V(t-1) is still on the tensor cores (wait_group 1, then
//   0), so a K slot is released after S(t) and a V slot after P.V.
//   Between the consumers, two named barriers hand the right to issue
//   products back and forth (ping-pong): one consumer exponentiates while
//   the other's products run.  Schedule: items ordered heaviest first
//   (causal: the last q-tile, with the most KV tiles, first), dealt in
//   rounds of one per block, each odd round in mirror order (a snake), so
//   that every block's sum of tiles comes out near the mean; a persistent
//   block also hides each item's loads and stores behind its neighbours'.
//   Shared memory: Q 128 x Dh, and per stage K and V 128 x Dh, bf16: 160 KB
//   at Dh = 128, granted once per width above the 48 KB default.
//
// Where this kernel can go wrong, and what it does about it:
//   1. cuTensorMapEncodeTiled is a driver-API function and the build links
//      the runtime only: it is fetched once through the runtime's
//      cudaGetDriverEntryPoint(ByVersion).  The four maps are encoded on
//      the host at every call (a few microseconds); a failed encode returns
//      kEncodeError + its CUresult, which the wrapper raises.
//   2. TMA: the maps are 4-D, (Dh, heads, S, B) innermost first, over the
//      tensors' own strides (dh*2, heads*dh*2, S*heads*dh*2 bytes: each a
//      multiple of 16 at every width taken); boxes of min(DH, 64) columns x
//      1 head x 128 rows x 1 batch, so a box row is exactly the swizzle
//      span: 128-byte swizzle at Dh 64 and 128 (two boxes per row at 128),
//      64-byte at Dh 32, 32-byte at Dh 16.  The global address is 16-byte
//      aligned (the wrapper checks).  Rows >= S and columns >= dh are
//      zero-filled by TMA, which counts them in the transaction bytes.
//   3. wgmma descriptors must describe exactly the layout TMA wrote, or the
//      numbers are wrong without a fault.  Q and K are K-major: rows of
//      (swizzle span) bytes, 8-row groups SBO = 8 x span apart, the k-step
//      advancing the start address by 32 bytes inside a swizzled row and by
//      one box (128 x span bytes) across boxes.  V is MN-major (transpose
//      bit): 8-key groups SBO = 8 x span apart, the next span-wide column
//      block LBO = one box apart, the k-step advancing 16 key rows.  Every
//      tile starts 1024-byte aligned, so the swizzle phase (base offset) is
//      0 everywhere.
//   4. Fences: wgmma.fence before each batch of products (P and the
//      rescaled O are written by ordinary instructions in between);
//      commit_group, then wait_group 1 before the softmax reads S and
//      wait_group 0 before P is rewritten or a V slot released; the
//      accumulators and P are pinned in registers around each wait so that
//      the compiler moves no read or reuse across it.
//   5. Registers: O (Dh/2 f32), S (64 f32) and P (32 x 32-bit) are live
//      together, ~180 at Dh = 128, above the 168 that 384 threads leave.
//      setmaxnreg gives the consumers 232, and ptxas allocates up to it in
//      the consumers' arm of the role if/else.  One __trap in the mbarrier
//      wait (a bound on its polls, since removed) made ptxas ignore it: the
//      kernel was capped at 168 registers, spilled and serialised its
//      wgmma.  chip_smoke.py phase 1 prints ptxas's registers and
//      spills and fails on a spill.
//   6. Ragged edges at 128-row tiles: S = 1 (one row, 127 padding rows),
//      127 and 129 (a partial diagonal, one row past a tile), 1000 and 4097
//      (a partial last KV tile) are held against the plain version.
//
// Log-sum-exp (the backward's input, csrc/flash_attention_bwd.cu).  Given a
// non-null lse pointer, both kernels also store each row's log-sum-exp of
// the scaled, masked scores, (B, H, S) f32 in natural log, from the running
// max and sum of the online softmax: (m * scale_log2 + log2 l) * ln 2 (the
// f32 kernel keeps m already in log2 units).  It is one store in the
// epilogue: the arithmetic of O is untouched, and O is bit-equal with and
// without the pointer.
//
// f32 (SIMT): per-thread f32 FMA.  256 threads, a tile of 64 query rows,
// each thread owning 4 query rows x 2 keys of a 64 x 32 score tile and
// 4 rows x Dh/16 columns of the output; Q, K, V and P staged in shared
// memory as f32 (rows padded by 4 floats), read as float4.  77 KB of shared
// memory at Dh=128.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLn2 = 0.69314718055994531f;
constexpr int kBQ = 64;   // query rows per block of the f32 kernel

__device__ __forceinline__ int tile_count(int S, int q0, int bk, int causal) {
  const int n = (S + bk - 1) / bk;
  if (!causal) return n;
  const int last = (q0 + kBQ - 1) / bk + 1;
  return last < n ? last : n;
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma (sm_90a)
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kBM = 128;        // query rows per block: 2 consumers x 64
constexpr int kBN = 128;        // keys per KV tile
constexpr int kStages = 2;      // KV ring depth
constexpr int kThreads = 384;   // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int DH>
struct Tile : hopper::Tile<DH, kBN> {
  using Base = hopper::Tile<DH, kBN>;
  static constexpr int BARS = 2 + 4 * kStages;               // Q, K, V full and empty
  static constexpr int SMEM = (1 + 2 * kStages) * Base::BYTES + 8 * BARS + 1024;  // + alignment
};

// named barriers 1 and 2 pace the two consumers' turns (0 is __syncthreads)
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// The online-softmax state of a thread's two rows a and b: running max (raw
// score units), this thread's partial sums, and the factor by which the
// last tile shrank the earlier terms.
struct Rows {
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f, alpha_a = 1.f, alpha_b = 1.f;
};

// S (raw scores) of one tile, in place: the mask where the tile needs one,
// the running max, p = exp2(s * scale_log2 - m * scale_log2) and the
// partial row sums.  sc[4j + e] is row (e < 2 ? a : b), key
// k0 + key0 + 8j + (e & 1), key0 = 2 (lane % 4).

__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2], Rows& r, bool masked, int k0,
                                             int key0, int row_a, int row_b, int S, int causal,
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + key0 + 8 * j + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        if (!(key < S && (!causal || key <= row))) sc[4 * j + e] = kNeg;
      }
  }
  float mx_a = r.m_a, mx_b = r.m_b;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  r.alpha_a = ex2((r.m_a - mx_a) * scale_log2);
  r.alpha_b = ex2((r.m_b - mx_b) * scale_log2);
  r.m_a = mx_a;
  r.m_b = mx_b;
  const float ms_a = mx_a * scale_log2, ms_b = mx_b * scale_log2;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -ms_a));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -ms_a));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -ms_b));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -ms_b));
    sum_a += sc[4 * j] + sc[4 * j + 1];
    sum_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.l_a = r.l_a * r.alpha_a + sum_a;
  r.l_b = r.l_b * r.alpha_b + sum_b;
}

template <int DH>
__device__ __forceinline__ void rescale(float (&acc)[DH / 2], const Rows& r) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    acc[4 * j] *= r.alpha_a;
    acc[4 * j + 1] *= r.alpha_a;
    acc[4 * j + 2] *= r.alpha_b;
    acc[4 * j + 3] *= r.alpha_b;
  }
}

// S = Q.K^T: k-step kk reads columns 16kk.. of box 16kk / BOX_COLS
template <int DH>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t q, uint32_t k) {
  using T = Tile<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk * 16 / T::BOX_COLS) * T::BOX + (kk * 16 % T::BOX_COLS) * 2;
    mma_ss_n128(sc, desc(q + off, 16, 8 * T::SPAN, T::LAYOUT),
                desc(k + off, 16, 8 * T::SPAN, T::LAYOUT), kk > 0);
  }
}

// O += P.V: k-step k reads key rows 16k..16k+15 of the V tile
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2], const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t v) {
  using T = Tile<DH>;
#pragma unroll
  for (int k = 0; k < kBN / 16; ++k)
    mma_rs(acc, pa[k], desc(v + 16 * k * T::SPAN, T::BOX, 8 * T::SPAN, T::LAYOUT));
}

// Shared-memory addresses of one block: Q, the K and V rings, the mbarriers.
template <int DH>
struct Smem {
  uint32_t q, k, v, bars;
  __device__ explicit Smem(uint32_t base)
      : q(base), k(base + Tile<DH>::BYTES), v(base + (1 + kStages) * Tile<DH>::BYTES),
        bars(base + (1 + 2 * kStages) * Tile<DH>::BYTES) {}
  __device__ uint32_t k_at(int s) const { return k + s * Tile<DH>::BYTES; }
  __device__ uint32_t v_at(int s) const { return v + s * Tile<DH>::BYTES; }
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const { return bars + 8 * (1 + kStages + s); }
  __device__ uint32_t k_empty(int s) const { return bars + 8 * (1 + 2 * kStages + s); }
  __device__ uint32_t v_empty(int s) const { return bars + 8 * (1 + 3 * kStages + s); }
  __device__ uint32_t q_empty() const { return bars + 8 * (1 + 4 * kStages); }
};

// One block's share of the work: rounds of gridDim.x items in the order
// heaviest first (item i = q-tile nq-1-i/(B*H) of (batch, head) i%(B*H)),
// the block taking position blockIdx.x of even rounds and the mirror
// position of odd ones, so the heavy and light ends of each round even out.
struct Work {
  int q0, b, h, n_tiles;
  __device__ bool at(int r, int S, int B, int H, int causal) {
    const int nq = (S + kBM - 1) / kBM;
    const int c = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int i = r * gridDim.x + c;
    if (i >= nq * B * H) return false;
    q0 = (nq - 1 - i / (B * H)) * kBM;
    b = i % (B * H) / H;
    h = i % H;
    n_tiles = (S + kBN - 1) / kBN;
    if (causal) n_tiles = min(n_tiles, (q0 + kBM - 1) / kBN + 1);
    return true;
  }
};

__device__ __forceinline__ int rounds(int S, int B, int H) {
  const int n = (S + kBM - 1) / kBM * B * H;
  return (n + gridDim.x - 1) / gridDim.x;
}

// The producer's one thread, item by item: Q once its slot is free, then K
// and V of every tile into the ring, each slot refilled once both
// consumers have released it.
template <int DH>
__device__ __forceinline__ void produce(const Smem<DH>& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv, int B,
                                        int S, int H, int Hkv, int causal) {
  using T = Tile<DH>;
  constexpr int kBoxes = DH / T::BOX_COLS;
  int n = 0, done = 0;   // tiles loaded, items loaded
  Work w;
  for (int r = 0; r < rounds(S, B, H); ++r) {
    if (!w.at(r, S, B, H, causal)) continue;
    const int hk = w.h / (H / Hkv);
    if (done > 0) bar_wait(sm.q_empty(), (done - 1) & 1);
    bar_expect(sm.q_full(), T::BYTES);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
      tma_load(sm.q + c * T::BOX, tq, sm.q_full(), c * T::BOX_COLS, w.h, w.q0, w.b);
    for (int t = 0; t < w.n_tiles; ++t, ++n) {
      const int s = n % kStages;
      const uint32_t freed = (n / kStages - 1) & 1;   // parity of the slot's last release
      if (n >= kStages) bar_wait(sm.k_empty(s), freed);
      bar_expect(sm.k_full(s), T::BYTES);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(sm.k_at(s) + c * T::BOX, tk, sm.k_full(s), c * T::BOX_COLS, hk, t * kBN, w.b);
      if (n >= kStages) bar_wait(sm.v_empty(s), freed);
      bar_expect(sm.v_full(s), T::BYTES);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(sm.v_at(s) + c * T::BOX, tv, sm.v_full(s), c * T::BOX_COLS, hk, t * kBN, w.b);
    }
    ++done;
  }
}

// A consumer warpgroup (cw = 0 or 1) owns query rows q0 + 64 cw .. + 63.
// Per tile t, in this consumer's turn, S(t) = Q.K(t)^T and O += P(t-1).V(t-1)
// are issued back to back; the softmax of S(t) then runs while P(t-1).V(t-1)
// is still on the tensor cores, and the other consumer's turn fills the
// tensor cores while this one exponentiates.
template <int DH>
__device__ __forceinline__ void consume_item(const Smem<DH>& sm, __nv_bfloat16* __restrict__ o,
                                             float* __restrict__ lse, int cw, int tid, int q0, int b, int h, int n_tiles,
                                             int S, int H, int dh, int causal, float scale_log2,
                                             int& n, int item) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, key0 = 2 * (tid & 3);
  const int wg_row0 = q0 + 64 * cw;
  const int row_a = wg_row0 + 16 * warp + g, row_b = row_a + 8;   // this thread's rows
  const uint32_t q_wg = sm.q + 64 * cw * Tile<DH>::SPAN;
  const int mine = 1 + cw, other = 2 - cw;   // named barriers of the turns
  auto masked = [&](int k0) { return (causal && k0 + kBN - 1 > wg_row0) || k0 + kBN > S; };

  float acc[DH / 2], sc[kBN / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
  uint32_t pa[kBN / 16][4];
  Rows r;

  bar_wait(sm.q_full(), item & 1);
  bar_wait(sm.k_full(n % kStages), (n / kStages) & 1);
  turn_wait(mine);
  mma_fence();
  issue_qk<DH>(sc, q_wg, sm.k_at(n % kStages));
  mma_commit();
  turn_pass(other);
  mma_wait<0>();
  pin(sc);
  bar_arrive(sm.k_empty(n % kStages));
  softmax_tile(sc, r, masked(0), 0, key0, row_a, row_b, S, causal, scale_log2);
  to_bf16<kBN>(pa, sc);
  ++n;

  for (int t = 1; t < n_tiles; ++t, ++n) {
    const int s = n % kStages, p = (n - 1) % kStages;
    bar_wait(sm.k_full(s), (n / kStages) & 1);
    turn_wait(mine);
    mma_fence();
    issue_qk<DH>(sc, q_wg, sm.k_at(s));
    mma_commit();
    rescale<DH>(acc, r);
    bar_wait(sm.v_full(p), ((n - 1) / kStages) & 1);
    pin(acc);
    pin(pa);
    mma_fence();
    issue_pv<DH>(acc, pa, sm.v_at(p));
    mma_commit();
    turn_pass(other);
    mma_wait<1>();   // S(t) is done, P(t-1).V(t-1) may still run
    pin(sc);
    bar_arrive(sm.k_empty(s));
    softmax_tile(sc, r, masked(t * kBN), t * kBN, key0, row_a, row_b, S, causal, scale_log2);
    mma_wait<0>();
    pin(acc);
    pin(pa);
    bar_arrive(sm.v_empty(p));
    to_bf16<kBN>(pa, sc);
  }
  bar_arrive(sm.q_empty());   // every S of this item is done: Q may be refilled
  const int last = (n - 1) % kStages;
  rescale<DH>(acc, r);
  bar_wait(sm.v_full(last), ((n - 1) / kStages) & 1);
  pin(acc);
  pin(pa);
  mma_fence();
  issue_pv<DH>(acc, pa, sm.v_at(last));
  mma_commit();
  mma_wait<0>();
  pin(acc);
  bar_arrive(sm.v_empty(last));

  float l_a = r.l_a, l_b = r.l_b;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
  if (lse != nullptr && key0 == 0) {   // the log-sum-exp of the scaled scores, natural log
    float* lb = lse + (static_cast<int64_t>(b) * H + h) * S;
    if (row_a < S) lb[row_a] = (r.m_a * scale_log2 + log2f(d_a)) * kLn2;
    if (row_b < S) lb[row_b] = (r.m_b * scale_log2 + log2f(d_b)) * kLn2;
  }
  const int64_t stride = static_cast<int64_t>(H) * dh;
  __nv_bfloat16* ob = o + static_cast<int64_t>(b) * S * stride + h * dh + key0;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (8 * j >= dh) break;   // columns dh.. of the template are padding
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_a * stride + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] / d_a, acc[4 * j + 1] / d_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_b * stride + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d_b, acc[4 * j + 3] / d_b);
  }
}

template <int DH>
__device__ __forceinline__ void consume(const Smem<DH>& sm, __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, int cw, int tid, int B, int S, int H, int dh, int causal,
                                        float scale_log2) {
  if (cw == 1) turn_pass(1);   // consumer 0 takes the first turn
  int n = 0, item = 0;
  Work w;
  for (int r = 0; r < rounds(S, B, H); ++r) {
    if (!w.at(r, S, B, H, causal)) continue;
    consume_item<DH>(sm, o, lse, cw, tid, w.q0, w.b, w.h, w.n_tiles, S, H, dh, causal, scale_log2, n,
                     item);
    ++item;
  }
}

// The two roles are the two arms of one if/else that never rejoin: ptxas
// then gives each arm its setmaxnreg budget.  Persistent: one block per SM.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int B,
                int S, int H, int Hkv, int dh, int causal, float scale_log2) {
  extern __shared__ uint8_t smem_wg[];
  const Smem<DH> sm((smem_u32(smem_wg) + 1023u) & ~1023u);   // swizzle atoms: 1024 B
  if (threadIdx.x == 0) {
    bar_init(sm.q_full(), 1);
    bar_init(sm.q_empty(), 2 * 128);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      bar_init(sm.k_full(s), 1);
      bar_init(sm.v_full(s), 1);
      bar_init(sm.k_empty(s), 2 * 128);
      bar_init(sm.v_empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) produce<DH>(sm, &tq, &tk, &tv, B, S, H, Hkv, causal);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<DH>(sm, o, lse, wgi - 1, threadIdx.x - 128 * wgi, B, S, H, dh, causal, scale_log2);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: per-thread FMA
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kPLD = kBK + 4;   // P tile row stride (floats)

template <int DH>
constexpr int smem_bytes() { return ((kBQ + 2 * kBK) * (DH + 4) + kBQ * kPLD) * 4; }

// rows >= S and, in a PAD instance, columns >= dh (the template's padding)
// are stored as zeros
template <int DH, bool PAD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row_stride,
                                          int s0, int rows, int S, int dh) {
  constexpr int LD = DH + 4, VEC = DH / 4;
  for (int e = threadIdx.x; e < rows * VEC; e += kThreads) {
    const int r = e / VEC, c = e % VEC;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < S && (!PAD || c * 4 < dh))
      val = *reinterpret_cast<const float4*>(src + (s0 + r) * row_stride + c * 4);
    *reinterpret_cast<float4*>(dst + r * LD + c * 4) = val;
  }
}

// PAD: dh < DH, the columns dh..DH-1 are masked; else dh is DH, a constant
template <int DH, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int S, int H, int Hkv, int dh_arg, int causal, float scale_log2) {
  const int dh = PAD ? dh_arg : DH;
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
  const int64_t q_stride = static_cast<int64_t>(H) * dh;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * dh;
  const float* qb = q + static_cast<int64_t>(b) * S * q_stride + h * dh;
  const float* kb = k + static_cast<int64_t>(b) * S * kv_stride + hk * dh;
  const float* vb = v + static_cast<int64_t>(b) * S * kv_stride + hk * dh;
  float* ob = o + static_cast<int64_t>(b) * S * q_stride + h * dh;

  load_tile<DH, PAD>(Qs, qb, q_stride, q0, kBQ, S, dh);
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
    load_tile<DH, PAD>(Ks, kb, kv_stride, k0, kBK, S, dh);
    load_tile<DH, PAD>(Vs, vb, kv_stride, k0, kBK, S, dh);
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
    // m is in log2 units here (the scores were scaled by scale_log2)
    if (lse != nullptr && tx == 0)
      lse[static_cast<int64_t>(blockIdx.y) * S + row] = (m[i] + log2f(lm)) * kLn2;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (!PAD || tx + 16 * c < dh) ob[row * q_stride + tx + 16 * c] = acc[i][c] / lm;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using hopper::EncodeTiled;
using hopper::grant;
using hopper::kEncodeError;

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int H,
                 int Hkv, int dh, int causal, float scale_log2, cudaStream_t stream) {
  using T = wg::Tile<DH>;
  static const cudaError_t granted = grant(wg::flash_fwd_wgmma<DH>, T::SMEM);
  static const EncodeTiled fn = hopper::encoder();
  if (granted != cudaSuccess) return static_cast<int>(granted);
  if (fn == nullptr) return kEncodeError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  CUtensorMap tq, tk, tv;
  CUresult r = hopper::encode<DH>(fn, &tq, q, dh, H, S, B, wg::kBN);
  if (r == CUDA_SUCCESS) r = hopper::encode<DH>(fn, &tk, k, dh, Hkv, S, B, wg::kBN);
  if (r == CUDA_SUCCESS) r = hopper::encode<DH>(fn, &tv, v, dh, Hkv, S, B, wg::kBN);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int items = (S + wg::kBM - 1) / wg::kBM * B * H;
  const int grid = items < sms ? items : sms;
  wg::flash_fwd_wgmma<DH><<<grid, wg::kThreads, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, S, H, Hkv, dh, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool PAD>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int H,
               int Hkv, int dh, int causal, float scale_log2, cudaStream_t stream) {
  constexpr int smem = simt::smem_bytes<DH>();
  static const cudaError_t granted = grant(simt::flash_fwd_f32<DH, PAD>, smem);
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  simt::flash_fwd_f32<DH, PAD><<<grid, simt::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, H, Hkv, dh, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// one grant per kernel, at its first launch (thread-safe static initialisation)
template <int DH>
int dispatch(bool bf16, const void* q, const void* k, const void* v, void* o, float* lse, int B,
             int S, int H, int Hkv, int dh, int causal, float scale_log2, cudaStream_t stream) {
  if (bf16)
    return launch_wgmma<DH>(q, k, v, o, lse, B, S, H, Hkv, dh, causal, scale_log2, stream);
  return dh < DH
             ? launch_f32<DH, true>(q, k, v, o, lse, B, S, H, Hkv, dh, causal, scale_log2, stream)
             : launch_f32<DH, false>(q, k, v, o, lse, B, S, H, Hkv, dh, causal, scale_log2, stream);
}

}  // namespace

// Returns 0 when the kernel was launched, else the CUDA error of the launch,
// or kEncodeError (100000) + the CUresult of a failed tensor-map encode.
// The caller has checked shapes, types, devices, contiguity and 16-byte
// alignment and B * H <= 65535, and names the template (16, 32, 64 or 128)
// that runs head_dim, a multiple of 8 no wider than it (ops.py's
// TEMPLATE_WIDTH).  scale_log2 is head_dim^-1/2 * log2(e), of the real
// head_dim.  lse, when not null, receives each row's log-sum-exp of the
// scaled, masked scores, (batch, heads, seq) f32 in natural log (the
// backward's input); o is the same with or without it.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int batch, int seq, int heads, int kv_heads,
                                      int head_dim, int width, int bf16, int causal,
                                      float scale_log2, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int d = head_dim;
  if (d < 8 || d % 8 != 0 || d > width) return static_cast<int>(cudaErrorInvalidValue);
  switch (width) {
    case 16: return dispatch<16>(bf16, q, k, v, o, lse, batch, seq, heads, kv_heads, d, causal, scale_log2, s);
    case 32: return dispatch<32>(bf16, q, k, v, o, lse, batch, seq, heads, kv_heads, d, causal, scale_log2, s);
    case 64: return dispatch<64>(bf16, q, k, v, o, lse, batch, seq, heads, kv_heads, d, causal, scale_log2, s);
    case 128: return dispatch<128>(bf16, q, k, v, o, lse, batch, seq, heads, kv_heads, d, causal, scale_log2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory a launch of the template of this width grants
// (bytes), 0 for no template; ptxas reports static shared memory only.
extern "C" int flash_attention_smem_bytes(int width, int bf16) {
  switch (width) {
    case 16: return bf16 ? wg::Tile<16>::SMEM : simt::smem_bytes<16>();
    case 32: return bf16 ? wg::Tile<32>::SMEM : simt::smem_bytes<32>();
    case 64: return bf16 ? wg::Tile<64>::SMEM : simt::smem_bytes<64>();
    case 128: return bf16 ? wg::Tile<128>::SMEM : simt::smem_bytes<128>();
    default: return 0;
  }
}
