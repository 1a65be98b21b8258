// fp32 attention on Hopper's tensor cores (sm_90a) in 3xTF32, forward and
// backward, plain C ABI:
//
//   gated:     out = softmax(q·kᵀ·scale + gate ⊙ bias + pad) · v, and its backward
//   bias-free: out = softmax(q·kᵀ·scale + pad) · v, and its backward
//
// Replaces, for fp32 operands whose head width D is a multiple of 8 up to
// 128 on 16-byte rows, six Pallas TPU kernels of the JAX package:
//   - _attention_kernel            avex_tpu/ops/pallas_attention.py:126  (K1; launched at :272)
//   - _fused_qkv_gated_kernel      avex_tpu/ops/pallas_attention.py:389  (K2; launched at :745)
//   - _plain_attention_kernel      avex_tpu/ops/pallas_attention.py:161  (K4; launched at :261)
//   - _fused_qkv_kernel            avex_tpu/ops/pallas_attention.py:344  (K5; launched at :511)
//   - _fused_qkv_gated_bwd_kernel  avex_tpu/ops/pallas_attention.py:765  (K3; launched at :902)
//   - _fused_qkv_bwd_kernel        avex_tpu/ops/pallas_attention.py:524  (K6; launched at :631)
// The split (K1, K4) and fused (K2, K5) layouts are only different strides
// to the forward. Every other fp32 call (narrow rows: D or a stride not a
// multiple of 8, a base off 16 bytes; column chunks past 128) stays on
// gated_attention.cu's FMA body, forward and backward alike. bf16 is
// tensor_core_attention.cu's.
//
// The forward, as the JAX kernels compute it in fp32: L = q·kᵀ·scale
// (+ gate ⊙ bias), −inf at a padded key, out = softmax(L)·v (P is already
// v's type), and, when the backward will follow, the row log-sum-exp
// LSE = log Σ_k exp(L) into a float32 [B, H, T]. A row whose keys are all
// padded gives NaN and LSE −inf, as the plain twin's softmax does. Any T:
// ragged last tiles are masked, not padded.
//
// The backward, as the FMA body and the JAX kernels do, in fp32: with
// L = q·kᵀ·scale (+ gate ⊙ bias) + pad and P = softmax(L),
//   dV = Pᵀ·dO   dP = dO·Vᵀ   dL = P ∘ (dP − Δ)   dQ = (dL·scale)·K   dK = (dL·scale)ᵀ·Q
//   dgate[b,h,t] = Σ_k bias·dL   dbias[h] = Σ_b gate ⊙ dL
// dQ, dK and dV are written into the column views of one [B, T, 3E] gradient.
// As the bf16 backward does, it rebuilds P from the row log-sum-exp that the
// forward saved (the fp32 K2/K5 write it under grad) and takes
// Δ = rowsum(dO ∘ O) from the forward's fp32 output: no pass recomputes the
// row statistics. Where the bf16 backward's roundings hide it, fp32 shows
// that such a P sums over its row to 1 + ε, ε near 2^-24 times the largest
// logit in log2 units, the same for every key: Σ_k dS is then Δ·ε, not 0,
// and a gradient that cancels over the keys (a key projection's weight)
// takes all of it. So the dQ kernel also sums Σ P and Σ P·dP along its walk
// and hands the other two kernels P / Σ P (the LSE rebased) and
// Δ' = Σ P·dP / Σ P, and rescales its own dQ and dgate. A padded key gets
// −inf; a row whose keys are all padded has LSE −inf and gives NaN, as the
// plain twin's softmax does.
//
// Numerics: 3xTF32. A TF32 operand keeps 10 of fp32's 23 mantissa bits
// (2^-11 relative), too coarse for the fp32 parity path on its own. Each
// fp32 operand x is split as hi = tf32(x) (cvt.rna.tf32.f32, round to
// nearest, ties away) and lo = tf32(x − hi), and each product is taken as
// lo·hi + hi·lo + hi·hi (the two small terms first) by three
// mma.sync.m16n8k8 TF32 products accumulating in fp32. The dropped lo·lo
// term and lo's own rounding are near 2^-22 relative, so a product keeps
// about fp32's accuracy; this is the split CUTLASS's OpMultiplyAddFastF32
// takes, which PyTorch's memory-efficient attention uses for fp32 on sm80
// and later. Everything else stays fp32: the logits, P, dP − Δ, dL, the
// dbias and dgate sums. One TF32 pass (hi·hi alone) would land near 5e-4
// relative (tests/test_torch_tf32x3.py shows it).
//
// Bounds on an H100 SXM at the main paths' shapes (H=12, D=64, fp32), the
// FLOPs over 495/3 = 165 TFLOP/s (three TF32 products a product):
//   K5, EAT B=128, T=513: two products, 4·B·H·T²·D = 103.5 GFLOP, 0.627 ms,
//     against q, k, v and out, 4 x 202 MB, 0.241 ms at 3.35 TB/s: bound by
//     operations; K1/K2 at BEATs' B=128, T=248: 24.2 GFLOP, 0.147 ms,
//     against 4 x 97.5 MB plus bias and gate, 0.118 ms: bound by
//     operations; K5 at D=80 (Bird-MAE huge, H=16): 1.045 ms;
//   K6, EAT B=64, T=513: five products, 10·B·H·T²·D = 129.4 GFLOP, 0.784 ms,
//     against 7 x 100.9 MB = 706 MB, 0.211 ms at 3.35 TB/s: bound by
//     operations;
//   K6 at D=80 (Bird-MAE huge, H=16): 215.6 GFLOP, 1.307 ms;
//   K3, BEATs B=64, T=248: 30.2 GFLOP, 0.183 ms, against 7 x 48.8 MB plus
//     bias, dbias, gate and dgate, 349 MB, 0.104 ms: bound by operations.
// The design runs seven tile products where the algorithm needs five (S
// and dP are formed by both the dQ and the dK/dV kernel), and nine for K3
// (its dbias kernel forms them again), so it can reach at best 5/7 of the
// bound; mma.sync reaches about two thirds of the tensor cores' rate.
//
// Design (the bf16 kernels' structure on fp32 tiles: a forward, then the
// backward's dq_kernel / dkv_kernel / dbias_kernel / sum_chunks_kernel).
// Every block has 4 warps and owns 64 rows (queries, or keys in dK/dV), 16
// a warp, and streams the other operand's tiles of 32 rows through a
// cp.async double buffer. Tiles
// are fp32 in shared memory at a row stride of D + 4 floats (4 times an
// odd number): the A and B fragments of m16n8k8 read (row g, column t) and
// (row 2t, column g) patterns, both free of bank conflicts at that stride,
// so scalar 4-byte loads feed the products without ldmatrix (which moves
// 16-bit halves). The products read their A operand from shared memory one
// k-step at a time (split once, reused over the tile's four or kD/8 n
// blocks) and their B fragments as they go, so a thread holds its
// accumulators and little else: at D=64 the dQ and dK/dV kernels take 70 KB
// of shared memory and run three blocks an SM, at D=80 and 96 two (86 and
// 102 KB), at 128 one (135 KB); the forward holds Q and the streamed K and
// V tiles, 52 KB at 64 (three blocks an SM), 102 KB at 128 (two). S (or dP)
// leaves the accumulator as the A operand of the next product without a
// trip through shared memory: the
// m16n8k8 accumulator holds columns 2t and 2t+1 of a row where the A
// fragment wants t and t+4, so the contraction runs permuted inside each
// block of 8 (P's column 2t at k = t, 2t+1 at k = t+4, and the B rows with
// them), which leaves the sum unchanged.
//   - forward (one block per query tile, head, item): per key tile S = QKᵀ,
//     formed as the dQ kernel forms it (the same split, tiles and k-order,
//     so the same sums bit for bit), the logits L·log2e with the gate and
//     bias added in registers (the bias read as scalars from L2), an online
//     softmax in log2 units (a running row max, the row sum and O rescaled
//     by exp2 of its move; exp2 of −inf gives 0, and a shift of 0 while the
//     max is −inf keeps a fully padded row from NaN until its last
//     division), then O += P·V with P straight from the accumulator. At the
//     end O / Σ through the caller's strides and, when asked,
//     LSE = (max + log2 Σ)·ln 2. The backward then rebuilds P from the LSE
//     of the very logits it recomputes. Q is split into its TF32 halves at
//     each key tile, as the dQ kernel does: kept split in registers (at
//     D ≤ 64, 64 more a thread) the kernels spilled at three blocks an SM
//     and ran slower at two.
//   - dQ (one block per query tile, head, item): Δ from O and dO first,
//     then per key tile S = QKᵀ, dP = dO·Vᵀ, P = exp2(L·log2e − LSE·log2e),
//     dS, dQ += dS·K, the row sums Σ P and Σ P·dP and the keys' column
//     sums; the gated variant also sums bias ∘ dL (dgate) and bias ∘ P in
//     registers. At the end it corrects dQ and dgate and writes Δ' and the
//     rebased LSE.
//   - dK/dV (one block per key tile, head, item): per query tile Sᵀ = K·Qᵀ,
//     Pᵀ, dV += Pᵀ·dO, dPᵀ = V·dOᵀ, dSᵀ, dK += dSᵀ·Q; the gated variant
//     reads the bias transposed as scalars from L2.
//   - dbias (gated): one block per (query tile, key tile, head, chunk of
//     batch items) walks its items, rebuilds S and dP and sums gate ⊙ dL in
//     registers; a last pass adds the chunks' partials in chunk order. No
//     atomics anywhere: every output is deterministic. Any T.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

// The head width of this build (see kHeadDim below), set with -DAVEX_HEAD_DIM.
#ifndef AVEX_HEAD_DIM
#define AVEX_HEAD_DIM 64
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwn = 16 * kWarps;  // rows a block owns
constexpr int kN = 32;           // rows of a streamed tile
constexpr int kNB = kN / 8;        // its blocks of 8 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared tiles of kD-wide fp32 rows (kD a multiple of 8 up to 128) at a row
// stride of kD + 4 floats, and each kernel's shared bytes.
template <int kD>
struct Tile {
  static_assert(kD % 8 == 0 && kD >= 8 && kD <= 128, "head widths: multiples of 8 up to 128");
  static constexpr int kLd = kD + 4;      // 4·odd floats: no bank conflicts for either fragment pattern
  static constexpr int kChunks = kD / 4;  // 16-byte chunks of a row
  static constexpr int kOwnTile = kOwn * kLd;
  static constexpr int kTile = kN * kLd;
  static constexpr size_t kFwdSmem = sizeof(float) * (kOwnTile + 4 * kTile + 2 * kN);
  static constexpr size_t kDqSmem = sizeof(float) * (2 * kOwnTile + 4 * kTile + 2 * kN + kOwn + kD);
  static constexpr size_t kDkvSmem = sizeof(float) * (2 * kOwnTile + 4 * kTile + 6 * kN);
  static constexpr size_t kDbiasSmem = sizeof(float) * (2 * (2 * kOwnTile + 2 * kTile) + 2 * kN + 6 * kOwn);
};

// Blocks an SM resident at once, which bounds ptxas's registers: what the dQ
// and dK/dV kernels' shared memory allows (above), and one block fewer for
// dbias, which double-buffers its own tiles too.
template <int kD>
constexpr int kMinBlocks = kD <= 64 ? 3 : (kD <= 96 ? 2 : 1);
template <int kD>
constexpr int kDbiasMinBlocks = kD <= 64 ? 2 : 1;
// The forward's blocks an SM: what its shared memory (Q, and the
// double-buffered K and V tiles: 52 KB at 64, 65 KB at 80, 102 KB at 128)
// allows, and at 80 what its registers allow without spilling (at three
// blocks, 168 registers, the gated kernel spilled).
template <int kD>
constexpr int kFwdMinBlocks = kD <= 32 ? 4 : (kD <= 64 ? 3 : 2);

// Element strides (batch, head, token) of the forward's q, k, v and out, then
// pad (batch, token).
struct FwdStrides {
  long long q[3], k[3], v[3], o[3];
  long long pad[2];
};

// Element strides (batch, head, token) of q, k, v, out, dout, dq, dk and dv,
// then pad (batch, token).
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
  long long pad[2];
};

// The gated operands: fp32 bias [H, T, T] and gate [B, H, T] with their
// element strides; gate may be null (a gate of 1).
struct Gated {
  const float* bias = nullptr;
  const float* gate = nullptr;
  long long bs[3] = {0, 0, 0}, gs[3] = {0, 0, 0};
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows r0 .. r0+kRows-1 of a [seq, dim] operand with row stride rs into a
// tile, asynchronously; rows past seq and the chunks of columns dim .. kD-1
// (dc = dim / 4 chunks are the operand's: in the fused [B, T, 3E] layout the
// rest are the next head's) are zero-filled, the copy reading nothing.
template <int kD, int kRows>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long rs, int r0, int seq, int dc) {
  constexpr int kChunks = Tile<kD>::kChunks, kLd = Tile<kD>::kLd;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int row = (unsigned)c / kChunks, chunk = (unsigned)c % kChunks;
    const bool ok = r0 + row < seq && chunk < dc;
    const float* src = ok ? base + (long long)(r0 + row) * rs + chunk * 4 : base;
    cp_async16(tile + row * kLd + chunk * 4, src, ok);
  }
}

// A staged tile's rows r0 .. r0+kRows-1 (those below seq; dc chunks of 4
// columns) to a [seq, dim] operand.
template <int kD, int kRows>
__device__ __forceinline__ void store_tile(float* base, long long rs, int r0, int seq, int dc, const float* tile) {
  constexpr int kChunks = Tile<kD>::kChunks, kLd = Tile<kD>::kLd;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int row = (unsigned)c / kChunks, chunk = (unsigned)c % kChunks;
    if (r0 + row < seq && chunk < dc)
      *reinterpret_cast<float4*>(base + (long long)(r0 + row) * rs + chunk * 4) =
          *reinterpret_cast<const float4*>(tile + row * kLd + chunk * 4);
  }
}

// The additive key bias of keys k0 .. k0+kN-1: −inf past seq or where padded.
__device__ __forceinline__ void load_key_bias(float* bias, const uint8_t* pad_b, long long ps, int k0, int seq) {
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    const int key = k0 + i;
    bias[i] = (key >= seq || (pad_b && pad_b[key * ps])) ? -INFINITY : 0.f;
  }
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi is x in TF32 (its 13 low bits cleared, so that x − hi is
// exact), lo what that dropped, in TF32 (the mma reads its top 19 bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x) & 0xffffe000u;
  lo = tf32(x - __uint_as_float(hi));
}

// An A fragment of m16n8k8 split into its TF32 halves.
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split4(const float x[4], Frag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f.hi[i], f.lo[i]);
}

// c[16x8] += a[16x8] · b[8x8], TF32 in, fp32 accumulate. Not volatile: the
// compiler may interleave independent products.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += a · b[j] in 3xTF32 for kG accumulators sharing one A fragment,
// b[j]'s fragment given in fp32 (b[j][0], b[j][1]): every lo·hi, then every
// hi·lo, then every hi·hi, so that kG independent products stand between
// two that add into one accumulator. Unless kFull, only j < live.
template <int kG, bool kFull>
__device__ __forceinline__ void mma3(float* const c[kG], const Frag& a, const float b[kG][2], int live) {
  uint32_t hi[kG][2], lo[kG][2];
#pragma unroll
  for (int j = 0; j < kG; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) split(b[j][e], hi[j][e], lo[j][e]);
#pragma unroll
  for (int j = 0; j < kG; ++j)
    if (kFull || j < live) mma(c[j], a.lo, hi[j][0], hi[j][1]);
#pragma unroll
  for (int j = 0; j < kG; ++j)
    if (kFull || j < live) mma(c[j], a.hi, lo[j][0], lo[j][1]);
#pragma unroll
  for (int j = 0; j < kG; ++j)
    if (kFull || j < live) mma(c[j], a.hi, hi[j][0], hi[j][1]);
}

// k-steps of 8 unrolled at once: two. Unrolling the whole width let ptxas
// hoist every k-step's loads, which spilled at the bounds above (three
// blocks an SM at 64) and ran slower.
constexpr int kUnroll = 2;

// acc[16 x 8·kNB] += A · Bᵀ: A the warp's 16 rows (from row0) of tile a, B
// the first 8·kNB rows of tile b; both kD wide, the contraction. Unless
// kFull, only the first `live` blocks of 8 rows of b are multiplied.
template <int kD, bool kFull>
__device__ __forceinline__ void mma_abt(float acc[][4], const float* a, int row0, const float* b, int live) {
  constexpr int kLd = Tile<kD>::kLd, kU = kUnroll;
  static_assert((kD / 8) % kU == 0, "whole unrolled groups of k-steps");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* c[kNB];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) c[nb] = acc[nb];
#pragma unroll 1
  for (int k0 = 0; k0 < kD / 8; k0 += kU) {
    const float* ap = a + (row0 + g) * kLd + 8 * k0 + t;
    const float* bp = b + g * kLd + 8 * k0 + t;
#pragma unroll
    for (int kk = 0; kk < kU; ++kk) {
      // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) of the k-step's 8 columns
      const float x[4] = {ap[8 * kk], ap[8 * kLd + 8 * kk], ap[8 * kk + 4], ap[8 * kLd + 8 * kk + 4]};
      Frag f;
      split4(x, f);
      float bv[kNB][2];  // b0 (k t, n g), b1 (k t+4, n g): row 8nb + g of the tile
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        bv[nb][0] = bp[nb * 8 * kLd + 8 * kk];
        bv[nb][1] = bp[nb * 8 * kLd + 8 * kk + 4];
      }
      mma3<kNB, kFull>(c, f, bv, live);
    }
  }
}

// acc[16 x kD] += P · B: P [16 x kN] in the accumulator layout (p[kk] its
// columns 8kk .. 8kk+7: this lane's rows g and g+8, columns 2t and 2t+1), B
// the tile's 32 rows (the contraction) by kD columns. Inside each block of
// 8 the contraction is permuted: P's column 2t stands at k = t and 2t+1 at
// k = t+4, and B's rows 2t and 2t+1 with them. Unless kFull, only the first
// `live` blocks of 8 rows of B are read.
template <int kD, bool kFull>
__device__ __forceinline__ void mma_ab(float acc[][4], const float p[][4], const float* b, int live) {
  constexpr int kLd = Tile<kD>::kLd;
  // Groups of 4 accumulators, or 2 of 5 at kD 80 (the other widths' kD / 8 are multiples of 4).
  constexpr int kGroups = kD / 8 % 4 == 0 ? kD / 32 : 2;
  constexpr int kPer = kD / 8 / kGroups;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* bp = b + 2 * t * kLd + g;
#pragma unroll
  for (int kk = 0; kk < kNB; ++kk) {
    if (kFull || kk < live) {
      const float x[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      Frag f;
      split4(x, f);
#pragma unroll
      for (int gr = 0; gr < kGroups; ++gr) {
        float* c[kPer];
        float bv[kPer][2];  // b0 (k t, n g), b1 (k t+4, n g): rows 8kk + 2t and 8kk + 2t + 1, column 8nb + g
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int nb = gr * kPer + j;
          c[j] = acc[nb];
          bv[j][0] = bp[8 * kk * kLd + 8 * nb];
          bv[j][1] = bp[(8 * kk + 1) * kLd + 8 * nb];
        }
        mma3<kPer, true>(c, f, bv, kPer);
      }
    }
  }
}

template <int kD>
__device__ __forceinline__ void mma_abt_live(float acc[][4], const float* a, int row0, const float* b, int live) {
  if (live == kNB)
    mma_abt<kD, true>(acc, a, row0, b, live);
  else
    mma_abt<kD, false>(acc, a, row0, b, live);
}

template <int kD>
__device__ __forceinline__ void mma_ab_live(float acc[][4], const float p[][4], const float* b, int live) {
  if (live == kNB)
    mma_ab<kD, true>(acc, p, b, live);
  else
    mma_ab<kD, false>(acc, p, b, live);
}

template <int kCols>
__device__ __forceinline__ void zero(float c[][4]) {
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// The warp's accumulator rows (kD columns) into a tile.
template <int kD>
__device__ __forceinline__ void stage(float* tile, int row0, const float c[][4]) {
  constexpr int kLd = Tile<kD>::kLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(tile + (row0 + g + 8 * i) * kLd + 8 * j + 2 * t) =
          make_float2(c[j][2 * i], c[j][2 * i + 1]);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x in one MUFU instruction (inputs below -126 flush to 0; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Blocks of 8 rows of the streamed tile at r0 that hold a row below seq.
__device__ __forceinline__ int live_blocks(int r0, int seq) { return min(kNB, (seq - r0 + 7) >> 3); }

// The gate of (item b, head h, row qi), 1 without a gate.
__device__ __forceinline__ float gate_at(const Gated& gd, int b, int h, int qi) {
  return gd.gate ? __ldg(gd.gate + b * gd.gs[0] + h * gd.gs[1] + qi * gd.gs[2]) : 1.f;
}

// This lane's bias in the accumulator layout of the key tile at k0
// (bf[j][2i + e]: row g + 8i of the warp's rows from r0, key k0 + 8j + 2t +
// e), scalars from L2; rows and keys past seq are clamped to the last (their
// results are never used).
__device__ __forceinline__ void fetch_bias(float bf[][4], const Gated& gd, int h, int r0, int k0, int seq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* row = gd.bias + h * gd.bs[0] + min(r0 + g + 8 * i, seq - 1) * gd.bs[1];
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) bf[j][2 * i + e] = __ldg(row + min(k0 + 8 * j + 2 * t + e, seq - 1) * gd.bs[2]);
  }
}

// The forward: one block per (query tile of 64, head, item) walks the key
// tiles with an online softmax in log2 units and writes O (and the row
// log-sum-exp when lse is not null).
template <int kD, bool kGated>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks<kD>)
tf32x3_forward_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const uint8_t* __restrict__ pad, float* __restrict__ out, float* __restrict__ lse, int heads,
                      int seq, int dim, float scale, FwdStrides s, Gated gd) {
  using TL = Tile<kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [64][kLd]: Q, then O
  float* k_s = q_s + TL::kOwnTile;              // [2][kN][kLd]
  float* v_s = k_s + 2 * TL::kTile;             // [2][kN][kLd]
  float* kbias_s = v_s + 2 * TL::kTile;         // [2][kN]

  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const bool active = q0 + row0 < seq;  // warp-uniform: the warp has a query below seq
  const float* kb = k + b * s.k[0] + h * s.k[1];
  const float* vb = v + b * s.v[0] + h * s.v[1];
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
  const int n_tiles = (seq + kN - 1) / kN;
  const int dc = dim >> 2;
  const float c = scale * kLog2e;

  load_tile<kD, kOwn>(q_s, q + b * s.q[0] + h * s.q[1], s.q[2], q0, seq, dc);
  load_tile<kD, kN>(k_s, kb, s.k[2], 0, seq, dc);
  load_tile<kD, kN>(v_s, vb, s.v[2], 0, seq, dc);
  load_key_bias(kbias_s, pad_b, s.pad[1], 0, seq);
  cp_async_commit();

  // This lane's rows g and g+8: the running max of the logits in log2 units
  // (−inf while every key so far is padded), its part of the row sum, and
  // for the gated variant gate·log2e.
  float mx[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f}, gl[2] = {0.f, 0.f};
  if (kGated) {
#pragma unroll
    for (int i = 0; i < 2; ++i) gl[i] = gate_at(gd, b, h, min(q0 + row0 + g + 8 * i, seq - 1)) * kLog2e;
  }
  float acc[kD / 8][4];
  zero<kD>(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = buf ^ 1, k0n = (it + 1) * kN;
      load_tile<kD, kN>(k_s + nxt * TL::kTile, kb, s.k[2], k0n, seq, dc);
      load_tile<kD, kN>(v_s + nxt * TL::kTile, vb, s.v[2], k0n, seq, dc);
      load_key_bias(kbias_s + nxt * kN, pad_b, s.pad[1], k0n, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int live = live_blocks(it * kN, seq);
      const float* kbias = kbias_s + buf * kN;
      float bf[kNB][4];  // the gated variant's bias, issued before the product
      if (kGated) fetch_bias(bf, gd, h, q0 + row0, it * kN, seq);
      float sc[kNB][4];
      zero<kN>(sc);
      mma_abt_live<kD>(sc, q_s, row0, k_s + buf * TL::kTile, live);  // S = Q·Kᵀ
      // The logits in log2 units, as the dQ kernel forms them; the row max.
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float kbv = kbias[8 * j + 2 * t + (e & 1)];
          sc[j][e] = kGated ? fmaf(sc[j][e], c, bf[j][e] * gl[i] + kbv) : fmaf(sc[j][e], c, kbv);
          tmax[i] = fmaxf(tmax[i], sc[j][e]);
        }
      float shift[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
        const float m_new = fmaxf(mx[i], tmax[i]);
        // While every key so far is padded, m stays −inf: shift by 0, so that
        // exp2 sees −inf − 0 and gives 0 rather than NaN.
        shift[i] = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2_approx(mx[i] - shift[i]);
        mx[i] = m_new;
        lsum[i] *= corr;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          acc[j][2 * i] *= corr;
          acc[j][2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2_approx(sc[j][e] - shift[e >> 1]);  // P, unnormalised
          lsum[e >> 1] += sc[j][e];
        }
      mma_ab_live<kD>(acc, sc, v_s + buf * TL::kTile, live);  // O += P·V
    }
    __syncthreads();
  }

  if (active) {
    const long long stat0 = ((long long)b * heads + h) * seq;
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sum = quad_sum(lsum[i]);
      const int qi = q0 + row0 + g + 8 * i;
      // A row whose keys are all padded: sum 0, O = 0 · (1/0) = NaN as the
      // twin's softmax gives, and LSE −inf.
      inv[i] = 1.f / sum;
      if (lse && t == 0 && qi < seq) lse[stat0 + qi] = (mx[i] + log2f(sum)) * kLn2;
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];
    stage<kD>(q_s, row0, acc);  // the warp's own rows of Q's tile, which it alone read
  }
  __syncthreads();
  store_tile<kD, kOwn>(out + b * s.o[0] + h * s.o[1], s.o[2], q0, seq, dc, q_s);
}

// The dQ kernel: one block per (query tile of 64, head, item).
template <int kD, bool kGated>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kD>)
tf32x3_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ out, const float* __restrict__ dout, const uint8_t* __restrict__ pad,
                 const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta,
                 float* __restrict__ dgate, int heads, int seq, int dim, float scale, BwdStrides s, Gated gd) {
  using TL = Tile<kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [64][kLd]
  float* do_s = q_s + TL::kOwnTile;             // [64][kLd]
  float* k_s = do_s + TL::kOwnTile;             // [2][kN][kLd]
  float* v_s = k_s + 2 * TL::kTile;             // [2][kN][kLd]
  float* kbias_s = v_s + 2 * TL::kTile;         // [2][kN]
  float* delta_s = kbias_s + 2 * kN;            // [64]
  float* kbar_s = delta_s + kOwn;               // [kD], the keys' mean

  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const bool active = q0 + row0 < seq;  // warp-uniform: the warp has a query below seq
  const float* qb = q + b * s.q[0] + h * s.q[1];
  const float* kb = k + b * s.k[0] + h * s.k[1];
  const float* vb = v + b * s.v[0] + h * s.v[1];
  const float* dob = dout + b * s.dout[0] + h * s.dout[1];
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
  const long long stat0 = ((long long)b * heads + h) * seq;
  const int n_tiles = (seq + kN - 1) / kN;
  const int dc = dim >> 2;
  const float c = scale * kLog2e;

  load_tile<kD, kOwn>(q_s, qb, s.q[2], q0, seq, dc);
  load_tile<kD, kOwn>(do_s, dob, s.dout[2], q0, seq, dc);
  load_tile<kD, kN>(k_s, kb, s.k[2], 0, seq, dc);
  load_tile<kD, kN>(v_s, vb, s.v[2], 0, seq, dc);
  load_key_bias(kbias_s, pad_b, s.pad[1], 0, seq);
  cp_async_commit();

  // Δ = rowsum(dO ∘ O) for the block's rows, two threads a row, while the
  // first tiles arrive.
  {
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1, qi = q0 + r;
    float acc = 0.f;
    if (qi < seq) {
      const float* orow = out + b * s.o[0] + h * s.o[1] + (long long)qi * s.o[2];
      const float* drow = dob + (long long)qi * s.dout[2];
      for (int c4 = part; c4 < dc; c4 += 2) {
        const float4 o4 = *reinterpret_cast<const float4*>(orow + 4 * c4);
        const float4 d4 = *reinterpret_cast<const float4*>(drow + 4 * c4);
        acc = fmaf(o4.x, d4.x, acc);
        acc = fmaf(o4.y, d4.y, acc);
        acc = fmaf(o4.z, d4.z, acc);
        acc = fmaf(o4.w, d4.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) delta_s[r] = acc;
  }
  // This lane's rows g and g+8: LSE in log2 units (+inf past seq: P = 0), Δ,
  // and for the gated variant gate·log2e and its part of dgate; its parts of
  // the row sums Σ P, Σ P·dP and (gated) Σ bias·P.
  float lse2[2], dl[2] = {0.f, 0.f}, gl[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f};
  float psum[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f}, bp[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + g + 8 * i;
    lse2[i] = qi < seq ? lse[stat0 + qi] * kLog2e : INFINITY;
    if (kGated) gl[i] = gate_at(gd, b, h, min(qi, seq - 1)) * kLog2e;
  }

  float acc[kD / 8][4];
  zero<kD>(acc);
  float kcol = 0.f;  // threads below kD: column threadIdx.x of Σ_k K (rows past seq are zero)
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = buf ^ 1, k0n = (it + 1) * kN;
      load_tile<kD, kN>(k_s + nxt * TL::kTile, kb, s.k[2], k0n, seq, dc);
      load_tile<kD, kN>(v_s + nxt * TL::kTile, vb, s.v[2], k0n, seq, dc);
      load_key_bias(kbias_s + nxt * kN, pad_b, s.pad[1], k0n, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (threadIdx.x < kD) {
      const float* col = k_s + buf * TL::kTile + threadIdx.x;
#pragma unroll 8
      for (int r = 0; r < kN; ++r) kcol += col[r * TL::kLd];
    }
    if (active) {
      if (it == 0) dl[0] = delta_s[row0 + g], dl[1] = delta_s[row0 + g + 8];
      const int live = live_blocks(it * kN, seq);
      const float* kt = k_s + buf * TL::kTile;
      const float* kbias = kbias_s + buf * kN;
      float bf[kNB][4];  // the gated variant's bias, issued before the products
      if (kGated) fetch_bias(bf, gd, h, q0 + row0, it * kN, seq);
      float sc[kNB][4], dp[kNB][4];
      zero<kN>(sc);
      zero<kN>(dp);
      mma_abt_live<kD>(sc, q_s, row0, kt, live);                    // S = Q·Kᵀ
      mma_abt_live<kD>(dp, do_s, row0, v_s + buf * TL::kTile, live);  // dP = dO·Vᵀ
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float kbv = kbias[8 * j + 2 * t + (e & 1)];
          const float x = kGated ? fmaf(sc[j][e], c, bf[j][e] * gl[i] + kbv) : fmaf(sc[j][e], c, kbv);
          const float pv = exp2_approx(x - lse2[i]);
          const float dlv = pv * (dp[j][e] - dl[i]);  // dL = P∘(dP − Δ)
          psum[i] += pv;
          pdp[i] = fmaf(pv, dp[j][e], pdp[i]);
          if (kGated) {
            dg[i] = fmaf(bf[j][e], dlv, dg[i]);
            bp[i] = fmaf(bf[j][e], pv, bp[i]);
          }
          sc[j][e] = dlv * scale;  // dS
        }
      mma_ab_live<kD>(acc, sc, kt, live);  // dQ += dS·K
    }
    __syncthreads();
  }

  // The row's P, rebuilt from the forward's LSE, sums to Σ P = 1 + ε, ε a
  // few 2^-24 of the largest logit in log2 units (their rounding, and the
  // forward's other arithmetic), the same for every key of the row. dS
  // then sums over the keys to Δ·ε instead of 0, which dK = dSᵀ·Q carries
  // into every key and dQ = dS·K multiplies by the keys' common part: a
  // gradient that cancels over the tokens (a key or query projection's
  // weight) sees it whole. So the row's statistics are taken over this P:
  // P' = P / Σ P and Δ' = Σ P·dP / Σ P, for which Σ_k dS is 0 to
  // rounding. The dK/dV and dbias kernels read Δ' and the LSE rebased by
  // log2 Σ P from delta; dQ and dgate are corrected here. With dS_k the
  // loop's (from Δ) and K̄ the keys' mean,
  //   dQ' = (Σ_k dS_k·K_k − (Σ_k dS_k)·K̄) / Σ P,
  //   dgate' = (dgate + (Δ − Δ')·Σ bias·P) / Σ P,
  // dgate' exact, dQ' leaving out scale·(Δ − Δ')·(Σ_k P'_k·K_k − K̄), which
  // holds no common part of the keys.
  if (threadIdx.x < kD) kbar_s[threadIdx.x] = kcol / seq;
  __syncthreads();
  if (active) {
    const long long rebased = (long long)gridDim.z * heads * seq;
    float inv[2], sds[2];  // 1 / Σ P and Σ_k dS of rows g and g+8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sum = quad_sum(psum[i]), pdps = quad_sum(pdp[i]), dgs = quad_sum(dg[i]);
      const float bps = quad_sum(bp[i]), dnew = pdps / sum;
      const int qi = q0 + row0 + g + 8 * i;
      inv[i] = 1.f / sum;
      sds[i] = scale * (pdps - dl[i] * sum);
      if (t == 0 && qi < seq) {
        delta[stat0 + qi] = dnew;
        delta[rebased + stat0 + qi] = lse2[i] + log2f(sum);
        if (kGated && dgate) dgate[stat0 + qi] = (dgs + (dl[i] - dnew) * bps) * inv[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = (acc[j][e] - sds[e >> 1] * kbar_s[8 * j + 2 * t + (e & 1)]) * inv[e >> 1];
    stage<kD>(q_s, row0, acc);
  }
  __syncthreads();
  store_tile<kD, kOwn>(dq + b * s.dq[0] + h * s.dq[1], s.dq[2], q0, seq, dc, q_s);
}

// The dK/dV kernel: one block per (key tile of 64, head, item).
template <int kD, bool kGated>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kD>)
tf32x3_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ dout, const uint8_t* __restrict__ pad, const float* __restrict__ lse2,
                  const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int heads,
                  int seq, int dim, float scale, BwdStrides s, Gated gd) {
  using TL = Tile<kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [64][kLd]
  float* v_s = k_s + TL::kOwnTile;              // [64][kLd]
  float* q_s = v_s + TL::kOwnTile;              // [2][kN][kLd]
  float* do_s = q_s + 2 * TL::kTile;            // [2][kN][kLd]
  float* lse_s = do_s + 2 * TL::kTile;          // [2][kN], log2 units
  float* dl_s = lse_s + 2 * kN;                 // [2][kN]
  float* gl_s = dl_s + 2 * kN;                  // [2][kN], the gated variant's gate·log2e

  const int k0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const bool active = k0 + row0 < seq;  // the warp has a key below seq
  const float* qb = q + b * s.q[0] + h * s.q[1];
  const float* dob = dout + b * s.dout[0] + h * s.dout[1];
  const long long stat0 = ((long long)b * heads + h) * seq;
  const int n_tiles = (seq + kN - 1) / kN;
  const int dc = dim >> 2;
  const float c = scale * kLog2e;

  // The statistics of queries q0 .. q0+kN-1 (the dQ kernel's rebased LSE
  // in log2 units and Δ'): past seq an LSE of +inf gives P = 0 and a Δ of 0
  // gives dS = 0.
  auto load_stats = [&](int slot, int q0) {
    for (int i = threadIdx.x; i < kN; i += kThreads) {
      const int qi = q0 + i;
      lse_s[slot * kN + i] = qi < seq ? lse2[stat0 + qi] : INFINITY;
      dl_s[slot * kN + i] = qi < seq ? delta[stat0 + qi] : 0.f;
      if (kGated) gl_s[slot * kN + i] = gate_at(gd, b, h, min(qi, seq - 1)) * kLog2e;
    }
  };

  load_tile<kD, kOwn>(k_s, k + b * s.k[0] + h * s.k[1], s.k[2], k0, seq, dc);
  load_tile<kD, kOwn>(v_s, v + b * s.v[0] + h * s.v[1], s.v[2], k0, seq, dc);
  load_tile<kD, kN>(q_s, qb, s.q[2], 0, seq, dc);
  load_tile<kD, kN>(do_s, dob, s.dout[2], 0, seq, dc);
  load_stats(0, 0);
  cp_async_commit();

  float kbias[2];                // this lane's keys g and g+8
  const float* bias_col[2];      // the gated variant: their bias columns (keys past seq clamped)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + g + 8 * i;
    kbias[i] = (key >= seq || (pad && pad[b * s.pad[0] + key * s.pad[1]])) ? -INFINITY : 0.f;
    bias_col[i] = kGated ? gd.bias + h * gd.bs[0] + min(key, seq - 1) * gd.bs[2] : nullptr;
  }

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
  zero<kD>(dk_acc);
  zero<kD>(dv_acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = buf ^ 1, q0n = (it + 1) * kN;
      load_tile<kD, kN>(q_s + nxt * TL::kTile, qb, s.q[2], q0n, seq, dc);
      load_tile<kD, kN>(do_s + nxt * TL::kTile, dob, s.dout[2], q0n, seq, dc);
      load_stats(nxt, q0n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int live = live_blocks(it * kN, seq);
      const float* qt = q_s + buf * TL::kTile;
      const float* dot = do_s + buf * TL::kTile;
      const float* lq = lse_s + buf * kN;
      const float* dlq = dl_s + buf * kN;
      const float* glq = gl_s + buf * kN;
      // The gated variant's bias, transposed: bt[j][2i + e] = bias[query
      // 8j + 2t + e][key g + 8i], scalars from L2 issued before the product.
      float bt[kNB][4];
      if (kGated) {
#pragma unroll
        for (int j = 0; j < kNB; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long qo = min(it * kN + 8 * j + 2 * t + e, seq - 1) * gd.bs[1];
            bt[j][e] = __ldg(bias_col[0] + qo);
            bt[j][2 + e] = __ldg(bias_col[1] + qo);
          }
      }
      float st[kNB][4];
      zero<kN>(st);
      mma_abt_live<kD>(st, k_s, row0, qt, live);  // Sᵀ = K·Qᵀ
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const float x = kGated ? fmaf(st[j][e], c, bt[j][e] * glq[col] + kbias[e >> 1])
                                 : fmaf(st[j][e], c, kbias[e >> 1]);
          st[j][e] = exp2_approx(x - lq[col]);  // Pᵀ
        }
      mma_ab_live<kD>(dv_acc, st, dot, live);  // dV += Pᵀ·dO
      float dpt[kNB][4];
      zero<kN>(dpt);
      mma_abt_live<kD>(dpt, v_s, row0, dot, live);  // dPᵀ = V·dOᵀ
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= (dpt[j][e] - dlq[8 * j + 2 * t + (e & 1)]) * scale;  // dSᵀ
      mma_ab_live<kD>(dk_acc, st, qt, live);  // dK += dSᵀ·Q
    }
    __syncthreads();
  }

  if (active) {
    stage<kD>(k_s, row0, dk_acc);
    stage<kD>(v_s, row0, dv_acc);
  }
  __syncthreads();
  store_tile<kD, kOwn>(dk + b * s.dk[0] + h * s.dk[1], s.dk[2], k0, seq, dc, k_s);
  store_tile<kD, kOwn>(dv + b * s.dv[0] + h * s.dv[1], s.dv[2], k0, seq, dc, v_s);
}

// The gated dbias over one chunk of `items` batch items: one block per
// (query tile of 64, key tile of kN, head, chunk), blockIdx.z = chunk ·
// heads + h. It walks its items in order with the next item's tiles in
// flight, rebuilds S and dP, P from the LSE and dL with the Δ' the dQ
// kernel wrote, keeps Σ gate ⊙ dL in registers and writes it to out[chunk].
template <int kD>
__global__ void __launch_bounds__(kThreads, kDbiasMinBlocks<kD>)
tf32x3_dbias_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const uint8_t* __restrict__ pad, const float* __restrict__ lse2,
                    const float* __restrict__ delta, float* __restrict__ out, int batch, int items, int heads,
                    int seq, int dim, float scale, BwdStrides s, Gated gd) {
  using TL = Tile<kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [2][64][kLd]
  float* do_s = q_s + 2 * TL::kOwnTile;         // [2][64][kLd]
  float* k_s = do_s + 2 * TL::kOwnTile;         // [2][kN][kLd]
  float* v_s = k_s + 2 * TL::kTile;             // [2][kN][kLd]
  float* kbias_s = v_s + 2 * TL::kTile;         // [2][kN]
  float* lse_s = kbias_s + 2 * kN;              // [2][64], log2 units
  float* dl_s = lse_s + 2 * kOwn;               // [2][64]
  float* g_s = dl_s + 2 * kOwn;                 // [2][64]

  const int q0 = blockIdx.x * kOwn, k0 = blockIdx.y * kN, h = blockIdx.z % heads, chunk = blockIdx.z / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const bool active = q0 + row0 < seq;
  const int live = live_blocks(k0, seq);
  const int b0 = chunk * items, b_end = min(batch, b0 + items);
  const int dc = dim >> 2;
  const float c = scale * kLog2e;

  // Item b's tiles and row statistics into slot `slot`; rows past seq get an
  // LSE of +inf (P = 0) and a Δ of 0.
  auto issue = [&](int slot, int b) {
    load_tile<kD, kOwn>(q_s + slot * TL::kOwnTile, q + b * s.q[0] + h * s.q[1], s.q[2], q0, seq, dc);
    load_tile<kD, kOwn>(do_s + slot * TL::kOwnTile, dout + b * s.dout[0] + h * s.dout[1], s.dout[2], q0, seq, dc);
    load_tile<kD, kN>(k_s + slot * TL::kTile, k + b * s.k[0] + h * s.k[1], s.k[2], k0, seq, dc);
    load_tile<kD, kN>(v_s + slot * TL::kTile, v + b * s.v[0] + h * s.v[1], s.v[2], k0, seq, dc);
    load_key_bias(kbias_s + slot * kN, pad ? pad + b * s.pad[0] : nullptr, s.pad[1], k0, seq);
    const long long stat0 = ((long long)b * heads + h) * seq;
    for (int i = threadIdx.x; i < kOwn; i += kThreads) {
      const int qi = q0 + i;
      lse_s[slot * kOwn + i] = qi < seq ? lse2[stat0 + qi] : INFINITY;
      dl_s[slot * kOwn + i] = qi < seq ? delta[stat0 + qi] : 0.f;
      g_s[slot * kOwn + i] = gate_at(gd, b, h, min(qi, seq - 1));
    }
  };

  issue(0, b0);
  cp_async_commit();
  float bf[kNB][4];  // the tile's bias, the same for every item
  fetch_bias(bf, gd, h, q0 + row0, k0, seq);

  float acc[kNB][4];
  zero<kN>(acc);
  for (int b = b0; b < b_end; ++b) {
    const int buf = (b - b0) & 1;
    if (b + 1 < b_end) {
      issue(buf ^ 1, b + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      float sc[kNB][4], dp[kNB][4];
      zero<kN>(sc);
      zero<kN>(dp);
      mma_abt_live<kD>(sc, q_s + buf * TL::kOwnTile, row0, k_s + buf * TL::kTile, live);   // S = Q·Kᵀ
      mma_abt_live<kD>(dp, do_s + buf * TL::kOwnTile, row0, v_s + buf * TL::kTile, live);  // dP = dO·Vᵀ
      const float* kbias = kbias_s + buf * kN;
      float lse2[2], dlt[2], gv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = buf * kOwn + row0 + g + 8 * i;
        lse2[i] = lse_s[r];
        dlt[i] = dl_s[r];
        gv[i] = g_s[r];
      }
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float x = fmaf(sc[j][e], c, bf[j][e] * (gv[i] * kLog2e) + kbias[8 * j + 2 * t + (e & 1)]);
          const float dlv = exp2_approx(x - lse2[i]) * (dp[j][e] - dlt[i]);  // dL
          acc[j][e] = fmaf(gv[i], dlv, acc[j][e]);
        }
    }
    __syncthreads();  // every warp is done with this item's buffers
  }

  if (active) {
    float* base = out + ((long long)chunk * heads + h) * seq * seq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + row0 + g + 8 * i;
      if (qi >= seq) continue;
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
          if (key < seq) base[(long long)qi * seq + key] = acc[j][2 * i + e];
        }
    }
  }
}

// dbias = Σ_c part[c], in chunk order: the same sum on every call.
__global__ void sum_chunks_kernel(const float* __restrict__ part, float* __restrict__ out, long long n, int chunks) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    float sum = part[i];
    for (int c = 1; c < chunks; ++c) sum += part[c * n + i];
    out[i] = sum;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The head width this library's kernels are built for (kD), set per build
// with -DAVEX_HEAD_DIM: 32, 64, 80, 96 or 128 (the wrapper builds one
// library a width). A call's head width D, a multiple of 8 up to kD, runs
// on it with columns D .. kD-1 zero-filled on load and never stored: they
// add 0 to every product and to Δ, so the result is exact.
constexpr int kHeadDim = AVEX_HEAD_DIM;
static_assert(kHeadDim == 32 || kHeadDim == 64 || kHeadDim == 80 || kHeadDim == 96 || kHeadDim == 128,
              "AVEX_HEAD_DIM: 32, 64, 80, 96 or 128");

template <bool kGated>
cudaError_t launch_forward(const void* q, const void* k, const void* v, const void* pad, void* out, void* lse,
                           int batch, int heads, int seq, int dim, float scale, const FwdStrides& s, const Gated& gd,
                           cudaStream_t st) {
  using TL = Tile<kHeadDim>;
  cudaError_t err = allow_smem(tf32x3_forward_kernel<kHeadDim, kGated>, TL::kFwdSmem);
  if (err != cudaSuccess) return err;
  tf32x3_forward_kernel<kHeadDim, kGated><<<dim3((seq + kOwn - 1) / kOwn, heads, batch), kThreads, TL::kFwdSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<float*>(out), static_cast<float*>(lse), heads, seq, dim, scale, s,
      gd);
  return cudaGetLastError();
}

template <bool kGated>
cudaError_t launch_backward(const void* q, const void* k, const void* v, const void* out, const void* dout,
                            const void* pad, const void* lse, void* dq, void* dk, void* dv, void* delta,
                            void* dbias, void* dgate, void* part, int items, int batch, int heads, int seq, int dim,
                            float scale, const BwdStrides& s, const Gated& gd, cudaStream_t st) {
  using TL = Tile<kHeadDim>;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fdo = static_cast<const float*>(dout);
  const auto* fpad = static_cast<const uint8_t*>(pad);
  const auto* flse = static_cast<const float*>(lse);
  const dim3 own_grid((seq + kOwn - 1) / kOwn, heads, batch);
  // delta holds Δ' and, after it, the rebased LSE in log2 units (the dQ kernel's)
  const float* rebased = static_cast<const float*>(delta) + (long long)batch * heads * seq;

  cudaError_t err = allow_smem(tf32x3_dq_kernel<kHeadDim, kGated>, TL::kDqSmem);
  if (err != cudaSuccess) return err;
  tf32x3_dq_kernel<kHeadDim, kGated><<<own_grid, kThreads, TL::kDqSmem, st>>>(
      fq, fk, fv, static_cast<const float*>(out), fdo, fpad, flse, static_cast<float*>(dq),
      static_cast<float*>(delta), static_cast<float*>(dgate), heads, seq, dim, scale, s, gd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = allow_smem(tf32x3_dkv_kernel<kHeadDim, kGated>, TL::kDkvSmem);
  if (err != cudaSuccess) return err;
  tf32x3_dkv_kernel<kHeadDim, kGated><<<own_grid, kThreads, TL::kDkvSmem, st>>>(
      fq, fk, fv, fdo, fpad, rebased, static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), heads, seq, dim, scale, s, gd);
  if ((err = cudaGetLastError()) != cudaSuccess || !kGated) return err;

  const int chunks = (batch + items - 1) / items;
  const dim3 grid((seq + kOwn - 1) / kOwn, (seq + kN - 1) / kN, heads * chunks);
  err = allow_smem(tf32x3_dbias_kernel<kHeadDim>, TL::kDbiasSmem);
  if (err != cudaSuccess) return err;
  tf32x3_dbias_kernel<kHeadDim><<<grid, kThreads, TL::kDbiasSmem, st>>>(
      fq, fk, fv, fdo, fpad, rebased, static_cast<const float*>(delta),
      static_cast<float*>(chunks > 1 ? part : dbias), batch, items, heads, seq, dim, scale, s, gd);
  if ((err = cudaGetLastError()) != cudaSuccess || chunks == 1) return err;
  const long long n = (long long)heads * seq * seq;
  sum_chunks_kernel<<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), n, chunks);
  return cudaGetLastError();
}

}  // namespace

// The fp32 forward, gated (K1, K2: bias not null) or bias-free (K4, K5):
// out = softmax(q·kᵀ·scale (+ gate ⊙ bias) + pad) · v. fp32 q, k, v and out
// with a head width head_dim that is a multiple of 8 from 8 to this build's
// width, every row 16-byte aligned (strides multiples of 8 elements, bases
// 16-byte aligned); bias fp32 [H, T, T] and gate fp32 [B, H, T] (may be null:
// a gate of 1); pad one byte a key, nonzero = padded (may be null). lse, when
// not null, receives the row log-sum-exp of the logits (float32, contiguous
// [B, H, T]) for the backward above. strides: 20 element strides, q, k, v
// and out (batch, head, token), pad (batch, token), then bias (head, query,
// key) and gate (batch, head, token). Returns a cudaError_t; 0 means the
// kernel was launched. A call the build does not take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int avex_tf32x3_attention_forward(const void* q, const void* k, const void* v, const void* bias,
                                             const void* gate, const void* pad, void* out, void* lse, int batch,
                                             int heads, int seq, int head_dim, float scale, const long long* strides,
                                             void* stream) {
  if (seq <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || head_dim < 8 ||
      head_dim > kHeadDim || head_dim % 8 || (gate != nullptr && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  FwdStrides s;
  memcpy(&s, strides, sizeof(FwdStrides));
  Gated gd;
  gd.bias = static_cast<const float*>(bias);
  gd.gate = static_cast<const float*>(gate);
  memcpy(gd.bs, strides + 14, 3 * sizeof(long long));
  memcpy(gd.gs, strides + 17, 3 * sizeof(long long));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias == nullptr)
    return (int)launch_forward<false>(q, k, v, pad, out, lse, batch, heads, seq, head_dim, scale, s, Gated(), st);
  return (int)launch_forward<true>(q, k, v, pad, out, lse, batch, heads, seq, head_dim, scale, s, gd, st);
}

// The fp32 backward from the forward's residuals, bias-free (K6, bias null)
// or gated (K3): fp32 q, k, v, out (the forward's output) and dout, with a
// head width head_dim that is a multiple of 8 from 8 to this build's width,
// every row 16-byte aligned (strides multiples of 8 elements, bases 16-byte
// aligned); lse the forward's row log-sum-exp (float32, contiguous
// [B, H, T]); bias, gate (may be null) and pad (one byte a key, nonzero =
// padded; may be null) as the forward's. Writes fp32 dq, dk and dv, and
// into delta (float32 scratch, contiguous [2, B, H, T]) each row's
// Δ' = Σ P·dP / Σ P and its LSE rebased by log2 Σ P, in log2 units (see
// the dQ kernel); the gated backward also writes dbias (float32 [H, T, T],
// contiguous) and, with a gate, dgate (float32 [B, H, T], contiguous). It
// sums dbias over chunks of items_per_chunk batch items in parallel, then
// the chunks in order, through dbias_part (float32 scratch
// [ceil(B / items_per_chunk), H, T, T]; may be null when that is one
// chunk). strides: 32 element strides, q, k, v, out, dout, dq, dk and dv
// (batch, head, token), pad (batch, token), then bias (head, query, key) and
// gate (batch, head, token). Returns a cudaError_t; 0 means every kernel
// was launched. A call the build does not take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int avex_tf32x3_attention_backward(const void* q, const void* k, const void* v, const void* out,
                                              const void* dout, const void* bias, const void* gate, const void* pad,
                                              const void* lse, void* dq, void* dk, void* dv, void* delta, void* dbias,
                                              void* dgate, void* dbias_part, int items_per_chunk, int batch,
                                              int heads, int seq, int head_dim, float scale,
                                              const long long* strides, void* stream) {
  if (seq <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || head_dim < 8 ||
      head_dim > kHeadDim || head_dim % 8 || lse == nullptr || out == nullptr ||
      (bias != nullptr && dbias == nullptr) || (gate != nullptr && (bias == nullptr || dgate == nullptr)) ||
      items_per_chunk <= 0 || (items_per_chunk < batch && bias != nullptr && dbias_part == nullptr) ||
      (long long)heads * ((batch + items_per_chunk - 1) / items_per_chunk) > 65535 || (seq + kN - 1) / kN > 65535)
    return (int)cudaErrorInvalidValue;
  BwdStrides s;
  memcpy(&s, strides, sizeof(BwdStrides));
  Gated gd;
  gd.bias = static_cast<const float*>(bias);
  gd.gate = static_cast<const float*>(gate);
  memcpy(gd.bs, strides + 26, 3 * sizeof(long long));
  memcpy(gd.gs, strides + 29, 3 * sizeof(long long));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias == nullptr)
    return (int)launch_backward<false>(q, k, v, out, dout, pad, lse, dq, dk, dv, delta, nullptr, nullptr, nullptr,
                                       batch, batch, heads, seq, head_dim, scale, s, Gated(), st);
  return (int)launch_backward<true>(q, k, v, out, dout, pad, lse, dq, dk, dv, delta, dbias, dgate, dbias_part,
                                    items_per_chunk, batch, heads, seq, head_dim, scale, s, gd, st);
}

// The dbias kernel's shape, for the wrapper's plan of batch chunks: into
// *blocks the kernel's blocks for one chunk of items (query tiles of kOwn
// rows x key tiles of kN rows x heads) at this seq and heads, and into
// *resident the blocks the current device holds at once (its SMs times the
// blocks an SM that this build's registers and shared memory allow).
// Returns a cudaError_t; 0 means both were written.
extern "C" int avex_tf32x3_dbias_plan(int heads, int seq, int* blocks, int* resident) {
  using TL = Tile<kHeadDim>;
  if (heads <= 0 || seq <= 0 || blocks == nullptr || resident == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(tf32x3_dbias_kernel<kHeadDim>, TL::kDbiasSmem);
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tf32x3_dbias_kernel<kHeadDim>, kThreads,
                                                        TL::kDbiasSmem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  *blocks = ((seq + kOwn - 1) / kOwn) * ((seq + kN - 1) / kN) * heads;
  *resident = (per_sm > 0 ? per_sm : 1) * sms;
  return 0;
}
