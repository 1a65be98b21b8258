// fp32 attention on Hopper's tensor cores (sm_90a) in 3xTF32, forward and
// backward, plain C ABI:
//
//   gated:     out = softmax(q·kᵀ·scale + gate ⊙ bias + pad) · v, and its backward
//   bias-free: out = softmax(q·kᵀ·scale + pad) · v, and its backward
//
// Replaces, for fp32 operands and at every head width D >= 1, six Pallas
// TPU kernels of the JAX package:
//   - _attention_kernel            avex_tpu/ops/pallas_attention.py:126  (K1; launched at :272)
//   - _fused_qkv_gated_kernel      avex_tpu/ops/pallas_attention.py:389  (K2; launched at :745)
//   - _plain_attention_kernel      avex_tpu/ops/pallas_attention.py:161  (K4; launched at :261)
//   - _fused_qkv_kernel            avex_tpu/ops/pallas_attention.py:344  (K5; launched at :511)
//   - _fused_qkv_gated_bwd_kernel  avex_tpu/ops/pallas_attention.py:765  (K3; launched at :902)
//   - _fused_qkv_bwd_kernel        avex_tpu/ops/pallas_attention.py:524  (K6; launched at :631)
// The split (K1, K4) and fused (K2, K5) layouts are only different strides
// to the forward. bf16 is tensor_core_attention.cu's.
//
// The forward, as the JAX kernels compute it in fp32: L = q·kᵀ·scale
// (+ gate ⊙ bias), −inf at a padded key, out = softmax(L)·v (P is already
// v's type), and, when the backward will follow, the row log-sum-exp
// LSE = log Σ_k exp(L) into a float32 [B, H, T]. A row whose keys are all
// padded gives NaN and LSE −inf, as the plain twin's softmax does. Any T:
// ragged last tiles are masked, not padded.
//
// The backward, as the JAX kernels compute it in fp32: with
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
// Head widths. Up to 128 (one column chunk) the forward, dQ and dK/dV
// kernels below take any D on the smallest build that holds it, the
// columns D .. kD-1 zero-filled on load: on 16-byte rows in 16-byte
// cp.async runs, on narrow rows (D or a stride not a multiple of 8, a base
// off 16 bytes; every fp32 element is 4-byte aligned) in 4-byte cp.async
// elements into the same double buffer, stored element by element below D;
// on narrow rows a product over the head width runs ceil(D / 8) k-steps,
// not kD / 8, and the forward's P·V only the column blocks below D. Past
// 128 the width comes in column chunks of a multiple of 8 (the wrapper's
// plan) and the wide kernels (tf32x3_forward_wide_kernel,
// tf32x3_dq_wide_kernel, tf32x3_dkv_wide_kernel, below) sum S (and dP) over
// the chunks once per pair of tiles and keep O, dQ, or dK and dV, for the
// whole width; the dbias kernel sums S and dP over the chunks of each
// batch item. The rebasing (above) lets any of them run from the forward's
// LSE whatever order it summed S in: Δ' and P / Σ P are the backward's own,
// so Σ_k dK stays 0 to rounding.
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
//     and ran slower at two. On narrow rows the same kernel (a template
//     instance of its own, so that the 16-byte rows' code is unchanged)
//     loads 4 bytes at a time and skips the k-steps and P·V column blocks
//     past D; past 128, tf32x3_forward_wide_kernel (below) sums S over
//     the column chunks, each k-step's products apart (its comment).
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

// The columns of a call (the wrapper's plan,
// attention_kernels.width_plan): head width dim in `chunks` column chunks of
// `width` columns (the last holds what is left), each on this build's kD;
// narrow: some row is not 16-byte aligned, and every row moves 4 bytes at a
// time.
struct Cols {
  int dim = 0, width = 0, chunks = 1, narrow = 0;
};

// Columns of chunk c.
__device__ __forceinline__ int chunk_cols(const Cols& cl, int c) { return min(cl.width, cl.dim - c * cl.width); }

// k-steps of 8 columns that a product over `cols` columns (the rest
// zero-filled) needs: at most kD / 8.
template <int kD>
__device__ __forceinline__ int ksteps_of(int cols) {
  return min(kD / 8, (cols + 7) >> 3);
}

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

// One fp32 element; src-size 0 (not valid) writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows r0 .. r0+kRows-1 of a [seq, cols] operand with row stride rs into a
// tile, asynchronously, by kThr threads; rows past seq and the columns cols
// .. kD-1 (in the fused [B, T, 3E] layout the next head's, or the next
// chunk's) are zero-filled, the copy reading nothing. 16-byte runs, or, on
// narrow rows (cols, rs or base not 16-byte multiples), 4-byte elements.
template <int kD, int kRows, int kThr = kThreads>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long rs, int r0, int seq, int cols,
                                          bool narrow) {
  constexpr int kChunks = Tile<kD>::kChunks, kLd = Tile<kD>::kLd;
  if (!narrow) {
    const int dc = cols >> 2;
    for (int c = threadIdx.x; c < kRows * kChunks; c += kThr) {
      const int row = (unsigned)c / kChunks, chunk = (unsigned)c % kChunks;
      const bool ok = r0 + row < seq && chunk < dc;
      const float* src = ok ? base + (long long)(r0 + row) * rs + chunk * 4 : base;
      cp_async16(tile + row * kLd + chunk * 4, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kD; e += kThr) {
      const int row = (unsigned)e / kD, col = (unsigned)e % kD;
      const bool ok = r0 + row < seq && col < cols;
      const float* src = ok ? base + (long long)(r0 + row) * rs + col : base;
      cp_async4(tile + row * kLd + col, src, ok);
    }
  }
}

// A staged tile's rows r0 .. r0+kRows-1 (those below seq; cols columns) to
// a [seq, cols] operand, by kThr threads: in 16-byte runs, or element by
// element on narrow rows.
template <int kD, int kRows, int kThr = kThreads>
__device__ __forceinline__ void store_tile(float* base, long long rs, int r0, int seq, int cols, bool narrow,
                                           const float* tile) {
  constexpr int kChunks = Tile<kD>::kChunks, kLd = Tile<kD>::kLd;
  if (!narrow) {
    const int dc = cols >> 2;
    for (int c = threadIdx.x; c < kRows * kChunks; c += kThr) {
      const int row = (unsigned)c / kChunks, chunk = (unsigned)c % kChunks;
      if (r0 + row < seq && chunk < dc)
        *reinterpret_cast<float4*>(base + (long long)(r0 + row) * rs + chunk * 4) =
            *reinterpret_cast<const float4*>(tile + row * kLd + chunk * 4);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kD; e += kThr) {
      const int row = (unsigned)e / kD, col = (unsigned)e % kD;
      if (r0 + row < seq && col < cols) base[(long long)(r0 + row) * rs + col] = tile[row * kLd + col];
    }
  }
}

// Δ = rowsum(dO ∘ O) over the dim columns of rows q0 .. q0+kRows-1 into
// delta_s, kThr / kRows threads a row (0 past seq): float4 runs, or
// elements on narrow rows.
template <int kRows, int kThr>
__device__ __forceinline__ void row_delta(float* delta_s, const float* ob, long long os, const float* dob,
                                          long long ds, int q0, int seq, int dim, bool narrow) {
  constexpr int kPer = kThr / kRows;
  static_assert(kPer >= 1 && kPer <= 32 && (kPer & (kPer - 1)) == 0, "a power-of-two share of a warp a row");
  const int r = threadIdx.x / kPer, part = threadIdx.x % kPer, qi = q0 + r;
  float acc = 0.f;
  if (qi < seq) {
    const float* orow = ob + (long long)qi * os;
    const float* drow = dob + (long long)qi * ds;
    if (!narrow) {
      for (int c4 = part; c4 < dim >> 2; c4 += kPer) {
        const float4 o4 = *reinterpret_cast<const float4*>(orow + 4 * c4);
        const float4 d4 = *reinterpret_cast<const float4*>(drow + 4 * c4);
        acc = fmaf(o4.x, d4.x, acc);
        acc = fmaf(o4.y, d4.y, acc);
        acc = fmaf(o4.z, d4.z, acc);
        acc = fmaf(o4.w, d4.w, acc);
      }
    } else {
      for (int c = part; c < dim; c += kPer) acc = fmaf(orow[c], drow[c], acc);
    }
  }
#pragma unroll
  for (int m = 1; m < kPer; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (part == 0) delta_s[r] = acc;
}

// The additive key bias of keys k0 .. k0+kRows-1: −inf past seq or where padded.
template <int kThr = kThreads, int kRows = kN>
__device__ __forceinline__ void load_key_bias(float* bias, const uint8_t* pad_b, long long ps, int k0, int seq) {
  for (int i = threadIdx.x; i < kRows; i += kThr) {
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

// acc[16 x 8·kBlocks] += A · Bᵀ: A the warp's 16 rows (from row0) of tile
// a, B the first 8·kBlocks rows of tile b; both kD wide, the contraction,
// of which the first 8·ksteps columns are multiplied (ksteps_of: the rest are
// zero). Unless kFull, only the first `live` blocks of 8 rows of b are.
template <int kD, int kBlocks, bool kFull>
__device__ __forceinline__ void mma_abt(float acc[][4], const float* a, int row0, const float* b, int live,
                                        int ksteps) {
  constexpr int kLd = Tile<kD>::kLd, kU = kUnroll;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* c[kBlocks];
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) c[nb] = acc[nb];
  // k-step kk: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) of its 8
  // columns; b0 (k t, n g), b1 (k t+4, n g) from row 8nb + g of the tile.
  auto step = [&](int kk) {
    const float* ap = a + (row0 + g) * kLd + 8 * kk + t;
    const float* bp = b + g * kLd + 8 * kk + t;
    const float x[4] = {ap[0], ap[8 * kLd], ap[4], ap[8 * kLd + 4]};
    Frag f;
    split4(x, f);
    float bv[kBlocks][2];
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
      bv[nb][0] = bp[nb * 8 * kLd];
      bv[nb][1] = bp[nb * 8 * kLd + 4];
    }
    mma3<kBlocks, kFull>(c, f, bv, live);
  };
#pragma unroll 1
  for (int k0 = 0; k0 + kU <= ksteps; k0 += kU) {
#pragma unroll
    for (int kk = 0; kk < kU; ++kk) step(k0 + kk);
  }
  if (ksteps % kU) step(ksteps - 1);  // an odd count (a narrow or chunked width)
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
__device__ __forceinline__ void mma_abt_live(float acc[][4], const float* a, int row0, const float* b, int live,
                                             int ksteps) {
  if (live == kNB)
    mma_abt<kD, kNB, true>(acc, a, row0, b, live, ksteps);
  else
    mma_abt<kD, kNB, false>(acc, a, row0, b, live, ksteps);
}

// acc1[j] += A1 · B1ᵀ and acc2[j] += A2 · B2ᵀ over one column chunk (S and
// dP, or Sᵀ and dPᵀ) for kBlocks blocks of 8 rows of b1 and b2 (unless
// kFull only the first `live`): A1 and A2 the warp's 16 rows (from row0) of
// a1 and a2, the first ksteps k-steps. The two products' k-steps run
// interleaved, so that 2·kBlocks independent accumulators stand between two
// products that add into one; each accumulator sums lo·hi, hi·lo, hi·hi a
// k-step in order, as mma3 does, so the sums are mma_abt's. Used where the
// warps are few (the general route's kernels): the products wait less.
template <int kD, int kBlocks, bool kFull>
__device__ __forceinline__ void mma_abt_two(float acc1[][4], const float* a1, const float* b1, float acc2[][4],
                                            const float* a2, const float* b2, int row0, int live, int ksteps) {
  constexpr int kLd = Tile<kD>::kLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ap1 = a1 + (row0 + g) * kLd + t;
  const float* ap2 = a2 + (row0 + g) * kLd + t;
  const float* bp1 = b1 + g * kLd + t;
  const float* bp2 = b2 + g * kLd + t;
#pragma unroll 2
  for (int kk = 0; kk < ksteps; ++kk) {
    const int o = 8 * kk;
    const float x1[4] = {ap1[o], ap1[8 * kLd + o], ap1[o + 4], ap1[8 * kLd + o + 4]};
    const float x2[4] = {ap2[o], ap2[8 * kLd + o], ap2[o + 4], ap2[8 * kLd + o + 4]};
    Frag f1, f2;
    split4(x1, f1);
    split4(x2, f2);
    uint32_t h1[kBlocks][2], l1[kBlocks][2], h2[kBlocks][2], l2[kBlocks][2];
#pragma unroll
    for (int j = 0; j < kBlocks; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        split(bp1[j * 8 * kLd + o + 4 * e], h1[j][e], l1[j][e]);
        split(bp2[j * 8 * kLd + o + 4 * e], h2[j][e], l2[j][e]);
      }
#pragma unroll
    for (int j = 0; j < kBlocks; ++j)
      if (kFull || j < live) {
        mma(acc1[j], f1.lo, h1[j][0], h1[j][1]);
        mma(acc2[j], f2.lo, h2[j][0], h2[j][1]);
      }
#pragma unroll
    for (int j = 0; j < kBlocks; ++j)
      if (kFull || j < live) {
        mma(acc1[j], f1.hi, l1[j][0], l1[j][1]);
        mma(acc2[j], f2.hi, l2[j][0], l2[j][1]);
      }
#pragma unroll
    for (int j = 0; j < kBlocks; ++j)
      if (kFull || j < live) {
        mma(acc1[j], f1.hi, h1[j][0], h1[j][1]);
        mma(acc2[j], f2.hi, h2[j][0], h2[j][1]);
      }
  }
}

template <int kD>
__device__ __forceinline__ void mma_ab_live(float acc[][4], const float p[][4], const float* b, int live) {
  if (live == kNB)
    mma_ab<kD, true>(acc, p, b, live);
  else
    mma_ab<kD, false>(acc, p, b, live);
}

// mma_ab on narrow rows: only the first `blocks` blocks of 8 columns of B
// (those below the head width; the rest of acc is never stored), two
// accumulators a step, and only the first `live` blocks of 8 rows of B.
// Each accumulator sums as mma_ab's does.
template <int kD>
__device__ __forceinline__ void mma_ab_cols(float acc[][4], const float p[][4], const float* b, int live,
                                            int blocks) {
  constexpr int kLd = Tile<kD>::kLd, kBlocks = kD / 8;
  static_assert(kBlocks % 2 == 0, "column blocks in pairs");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* bp = b + 2 * t * kLd + g;
#pragma unroll
  for (int kk = 0; kk < kNB; ++kk) {
    if (kk < live) {
      const float x[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      Frag f;
      split4(x, f);
#pragma unroll
      for (int nb = 0; nb < kBlocks; nb += 2) {
        if (nb < blocks) {
          float* c[2] = {acc[nb], acc[nb + 1]};
          float bv[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            bv[j][0] = bp[8 * kk * kLd + 8 * (nb + j)];
            bv[j][1] = bp[(8 * kk + 1) * kLd + 8 * (nb + j)];
          }
          mma3<2, false>(c, f, bv, blocks - nb);
        }
      }
    }
  }
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
// log-sum-exp when lse is not null), at a width of one column chunk, on
// 16-byte rows or (kNarrow) narrow rows. On 16-byte rows it runs kD / 8
// k-steps and every column block of P·V whatever D is (the zero columns add
// 0), code that the narrow rows' instance leaves unchanged; narrow rows run
// ceil(D / 8) k-steps and P·V over the column blocks below D alone.
template <int kD, bool kGated, bool kNarrow>
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
  // 16-byte rows: every k-step of the build (columns dim .. kD-1 are zero and add 0)
  const int ks = kNarrow ? ksteps_of<kD>(dim) : kD / 8;
  constexpr bool narrow = kNarrow;
  const float c = scale * kLog2e;

  load_tile<kD, kOwn>(q_s, q + b * s.q[0] + h * s.q[1], s.q[2], q0, seq, dim, narrow);
  load_tile<kD, kN>(k_s, kb, s.k[2], 0, seq, dim, narrow);
  load_tile<kD, kN>(v_s, vb, s.v[2], 0, seq, dim, narrow);
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
      load_tile<kD, kN>(k_s + nxt * TL::kTile, kb, s.k[2], k0n, seq, dim, narrow);
      load_tile<kD, kN>(v_s + nxt * TL::kTile, vb, s.v[2], k0n, seq, dim, narrow);
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
      mma_abt_live<kD>(sc, q_s, row0, k_s + buf * TL::kTile, live, ks);  // S = Q·Kᵀ
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
      if constexpr (kNarrow)
        mma_ab_cols<kD>(acc, sc, v_s + buf * TL::kTile, live, (dim + 7) >> 3);  // O += P·V
      else
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
  store_tile<kD, kOwn>(out + b * s.o[0] + h * s.o[1], s.o[2], q0, seq, dim, narrow, q_s);
}

// The dQ kernel: one block per (query tile of 64, head, item), at a width
// of one column chunk, on 16-byte rows or (kNarrow) narrow rows. On 16-byte
// rows it runs kD / 8 k-steps whatever D is (the zero columns add 0), so
// that the 16-byte rows' code does not change with the narrow rows'; narrow
// rows run ceil(D / 8).
template <int kD, bool kGated, bool kNarrow>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kD>)
tf32x3_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ out, const float* __restrict__ dout, const uint8_t* __restrict__ pad,
                 const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta,
                 float* __restrict__ dgate, int heads, int seq, float scale, BwdStrides s, Gated gd, Cols cl) {
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
  const int dim = cl.dim, ks = kNarrow ? ksteps_of<kD>(dim) : kD / 8;
  constexpr bool narrow = kNarrow;
  const float c = scale * kLog2e;

  load_tile<kD, kOwn>(q_s, qb, s.q[2], q0, seq, dim, narrow);
  load_tile<kD, kOwn>(do_s, dob, s.dout[2], q0, seq, dim, narrow);
  load_tile<kD, kN>(k_s, kb, s.k[2], 0, seq, dim, narrow);
  load_tile<kD, kN>(v_s, vb, s.v[2], 0, seq, dim, narrow);
  load_key_bias(kbias_s, pad_b, s.pad[1], 0, seq);
  cp_async_commit();

  // Δ = rowsum(dO ∘ O) for the block's rows, two threads a row, while the
  // first tiles arrive.
  row_delta<kOwn, kThreads>(delta_s, out + b * s.o[0] + h * s.o[1], s.o[2], dob, s.dout[2], q0, seq, dim, narrow);
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
      load_tile<kD, kN>(k_s + nxt * TL::kTile, kb, s.k[2], k0n, seq, dim, narrow);
      load_tile<kD, kN>(v_s + nxt * TL::kTile, vb, s.v[2], k0n, seq, dim, narrow);
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
      mma_abt_live<kD>(sc, q_s, row0, kt, live, ks);                    // S = Q·Kᵀ
      mma_abt_live<kD>(dp, do_s, row0, v_s + buf * TL::kTile, live, ks);  // dP = dO·Vᵀ
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
  store_tile<kD, kOwn>(dq + b * s.dq[0] + h * s.dq[1], s.dq[2], q0, seq, dim, narrow, q_s);
}

// The dK/dV kernel: one block per (key tile of 64, head, item), at a width
// of one column chunk, on 16-byte rows or (kNarrow) narrow rows, k-steps as
// the dQ kernel's.
template <int kD, bool kGated, bool kNarrow>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kD>)
tf32x3_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ dout, const uint8_t* __restrict__ pad, const float* __restrict__ lse2,
                  const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int heads,
                  int seq, float scale, BwdStrides s, Gated gd, Cols cl) {
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
  const int dim = cl.dim, ks = kNarrow ? ksteps_of<kD>(dim) : kD / 8;
  constexpr bool narrow = kNarrow;
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

  load_tile<kD, kOwn>(k_s, k + b * s.k[0] + h * s.k[1], s.k[2], k0, seq, dim, narrow);
  load_tile<kD, kOwn>(v_s, v + b * s.v[0] + h * s.v[1], s.v[2], k0, seq, dim, narrow);
  load_tile<kD, kN>(q_s, qb, s.q[2], 0, seq, dim, narrow);
  load_tile<kD, kN>(do_s, dob, s.dout[2], 0, seq, dim, narrow);
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
      load_tile<kD, kN>(q_s + nxt * TL::kTile, qb, s.q[2], q0n, seq, dim, narrow);
      load_tile<kD, kN>(do_s + nxt * TL::kTile, dob, s.dout[2], q0n, seq, dim, narrow);
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
      mma_abt_live<kD>(st, k_s, row0, qt, live, ks);  // Sᵀ = K·Qᵀ
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
      mma_abt_live<kD>(dpt, v_s, row0, dot, live, ks);  // dPᵀ = V·dOᵀ
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
  store_tile<kD, kOwn>(dk + b * s.dk[0] + h * s.dk[1], s.dk[2], k0, seq, dim, narrow, k_s);
  store_tile<kD, kOwn>(dv + b * s.dv[0] + h * s.dv[1], s.dv[2], k0, seq, dim, narrow, v_s);
}

// The gated dbias over one chunk of `items` batch items: one block per
// (query tile of 64, key tile of kN, head, chunk), blockIdx.z = chunk ·
// heads + h. It walks its items in order, and each item's column chunks
// (one at a width up to 128), with the next step's tiles in flight; it
// sums S and dP over the column chunks, rebuilds P from the LSE and dL with
// the Δ' the dQ kernel wrote, keeps Σ gate ⊙ dL in registers and writes it
// to out[chunk]. kMode: 0, 16-byte rows of one chunk (kD / 8 k-steps, code
// that the other modes leave unchanged); 1, narrow rows of one chunk; 2, column chunks
// (S and dP interleaved: at one block of 4 warps an SM they wait less; on
// the narrow rows' small builds their registers would cost a block an SM).
template <int kD, int kMode>
__global__ void __launch_bounds__(kThreads, kDbiasMinBlocks<kD>)
tf32x3_dbias_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const uint8_t* __restrict__ pad, const float* __restrict__ lse2,
                    const float* __restrict__ delta, float* __restrict__ out, int batch, int items, int heads,
                    int seq, float scale, BwdStrides s, Gated gd, Cols cl) {
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
  constexpr bool kGeneral = kMode != 0;
  const int b0 = chunk * items, b_end = min(batch, b0 + items), n = kMode == 2 ? cl.chunks : 1;
  const int n_steps = (b_end - b0) * n;  // (item, column chunk) in order
  const bool narrow = kGeneral && cl.narrow;
  const float c = scale * kLog2e;

  // Step st's tiles (item b0 + st / n, column chunk st % n) and the item's
  // row statistics into slot `slot`; rows past seq get an LSE of +inf
  // (P = 0) and a Δ of 0.
  auto prefetch = [&](int slot, int st) {
    const int b = b0 + st / n, cc = st % n, col = cc * cl.width, cols = chunk_cols(cl, cc);
    load_tile<kD, kOwn>(q_s + slot * TL::kOwnTile, q + b * s.q[0] + h * s.q[1] + col, s.q[2], q0, seq, cols, narrow);
    load_tile<kD, kOwn>(do_s + slot * TL::kOwnTile, dout + b * s.dout[0] + h * s.dout[1] + col, s.dout[2], q0, seq,
                        cols, narrow);
    load_tile<kD, kN>(k_s + slot * TL::kTile, k + b * s.k[0] + h * s.k[1] + col, s.k[2], k0, seq, cols, narrow);
    load_tile<kD, kN>(v_s + slot * TL::kTile, v + b * s.v[0] + h * s.v[1] + col, s.v[2], k0, seq, cols, narrow);
    load_key_bias(kbias_s + slot * kN, pad ? pad + b * s.pad[0] : nullptr, s.pad[1], k0, seq);
    const long long stat0 = ((long long)b * heads + h) * seq;
    for (int i = threadIdx.x; i < kOwn; i += kThreads) {
      const int qi = q0 + i;
      lse_s[slot * kOwn + i] = qi < seq ? lse2[stat0 + qi] : INFINITY;
      dl_s[slot * kOwn + i] = qi < seq ? delta[stat0 + qi] : 0.f;
      g_s[slot * kOwn + i] = gate_at(gd, b, h, min(qi, seq - 1));
    }
  };

  prefetch(0, 0);
  cp_async_commit();
  float bf[kNB][4];  // the tile's bias, the same for every item
  fetch_bias(bf, gd, h, q0 + row0, k0, seq);

  float acc[kNB][4], sc[kNB][4], dp[kNB][4];
  zero<kN>(acc);
  for (int st = 0; st < n_steps; ++st) {
    const int buf = st & 1, cc = st % n;
    if (st + 1 < n_steps) {
      prefetch(buf ^ 1, st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (cc == 0) {
        zero<kN>(sc);
        zero<kN>(dp);
      }
      const float *qt = q_s + buf * TL::kOwnTile, *kt = k_s + buf * TL::kTile;
      const float *dot = do_s + buf * TL::kOwnTile, *vt = v_s + buf * TL::kTile;
      const int ks = kGeneral ? ksteps_of<kD>(chunk_cols(cl, cc)) : kD / 8;
      if constexpr (kMode == 2) {  // S += Q_c·K_cᵀ and dP += dO_c·V_cᵀ, interleaved
        if (live == kNB)
          mma_abt_two<kD, kNB, true>(sc, qt, kt, dp, dot, vt, row0, live, ks);
        else
          mma_abt_two<kD, kNB, false>(sc, qt, kt, dp, dot, vt, row0, live, ks);
      } else {
        mma_abt_live<kD>(sc, qt, row0, kt, live, ks);   // S = Q·Kᵀ
        mma_abt_live<kD>(dp, dot, row0, vt, live, ks);  // dP = dO·Vᵀ
      }
      if (cc == n - 1) {
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
    }
    __syncthreads();  // every warp is done with this step's buffers
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

// ---------------------------------------------------------------------------
// Column chunks past 128 (the kD >= 80 builds): the dQ and dK/dV kernels of
// a width cut into chunks. A block of eight warps owns 32 rows in two
// groups of 16; four warps share a group. Per streamed tile of kWN = 64
// rows, phase 1 walks the column chunks (each step brings the chunk of the
// own rows and of the tile) and sums S and dP over them, each warp its
// 16 x 16 slice (keys or queries 16cw .. 16cw + 15 of the tile); the
// slices of dS (and Pᵀ) meet in shared memory; phase 2 walks the block's
// own column chunks again (each step brings the tile's chunk) and adds
// dS·K (or Pᵀ·dO and dSᵀ·Q) into accumulators that cover the whole width,
// each warp blocks cw, cw + 4, ... of 8 columns of every chunk. So S and dP
// are formed once per (row tile, streamed tile), and a thread's
// accumulators come to 4·kPer floats a chunk (16 at kD = 128, 12 at 80 and
// 96). A block accumulates at most kMaxChunks chunks (a width up to 512); a
// wider head runs in groups of them, each group forming S and dP again.
// At one block of eight warps an SM (their registers and shared memory) the
// kernels wait on their own products more than on memory, so the design
// buys independent work: the streamed tile is 64 rows, not the one-chunk
// kernels' 32 (a 16 x 8 slice a warp was too little between two barriers:
// K6 at dh 320 11.96 against 8.82 ms), S and dP run interleaved, as do
// dV and dK, and the dQ kernel's phase 2 takes two chunks a step (PERF.md;
// a third cp.async stage did not help).
// ---------------------------------------------------------------------------
constexpr int kWWarps = 8;
constexpr int kWThreads = 32 * kWWarps;
constexpr int kWOwn = 32;       // rows a block owns
constexpr int kWN = 64;         // rows of a streamed tile
constexpr int kWNB = kWN / 8;   // its blocks of 8 rows
constexpr int kMaxChunks = 4;  // even: the dQ kernel's phase 2 takes its chunks in pairs
constexpr int kXLd = kWN + 8;  // row stride of an exchanged [32 x kWN] tile: float2 moves free of bank conflicts

template <int kD>
struct Wide {
  static constexpr int kLd = Tile<kD>::kLd;
  static constexpr int kBlocks = kD / 8;          // blocks of 8 columns of a chunk
  static constexpr int kPer = (kBlocks + 3) / 4;  // a warp's: cw, cw + 4, ...
  static constexpr int kOwnTile = kWOwn * kLd;
  static constexpr int kTile = kWN * kLd;
  static constexpr int kSlot = 2 * kOwnTile + 2 * kTile;  // a step's four tiles: two own, two streamed
  static constexpr size_t kDqSmem =
      sizeof(float) * (2 * kSlot + kWOwn * kXLd + 2 * kWN + kWOwn + 16 * kWOwn + kMaxChunks * kD);
  static constexpr size_t kDkvSmem = sizeof(float) * (2 * kSlot + 2 * kWOwn * kXLd + 6 * kWN);
  // The forward's step: K_c and, unless Q is resident, Q_c (phase 1), or V
  // of two chunks (phase 2); and the resident Q of up to kMaxChunks chunks.
  static constexpr int kFwdSlot = 2 * kTile;
  static constexpr size_t kFwdSmem =
      sizeof(float) * (2 * kFwdSlot + kMaxChunks * kOwnTile + kWOwn * kXLd + 2 * kWN + 4 * kWOwn);
};

// Blocks of 8 rows of the streamed tile at r0 that hold a row below seq.
__device__ __forceinline__ int live_blocks_w(int r0, int seq) { return min(kWNB, (seq - r0 + 7) >> 3); }

// This warp's 16 x 16 slice (rows from row0, columns 16cw ..) of an
// exchanged tile, from its accumulators a[j] (block 2cw + j: rows g and
// g + 8, columns 2t and 2t + 1).
__device__ __forceinline__ void write_slice(float* x, int row0, int cw, const float a[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = 16 * cw + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(x + (row0 + g) * kXLd + col) = make_float2(a[j][0], a[j][1]);
    *reinterpret_cast<float2*>(x + (row0 + g + 8) * kXLd + col) = make_float2(a[j][2], a[j][3]);
  }
}

// mma_abt_two on the warp's blocks below seq of the streamed tiles at r0.
template <int kD>
__device__ __forceinline__ void mma_abt_pair(float acc1[2][4], const float* a1, const float* b1, float acc2[2][4],
                                             const float* a2, const float* b2, int row0, int cw, int r0, int seq,
                                             int ksteps) {
  const int live = min(2, max(0, (seq - r0 - 16 * cw + 7) >> 3));
  const int off = 16 * cw * Tile<kD>::kLd;
  if (live == 2)
    mma_abt_two<kD, 2, true>(acc1, a1, b1 + off, acc2, a2, b2 + off, row0, live, ksteps);
  else if (live == 1)
    mma_abt_two<kD, 2, false>(acc1, a1, b1 + off, acc2, a2, b2 + off, row0, live, ksteps);
}

// acc[16 x 16] += A · Bᵀ as mma_abt<kD, 2> takes it (A the warp's 16 rows
// from row0 of a, B the first 16 rows of b, unless kFull only the first
// `live` blocks of 8; ksteps k-steps), except that each k-step's three
// products go into an accumulator of their own, from 0, which is then added
// into acc. The tensor cores' fp32 accumulation rounds toward zero, so one
// accumulator carried over every k-step of a wide head (16 a chunk of 128)
// shrinks S by a bias that grows with the width: from dh 320 the row
// log-sum-exp moved more than 1e-5 from the plain twin's. A k-step's sum
// stays small and the adds round to nearest; the k-steps' products no
// longer wait on each other.
template <int kD, bool kFull>
__device__ __forceinline__ void mma_abt_fresh(float acc[2][4], const float* a, int row0, const float* b, int live,
                                              int ksteps) {
  constexpr int kLd = Tile<kD>::kLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ap = a + (row0 + g) * kLd + t;
  const float* bp = b + g * kLd + t;
#pragma unroll 2
  for (int kk = 0; kk < ksteps; ++kk) {
    const int o = 8 * kk;
    const float x[4] = {ap[o], ap[8 * kLd + o], ap[o + 4], ap[8 * kLd + o + 4]};
    Frag f;
    split4(x, f);
    float bv[2][2], part[2][4] = {};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bv[j][0] = bp[j * 8 * kLd + o];
      bv[j][1] = bp[j * 8 * kLd + o + 4];
    }
    float* c[2] = {part[0], part[1]};
    mma3<2, kFull>(c, f, bv, live);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// mma_abt_fresh of the warp's 16 x 16 slice (rows from row0 of a; rows
// 16cw .. 16cw + 15 of the streamed tile b, those below seq) over ksteps
// k-steps.
template <int kD>
__device__ __forceinline__ void mma_abt_slice(float acc[2][4], const float* a, const float* b, int row0, int cw,
                                              int r0, int seq, int ksteps) {
  const int live = min(2, max(0, (seq - r0 - 16 * cw + 7) >> 3));
  const float* bw = b + 16 * cw * Tile<kD>::kLd;
  if (live == 2)
    mma_abt_fresh<kD, true>(acc, a, row0, bw, live, ksteps);
  else if (live == 1)
    mma_abt_fresh<kD, false>(acc, a, row0, bw, live, ksteps);
}

// acc1[j] += P1 · B1 and acc2[j] += P2 · B2 over the columns of blocks cw + 4j
// of B1 and B2 (dV += Pᵀ·dO and dK += dSᵀ·Q, or dS·K for two column
// chunks), interleaved: 2·kPer independent accumulators, each summing lo·hi,
// hi·lo, hi·hi a k-step in order. P1 and P2: the warp's 16 rows (from row0)
// of exchanged [32 x kWN] tiles, read a block of 8 at a time in the
// accumulator layout (columns 2t, 2t + 1 of rows g, g + 8); B1 and B2 the
// tiles' kWN rows (the contraction, permuted inside each block of 8 as
// mma_ab permutes it) by kD columns. Only the blocks of columns below
// blocks1 / blocks2 (the chunks'; 0: none) and of rows below `live`.
// kOneP: x2 is x1 (P·V for two column chunks), read and split once.
template <int kD, bool kOneP = false>
__device__ __forceinline__ void mma_ab_part2(float acc1[][4], const float* x1, const float* b1, float acc2[][4],
                                             const float* x2, const float* b2, int row0, int live, int cw,
                                             int blocks1, int blocks2) {
  using W = Wide<kD>;
  constexpr int kLd = W::kLd, kPer = W::kPer;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mine1 = min(kPer, (blocks1 - cw + 3) >> 2), mine2 = min(kPer, (blocks2 - cw + 3) >> 2);
  if (mine1 <= 0 && mine2 <= 0) return;
  const float* bp1 = b1 + 2 * t * kLd + g;
  const float* bp2 = b2 + 2 * t * kLd + g;
  const float* xp1 = x1 + (row0 + g) * kXLd + 2 * t;
  const float* xp2 = x2 + (row0 + g) * kXLd + 2 * t;
#pragma unroll 2
  for (int kk = 0; kk < live; ++kk) {
    const float2 lo1 = *reinterpret_cast<const float2*>(xp1 + 8 * kk);
    const float2 hi1 = *reinterpret_cast<const float2*>(xp1 + 8 * kXLd + 8 * kk);
    const float x4a[4] = {lo1.x, hi1.x, lo1.y, hi1.y};
    Frag f1, f2;
    split4(x4a, f1);
    if constexpr (kOneP) {
      f2 = f1;
    } else {
      const float2 lo2 = *reinterpret_cast<const float2*>(xp2 + 8 * kk);
      const float2 hi2 = *reinterpret_cast<const float2*>(xp2 + 8 * kXLd + 8 * kk);
      const float x4b[4] = {lo2.x, hi2.x, lo2.y, hi2.y};
      split4(x4b, f2);
    }
    uint32_t h1[kPer][2], l1[kPer][2], h2[kPer][2], l2[kPer][2];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int nb = min(cw + 4 * j, W::kBlocks - 1);  // a block past the chunk is read, not used
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        split(bp1[(8 * kk + e) * kLd + 8 * nb], h1[j][e], l1[j][e]);
        split(bp2[(8 * kk + e) * kLd + 8 * nb], h2[j][e], l2[j][e]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < mine1) mma(acc1[j], f1.lo, h1[j][0], h1[j][1]);
      if (j < mine2) mma(acc2[j], f2.lo, h2[j][0], h2[j][1]);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < mine1) mma(acc1[j], f1.hi, l1[j][0], l1[j][1]);
      if (j < mine2) mma(acc2[j], f2.hi, l2[j][0], l2[j][1]);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < mine1) mma(acc1[j], f1.hi, h1[j][0], h1[j][1]);
      if (j < mine2) mma(acc2[j], f2.hi, h2[j][0], h2[j][1]);
    }
  }
}

// The dQ kernel of a chunked width: one block per (query tile of 32, head
// and group of column chunks, item).
template <int kD, bool kGated>
__global__ void __launch_bounds__(kWThreads, 1)
tf32x3_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ out, const float* __restrict__ dout, const uint8_t* __restrict__ pad,
                      const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta,
                      float* __restrict__ dgate, int heads, int seq, float scale, BwdStrides s, Gated gd, Cols cl) {
  using W = Wide<kD>;
  constexpr int kLd = W::kLd, kPer = W::kPer;
  extern __shared__ __align__(128) unsigned char smem[];
  float* slots = reinterpret_cast<float*>(smem);  // [2]: Q_c, dO_c [32][kLd]; K_c, V_c [64][kLd] (phase 2: K_j)
  float* ds_s = slots + 2 * W::kSlot;             // [32][kXLd]: dS of the key tile
  float* kbias_s = ds_s + kWOwn * kXLd;           // [2][kWN]
  float* delta_s = kbias_s + 2 * kWN;             // [32]
  float* red_s = delta_s + kWOwn;                 // [4 sums][4 warps][32 rows]
  float* kbar_s = red_s + 16 * kWOwn;             // [kMaxChunks][kD], the keys' mean

  const int groups = (cl.chunks + kMaxChunks - 1) / kMaxChunks;
  const int q0 = blockIdx.x * kWOwn, h = blockIdx.y / groups, grp = blockIdx.y % groups, b = blockIdx.z;
  const int n = cl.chunks, c_lo = grp * kMaxChunks, owned = min(kMaxChunks, n - c_lo);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int cw = warp & 3, row0 = 16 * (warp >> 2);
  const bool active = q0 + row0 < seq;  // warp-uniform: the row group has a query below seq
  const float* qb = q + b * s.q[0] + h * s.q[1];
  const float* kb = k + b * s.k[0] + h * s.k[1];
  const float* vb = v + b * s.v[0] + h * s.v[1];
  const float* dob = dout + b * s.dout[0] + h * s.dout[1];
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
  const long long stat0 = ((long long)b * heads + h) * seq;
  const int per_tile = n + (owned + 1) / 2, n_steps = (seq + kWN - 1) / kWN * per_tile;
  const bool narrow = cl.narrow;
  const float c = scale * kLog2e;

  // Step st: key tile st / per_tile; phase 1 (chunk r < n) brings Q_r, dO_r,
  // K_r and V_r (and with the first, the keys' padding), phase 2 the tile's
  // K_j for two of the block's chunks at a time (j = 2(r - n) and the next,
  // into the K and V tiles' places).
  auto prefetch = [&](int st, int slot) {
    const int it = st / per_tile, r = st % per_tile, k0 = it * kWN;
    float* sl = slots + slot * W::kSlot;
    float* kt = sl + 2 * W::kOwnTile;
    if (r < n) {
      const int col = r * cl.width, cols = chunk_cols(cl, r);
      load_tile<kD, kWOwn, kWThreads>(sl, qb + col, s.q[2], q0, seq, cols, narrow);
      load_tile<kD, kWOwn, kWThreads>(sl + W::kOwnTile, dob + col, s.dout[2], q0, seq, cols, narrow);
      load_tile<kD, kWN, kWThreads>(kt, kb + col, s.k[2], k0, seq, cols, narrow);
      load_tile<kD, kWN, kWThreads>(kt + W::kTile, vb + col, s.v[2], k0, seq, cols, narrow);
      if (r == 0) load_key_bias<kWThreads, kWN>(kbias_s + (it & 1) * kWN, pad_b, s.pad[1], k0, seq);
    } else {
      for (int x = 2 * (r - n); x < min(owned, 2 * (r - n) + 2); ++x) {
        const int j = c_lo + x;
        load_tile<kD, kWN, kWThreads>(kt + (x & 1) * W::kTile, kb + j * cl.width, s.k[2], k0, seq, chunk_cols(cl, j),
                                      narrow);
      }
    }
  };

  prefetch(0, 0);
  cp_async_commit();
  row_delta<kWOwn, kWThreads>(delta_s, out + b * s.o[0] + h * s.o[1], s.o[2], dob, s.dout[2], q0, seq, cl.dim,
                              narrow);
  // This lane's rows g and g+8, as the one-chunk kernel keeps them; the row
  // sums are this warp's part (its keys of each tile).
  float lse2[2], dl[2] = {0.f, 0.f}, gl[2] = {0.f, 0.f};
  float psum[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f}, bsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + g + 8 * i;
    lse2[i] = qi < seq ? lse[stat0 + qi] * kLog2e : INFINITY;
    if (kGated) gl[i] = gate_at(gd, b, h, min(qi, seq - 1)) * kLog2e;
  }

  float sc[2][4], dp[2][4];
  float acc[kMaxChunks][kPer][4];
#pragma unroll
  for (int x = 0; x < kMaxChunks; ++x)
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][j][e] = 0.f;
  float kcol[kMaxChunks] = {};  // threads below kD: column threadIdx.x of Σ_k K_j
  for (int st = 0; st < n_steps; ++st) {
    const int slot = st & 1;
    if (st + 1 < n_steps) {
      prefetch(st + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int it = st / per_tile, r = st % per_tile, k0 = it * kWN;
    const float* sl = slots + slot * W::kSlot;
    const float* kt = sl + 2 * W::kOwnTile;
    if (st == 0) dl[0] = delta_s[row0 + g], dl[1] = delta_s[row0 + g + 8];
    if (r < n) {
      if (r == 0) {
        zero<16>(sc);
        zero<16>(dp);
      }
      if (active) {
        const int ks = ksteps_of<kD>(chunk_cols(cl, r));
        // S += Q_c·K_cᵀ, dP += dO_c·V_cᵀ
        mma_abt_pair<kD>(sc, sl, kt, dp, sl + W::kOwnTile, kt + W::kTile, row0, cw, k0, seq, ks);
      }
      if (r == n - 1 && active) {
        const float* kbias = kbias_s + (it & 1) * kWN;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, key = 16 * cw + 8 * j + 2 * t + (e & 1);
            const float kbv = kbias[key];
            float x = fmaf(sc[j][e], c, kbv), bias = 0.f;
            if (kGated) {
              bias = __ldg(gd.bias + h * gd.bs[0] + min(q0 + row0 + g + 8 * i, seq - 1) * gd.bs[1] +
                           min(k0 + key, seq - 1) * gd.bs[2]);
              x = fmaf(sc[j][e], c, bias * gl[i] + kbv);
            }
            const float pv = exp2_approx(x - lse2[i]);
            const float dlv = pv * (dp[j][e] - dl[i]);  // dL = P∘(dP − Δ)
            psum[i] += pv;
            pdp[i] = fmaf(pv, dp[j][e], pdp[i]);
            if (kGated) {
              dg[i] = fmaf(bias, dlv, dg[i]);
              bsum[i] = fmaf(bias, pv, bsum[i]);
            }
            sc[j][e] = dlv * scale;  // dS
          }
        write_slice(ds_s, row0, cw, sc);
      }
    } else {
      const int pr = r - n, x0 = 2 * pr;  // the block's chunks x0 and x0 + 1 (if it has one)
      const bool two = x0 + 1 < owned;
      if (threadIdx.x < kD) {
        const float* col = kt + threadIdx.x;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll 8
        for (int row = 0; row < kWN; ++row) {
          sum0 += col[row * kLd];
          if (two) sum1 += col[W::kTile + row * kLd];
        }
#pragma unroll
        for (int x = 0; x < kMaxChunks; x += 2)
          if (x == x0) kcol[x] += sum0, kcol[x + 1] += sum1;
      }
      if (active) {
        const int live = live_blocks_w(k0, seq);
        const int blocks0 = (chunk_cols(cl, c_lo + x0) + 7) >> 3;
        const int blocks1 = two ? (chunk_cols(cl, c_lo + x0 + 1) + 7) >> 3 : 0;
#pragma unroll
        for (int x = 0; x < kMaxChunks; x += 2)
          if (x == x0)  // dQ_j += dS·K_j for both chunks, interleaved
            mma_ab_part2<kD>(acc[x], ds_s, kt, acc[x + 1], ds_s, kt + W::kTile, row0, live, cw, blocks0, blocks1);
      }
    }
    __syncthreads();
  }

  // The row sums over the row group's four warps (in warp order), and the
  // keys' mean; then the one-chunk kernel's correction (see there).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float sums[4] = {quad_sum(psum[i]), quad_sum(pdp[i]), quad_sum(dg[i]), quad_sum(bsum[i])};
    if (t == 0)
#pragma unroll
      for (int m = 0; m < 4; ++m) red_s[(m * 4 + cw) * kWOwn + row0 + g + 8 * i] = sums[m];
  }
  if (threadIdx.x < kD)
#pragma unroll
    for (int x = 0; x < kMaxChunks; ++x)
      if (x < owned) kbar_s[x * kD + threadIdx.x] = kcol[x] / seq;
  __syncthreads();
  if (active) {
    const long long rebased = (long long)gridDim.z * heads * seq;
    float inv[2], sds[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i, qi = q0 + r;
      float sums[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        sums[m] = ((red_s[(m * 4) * kWOwn + r] + red_s[(m * 4 + 1) * kWOwn + r]) + red_s[(m * 4 + 2) * kWOwn + r]) +
                  red_s[(m * 4 + 3) * kWOwn + r];
      const float sum = sums[0], pdps = sums[1], dnew = pdps / sum;
      inv[i] = 1.f / sum;
      sds[i] = scale * (pdps - dl[i] * sum);
      if (grp == 0 && cw == 0 && t == 0 && qi < seq) {
        delta[stat0 + qi] = dnew;
        delta[rebased + stat0 + qi] = lse2[i] + log2f(sum);
        if (kGated && dgate) dgate[stat0 + qi] = (sums[2] + (dl[i] - dnew) * sums[3]) * inv[i];
      }
    }
#pragma unroll
    for (int x = 0; x < kMaxChunks; ++x) {
      if (x >= owned) continue;
      float* tile = slots + x * W::kOwnTile;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = 8 * (cw + 4 * j) + 2 * t;
        if (col >= kD) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(tile + (row0 + g + 8 * i) * kLd + col) =
              make_float2((acc[x][j][2 * i] - sds[i] * kbar_s[x * kD + col]) * inv[i],
                          (acc[x][j][2 * i + 1] - sds[i] * kbar_s[x * kD + col + 1]) * inv[i]);
      }
    }
  }
  __syncthreads();
  for (int x = 0; x < owned; ++x)
    store_tile<kD, kWOwn, kWThreads>(dq + b * s.dq[0] + h * s.dq[1] + (c_lo + x) * cl.width, s.dq[2], q0, seq,
                                     chunk_cols(cl, c_lo + x), narrow, slots + x * W::kOwnTile);
}

// The dK/dV kernel of a chunked width: one block per (key tile of 32, head
// and group of column chunks, item).
template <int kD, bool kGated>
__global__ void __launch_bounds__(kWThreads, 1)
tf32x3_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       const float* __restrict__ dout, const uint8_t* __restrict__ pad, const float* __restrict__ lse2,
                       const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int heads,
                       int seq, float scale, BwdStrides s, Gated gd, Cols cl) {
  using W = Wide<kD>;
  constexpr int kLd = W::kLd, kPer = W::kPer;
  extern __shared__ __align__(128) unsigned char smem[];
  float* slots = reinterpret_cast<float*>(smem);  // [2]: K_c, V_c [32][kLd]; Q_c, dO_c [64][kLd] (phase 2: Q_j, dO_j)
  float* pt_s = slots + 2 * W::kSlot;             // [32][kXLd]: Pᵀ of the query tile
  float* dst_s = pt_s + kWOwn * kXLd;             // [32][kXLd]: dSᵀ
  float* lse_s = dst_s + kWOwn * kXLd;            // [2][kWN], log2 units
  float* dl_s = lse_s + 2 * kWN;                  // [2][kWN]
  float* gl_s = dl_s + 2 * kWN;                   // [2][kWN], the gated variant's gate

  const int groups = (cl.chunks + kMaxChunks - 1) / kMaxChunks;
  const int k0 = blockIdx.x * kWOwn, h = blockIdx.y / groups, grp = blockIdx.y % groups, b = blockIdx.z;
  const int n = cl.chunks, c_lo = grp * kMaxChunks, owned = min(kMaxChunks, n - c_lo);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int cw = warp & 3, row0 = 16 * (warp >> 2);
  const bool active = k0 + row0 < seq;  // the row group has a key below seq
  const float* qb = q + b * s.q[0] + h * s.q[1];
  const float* kb = k + b * s.k[0] + h * s.k[1];
  const float* vb = v + b * s.v[0] + h * s.v[1];
  const float* dob = dout + b * s.dout[0] + h * s.dout[1];
  const long long stat0 = ((long long)b * heads + h) * seq;
  const int per_tile = n + owned, n_steps = (seq + kWN - 1) / kWN * per_tile;
  const bool narrow = cl.narrow;
  const float c = scale * kLog2e;

  // Step st: query tile st / per_tile; phase 1 (chunk r < n) brings K_r,
  // V_r, Q_r and dO_r (and with the first, the queries' statistics, as the
  // one-chunk kernel reads them), phase 2 the tile's Q_j and dO_j.
  auto prefetch = [&](int st, int slot) {
    const int it = st / per_tile, r = st % per_tile, q0 = it * kWN;
    float* sl = slots + slot * W::kSlot;
    float* qt = sl + 2 * W::kOwnTile;
    if (r < n) {
      const int col = r * cl.width, cols = chunk_cols(cl, r);
      load_tile<kD, kWOwn, kWThreads>(sl, kb + col, s.k[2], k0, seq, cols, narrow);
      load_tile<kD, kWOwn, kWThreads>(sl + W::kOwnTile, vb + col, s.v[2], k0, seq, cols, narrow);
      load_tile<kD, kWN, kWThreads>(qt, qb + col, s.q[2], q0, seq, cols, narrow);
      load_tile<kD, kWN, kWThreads>(qt + W::kTile, dob + col, s.dout[2], q0, seq, cols, narrow);
      if (r == 0) {  // with the tiles, asynchronously: 0 past seq (the LSE made +inf where it is read)
        const int sl2 = (it & 1) * kWN;
        for (int i = threadIdx.x; i < kWN; i += kWThreads) {
          const int qi = q0 + i;
          const bool ok = qi < seq;
          cp_async4(lse_s + sl2 + i, lse2 + stat0 + (ok ? qi : 0), ok);
          cp_async4(dl_s + sl2 + i, delta + stat0 + (ok ? qi : 0), ok);
          if (kGated) {
            if (gd.gate)
              cp_async4(gl_s + sl2 + i, gd.gate + b * gd.gs[0] + h * gd.gs[1] + min(qi, seq - 1) * gd.gs[2], true);
            else
              gl_s[sl2 + i] = 1.f;
          }
        }
      }
    } else {
      const int col = (c_lo + r - n) * cl.width, cols = chunk_cols(cl, c_lo + r - n);
      load_tile<kD, kWN, kWThreads>(qt, qb + col, s.q[2], q0, seq, cols, narrow);
      load_tile<kD, kWN, kWThreads>(qt + W::kTile, dob + col, s.dout[2], q0, seq, cols, narrow);
    }
  };

  prefetch(0, 0);
  cp_async_commit();
  float kbias[2];            // this lane's keys g and g+8
  const float* bias_col[2];  // the gated variant: their bias columns (keys past seq clamped)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + g + 8 * i;
    kbias[i] = (key >= seq || (pad && pad[b * s.pad[0] + key * s.pad[1]])) ? -INFINITY : 0.f;
    bias_col[i] = kGated ? gd.bias + h * gd.bs[0] + min(key, seq - 1) * gd.bs[2] : nullptr;
  }

  float st1[2][4], dpt[2][4];
  float dk_acc[kMaxChunks][kPer][4], dv_acc[kMaxChunks][kPer][4];
#pragma unroll
  for (int x = 0; x < kMaxChunks; ++x)
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[x][j][e] = dv_acc[x][j][e] = 0.f;
  for (int st = 0; st < n_steps; ++st) {
    const int slot = st & 1;
    if (st + 1 < n_steps) {
      prefetch(st + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int it = st / per_tile, r = st % per_tile, q0 = it * kWN;
    const float* sl = slots + slot * W::kSlot;
    const float* qt = sl + 2 * W::kOwnTile;
    if (r < n) {
      if (r == 0) {
        zero<16>(st1);
        zero<16>(dpt);
      }
      if (active) {
        const int ks = ksteps_of<kD>(chunk_cols(cl, r));
        // Sᵀ += K_c·Q_cᵀ, dPᵀ += V_c·dO_cᵀ
        mma_abt_pair<kD>(st1, sl, qt, dpt, sl + W::kOwnTile, qt + W::kTile, row0, cw, q0, seq, ks);
      }
      if (r == n - 1 && active) {
        const float* lq = lse_s + (it & 1) * kWN;
        const float* dlq = dl_s + (it & 1) * kWN;
        const float* glq = gl_s + (it & 1) * kWN;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, col = 16 * cw + 8 * j + 2 * t + (e & 1);
            float x = fmaf(st1[j][e], c, kbias[i]);
            if (kGated) {
              const float bt = __ldg(bias_col[i] + min(q0 + col, seq - 1) * gd.bs[1]);
              x = fmaf(st1[j][e], c, bt * (glq[col] * kLog2e) + kbias[i]);
            }
            const float lqv = q0 + col < seq ? lq[col] : INFINITY;  // past seq: P = 0
            st1[j][e] = exp2_approx(x - lqv);                            // Pᵀ
            dpt[j][e] = st1[j][e] * (dpt[j][e] - dlq[col]) * scale;      // dSᵀ
          }
        write_slice(pt_s, row0, cw, st1);
        write_slice(dst_s, row0, cw, dpt);
      }
    } else if (active) {
      const int jj = r - n;
      const int live = live_blocks_w(q0, seq), blocks = (chunk_cols(cl, c_lo + jj) + 7) >> 3;
#pragma unroll
      for (int x = 0; x < kMaxChunks; ++x)
        if (x == jj)  // dV_j += Pᵀ·dO_j, dK_j += dSᵀ·Q_j
          mma_ab_part2<kD>(dv_acc[x], pt_s, qt + W::kTile, dk_acc[x], dst_s, qt, row0, live, cw, blocks, blocks);
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int x = 0; x < kMaxChunks; ++x) {
      if (x >= owned) continue;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = 8 * (cw + 4 * j) + 2 * t;
        if (col >= kD) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = (row0 + g + 8 * i) * kLd + col;
          *reinterpret_cast<float2*>(slots + x * W::kOwnTile + row) =
              make_float2(dk_acc[x][j][2 * i], dk_acc[x][j][2 * i + 1]);
          *reinterpret_cast<float2*>(slots + (kMaxChunks + x) * W::kOwnTile + row) =
              make_float2(dv_acc[x][j][2 * i], dv_acc[x][j][2 * i + 1]);
        }
      }
    }
  }
  __syncthreads();
  for (int x = 0; x < owned; ++x) {
    const int col = (c_lo + x) * cl.width, cols = chunk_cols(cl, c_lo + x);
    store_tile<kD, kWOwn, kWThreads>(dk + b * s.dk[0] + h * s.dk[1] + col, s.dk[2], k0, seq, cols, narrow,
                                     slots + x * W::kOwnTile);
    store_tile<kD, kWOwn, kWThreads>(dv + b * s.dv[0] + h * s.dv[1] + col, s.dv[2], k0, seq, cols, narrow,
                                     slots + (kMaxChunks + x) * W::kOwnTile);
  }
}

// The forward of a chunked width: one block per (query tile of 32, head and
// group of column chunks, item). Per key tile of 64, phase 1 walks every
// column chunk (each step brings Q_c and K_c) and sums S = Σ_c Q_c·K_cᵀ in
// chunk order, each warp its 16 x 16 slice, each k-step's products summed
// on their own (mma_abt_fresh); at the last chunk the logits, the row max over the row group's
// four warps (through shared memory), the online softmax's rescaling of O
// and the row sums, and P into an exchanged tile; phase 2 walks the block's
// own chunks two at a time (each step brings their V) and adds P·V_j into
// accumulators over the whole width. At the end O / Σ through the caller's
// strides and, group 0, the row LSE. Q stays in shared memory when the
// width has at most kMaxChunks chunks (dh up to 512: 68 KB at kD 128, which
// the slots leave room for); a wider head streams Q_c with K_c, from L2.
template <int kD, bool kGated>
__global__ void __launch_bounds__(kWThreads, 1)
tf32x3_forward_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                           const uint8_t* __restrict__ pad, float* __restrict__ out, float* __restrict__ lse,
                           int heads, int seq, float scale, FwdStrides s, Gated gd, Cols cl) {
  using W = Wide<kD>;
  constexpr int kLd = W::kLd, kPer = W::kPer;
  extern __shared__ __align__(128) unsigned char smem[];
  float* slots = reinterpret_cast<float*>(smem);  // [2]: Q_c [32][kLd], K_c [64][kLd] (phase 2: V_j, V_j+1 [64][kLd])
  float* q_res = slots + 2 * W::kFwdSlot;         // [kMaxChunks][32][kLd]: Q when resident
  float* p_s = q_res + kMaxChunks * W::kOwnTile;  // [32][kXLd]: P of the key tile
  float* kbias_s = p_s + kWOwn * kXLd;            // [2][kWN]
  float* red_s = kbias_s + 2 * kWN;               // [4 warps][32 rows]: the warps' parts of a row statistic

  const int groups = (cl.chunks + kMaxChunks - 1) / kMaxChunks;
  const int q0 = blockIdx.x * kWOwn, h = blockIdx.y / groups, grp = blockIdx.y % groups, b = blockIdx.z;
  const int n = cl.chunks, c_lo = grp * kMaxChunks, owned = min(kMaxChunks, n - c_lo);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int cw = warp & 3, row0 = 16 * (warp >> 2);
  const bool active = q0 + row0 < seq;  // warp-uniform: the row group has a query below seq
  const float* qb = q + b * s.q[0] + h * s.q[1];
  const float* kb = k + b * s.k[0] + h * s.k[1];
  const float* vb = v + b * s.v[0] + h * s.v[1];
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
  const int per_tile = n + (owned + 1) / 2, n_steps = (seq + kWN - 1) / kWN * per_tile;
  const bool narrow = cl.narrow, resident = n <= kMaxChunks;
  const float c = scale * kLog2e;

  // Step st: key tile st / per_tile; phase 1 (chunk r < n) brings K_r and,
  // unless Q is resident, Q_r (and with the first, the keys' padding), phase
  // 2 the tile's V_j for two of the block's chunks at a time (j = 2(r - n)
  // and the next).
  auto prefetch = [&](int st, int slot) {
    const int it = st / per_tile, r = st % per_tile, k0 = it * kWN;
    float* sl = slots + slot * W::kFwdSlot;
    if (r < n) {
      const int col = r * cl.width, cols = chunk_cols(cl, r);
      if (!resident) load_tile<kD, kWOwn, kWThreads>(sl, qb + col, s.q[2], q0, seq, cols, narrow);
      load_tile<kD, kWN, kWThreads>(sl + W::kOwnTile, kb + col, s.k[2], k0, seq, cols, narrow);
      if (r == 0) load_key_bias<kWThreads, kWN>(kbias_s + (it & 1) * kWN, pad_b, s.pad[1], k0, seq);
    } else {
      for (int x = 2 * (r - n); x < min(owned, 2 * (r - n) + 2); ++x) {
        const int j = c_lo + x;
        load_tile<kD, kWN, kWThreads>(sl + (x & 1) * W::kTile, vb + j * cl.width, s.v[2], k0, seq, chunk_cols(cl, j),
                                      narrow);
      }
    }
  };

  if (resident)
    for (int x = 0; x < n; ++x)
      load_tile<kD, kWOwn, kWThreads>(q_res + x * W::kOwnTile, qb + x * cl.width, s.q[2], q0, seq, chunk_cols(cl, x),
                                      narrow);
  prefetch(0, 0);
  cp_async_commit();
  // This lane's rows g and g+8: the running max in log2 units (the same in
  // the row group's four warps), this warp's part of the row sum (its keys
  // of each tile), and for the gated variant gate·log2e.
  float mx[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f}, gl[2] = {0.f, 0.f};
  if (kGated) {
#pragma unroll
    for (int i = 0; i < 2; ++i) gl[i] = gate_at(gd, b, h, min(q0 + row0 + g + 8 * i, seq - 1)) * kLog2e;
  }
  float sc[2][4];
  float acc[kMaxChunks][kPer][4];
#pragma unroll
  for (int x = 0; x < kMaxChunks; ++x)
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][j][e] = 0.f;
  for (int st = 0; st < n_steps; ++st) {
    const int slot = st & 1;
    if (st + 1 < n_steps) {
      prefetch(st + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int it = st / per_tile, r = st % per_tile, k0 = it * kWN;
    const float* sl = slots + slot * W::kFwdSlot;
    if (r < n) {
      if (r == 0) zero<16>(sc);
      if (active)  // S += Q_c·K_cᵀ
        mma_abt_slice<kD>(sc, resident ? q_res + r * W::kOwnTile : sl, sl + W::kOwnTile, row0, cw, k0, seq,
                          ksteps_of<kD>(chunk_cols(cl, r)));
      if (r == n - 1) {
        // The logits in log2 units, as the wide dQ kernel forms them from
        // its S, and this warp's part of the row max.
        if (active) {
          const float* kbias = kbias_s + (it & 1) * kWN;
          float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1, key = 16 * cw + 8 * j + 2 * t + (e & 1);
              const float kbv = kbias[key];
              if (kGated) {
                const float bias = __ldg(gd.bias + h * gd.bs[0] + min(q0 + row0 + g + 8 * i, seq - 1) * gd.bs[1] +
                                         min(k0 + key, seq - 1) * gd.bs[2]);
                sc[j][e] = fmaf(sc[j][e], c, bias * gl[i] + kbv);
              } else {
                sc[j][e] = fmaf(sc[j][e], c, kbv);
              }
              tmax[i] = fmaxf(tmax[i], sc[j][e]);
            }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
            tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
            if (t == 0) red_s[cw * kWOwn + row0 + g + 8 * i] = tmax[i];
          }
        }
        __syncthreads();
        if (active) {
          float shift[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + g + 8 * i;
            const float tm = fmaxf(fmaxf(red_s[row], red_s[kWOwn + row]),
                                   fmaxf(red_s[2 * kWOwn + row], red_s[3 * kWOwn + row]));
            const float m_new = fmaxf(mx[i], tm);
            shift[i] = m_new == -INFINITY ? 0.f : m_new;  // as the one-chunk forward: no NaN while all padded
            const float corr = exp2_approx(mx[i] - shift[i]);
            mx[i] = m_new;
            lsum[i] *= corr;
#pragma unroll
            for (int x = 0; x < kMaxChunks; ++x)
#pragma unroll
              for (int j = 0; j < kPer; ++j) {
                acc[x][j][2 * i] *= corr;
                acc[x][j][2 * i + 1] *= corr;
              }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[j][e] = exp2_approx(sc[j][e] - shift[e >> 1]);  // P, unnormalised
              lsum[e >> 1] += sc[j][e];
            }
          write_slice(p_s, row0, cw, sc);
        }
      }
    } else if (active) {
      const int x0 = 2 * (r - n);  // the block's chunks x0 and x0 + 1 (if it has one)
      const int live = live_blocks_w(k0, seq);
      const int blocks0 = (chunk_cols(cl, c_lo + x0) + 7) >> 3;
      const int blocks1 = x0 + 1 < owned ? (chunk_cols(cl, c_lo + x0 + 1) + 7) >> 3 : 0;
#pragma unroll
      for (int x = 0; x < kMaxChunks; x += 2)
        if (x == x0)  // O_j += P·V_j for both chunks, interleaved
          mma_ab_part2<kD, true>(acc[x], p_s, sl, acc[x + 1], p_s, sl + W::kTile, row0, live, cw, blocks0, blocks1);
    }
    __syncthreads();
  }

  // The row sums over the row group's four warps (in warp order), then
  // O / Σ into the slots and the LSE.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float part = quad_sum(lsum[i]);
    if (t == 0) red_s[cw * kWOwn + row0 + g + 8 * i] = part;
  }
  __syncthreads();
  if (active) {
    const long long stat0 = ((long long)b * heads + h) * seq;
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i, qi = q0 + row;
      const float sum = ((red_s[row] + red_s[kWOwn + row]) + red_s[2 * kWOwn + row]) + red_s[3 * kWOwn + row];
      inv[i] = 1.f / sum;  // a row whose keys are all padded: NaN and LSE −inf, as the one-chunk forward
      if (lse && grp == 0 && cw == 0 && t == 0 && qi < seq) lse[stat0 + qi] = (mx[i] + log2f(sum)) * kLn2;
    }
#pragma unroll
    for (int x = 0; x < kMaxChunks; ++x) {
      if (x >= owned) continue;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = 8 * (cw + 4 * j) + 2 * t;
        if (col >= kD) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(slots + x * W::kOwnTile + (row0 + g + 8 * i) * kLd + col) =
              make_float2(acc[x][j][2 * i] * inv[i], acc[x][j][2 * i + 1] * inv[i]);
      }
    }
  }
  __syncthreads();
  for (int x = 0; x < owned; ++x)
    store_tile<kD, kWOwn, kWThreads>(out + b * s.o[0] + h * s.o[1] + (c_lo + x) * cl.width, s.o[2], q0, seq,
                                     chunk_cols(cl, c_lo + x), narrow, slots + x * W::kOwnTile);
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

// The forward of one column chunk (16-byte or narrow rows) or, on the
// builds from 80, of column chunks. Narrow rows of at most 16 columns run on
// 16-column tiles (the 32 build's kernel at kD 16): half the 4-byte loads of
// the build's own tiles, 15% faster at dh 12 (PERF.md).
template <bool kGated>
cudaError_t launch_forward(const void* q, const void* k, const void* v, const void* pad, void* out, void* lse,
                           int batch, int heads, int seq, const Cols& cl, float scale, const FwdStrides& s,
                           const Gated& gd, cudaStream_t st) {
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fpad = static_cast<const uint8_t*>(pad);
  auto* fout = static_cast<float*>(out);
  auto* flse = static_cast<float*>(lse);
  if (cl.chunks == 1) {
    auto launch = [&](auto kernel, size_t smem) {
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<dim3((seq + kOwn - 1) / kOwn, heads, batch), kThreads, smem, st>>>(fq, fk, fv, fpad, fout, flse,
                                                                                  heads, seq, cl.dim, scale, s, gd);
      return cudaGetLastError();
    };
    if constexpr (kHeadDim == 32)
      if (cl.narrow && cl.dim <= 16) return launch(tf32x3_forward_kernel<16, kGated, true>, Tile<16>::kFwdSmem);
    constexpr size_t smem = Tile<kHeadDim>::kFwdSmem;
    return cl.narrow ? launch(tf32x3_forward_kernel<kHeadDim, kGated, true>, smem)
                     : launch(tf32x3_forward_kernel<kHeadDim, kGated, false>, smem);
  }
  if constexpr (kHeadDim >= 80) {
    using W = Wide<kHeadDim>;
    const int groups = (cl.chunks + kMaxChunks - 1) / kMaxChunks;
    cudaError_t err = allow_smem(tf32x3_forward_wide_kernel<kHeadDim, kGated>, W::kFwdSmem);
    if (err != cudaSuccess) return err;
    tf32x3_forward_wide_kernel<kHeadDim, kGated>
        <<<dim3((seq + kWOwn - 1) / kWOwn, heads * groups, batch), kWThreads, W::kFwdSmem, st>>>(
            fq, fk, fv, fpad, fout, flse, heads, seq, scale, s, gd, cl);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // plan_cols refuses it first
  }
}

// The columns of a call of head width head_dim in chunks of
// chunk_width (the wrapper's plan), or a Cols with chunks = 0 when this
// build does not take them: a chunk wider than the build; more than one
// chunk of a width that is not a multiple of 8, or on a build below 80; a
// call on 16-byte rows whose widths are not multiples of 8.
Cols plan_cols(int head_dim, int chunk_width, int narrow) {
  Cols cl;
  cl.chunks = 0;
  if (head_dim <= 0 || chunk_width <= 0 || chunk_width > kHeadDim) return cl;
  const int chunks = (head_dim + chunk_width - 1) / chunk_width;
  if ((chunks > 1 && (chunk_width % 8 || kHeadDim < 80)) || (chunks == 1 && chunk_width != head_dim) ||
      (!narrow && (head_dim % 8 || chunk_width % 8)))
    return cl;
  cl.dim = head_dim;
  cl.width = chunk_width;
  cl.chunks = chunks;
  cl.narrow = narrow != 0;
  return cl;
}

// The dQ and dK/dV kernels of one column chunk, on 16-byte or narrow rows.
template <bool kGated, bool kNarrow>
cudaError_t launch_one_chunk(const float* q, const float* k, const float* v, const void* out, const float* dout,
                             const uint8_t* pad, const float* lse, void* dq, void* dk, void* dv, void* delta,
                             void* dgate, const float* rebased, int batch, int heads, int seq, const Cols& cl,
                             float scale, const BwdStrides& s, const Gated& gd, cudaStream_t st) {
  using TL = Tile<kHeadDim>;
  const dim3 own_grid((seq + kOwn - 1) / kOwn, heads, batch);
  cudaError_t err = allow_smem(tf32x3_dq_kernel<kHeadDim, kGated, kNarrow>, TL::kDqSmem);
  if (err != cudaSuccess) return err;
  tf32x3_dq_kernel<kHeadDim, kGated, kNarrow><<<own_grid, kThreads, TL::kDqSmem, st>>>(
      q, k, v, static_cast<const float*>(out), dout, pad, lse, static_cast<float*>(dq), static_cast<float*>(delta),
      static_cast<float*>(dgate), heads, seq, scale, s, gd, cl);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = allow_smem(tf32x3_dkv_kernel<kHeadDim, kGated, kNarrow>, TL::kDkvSmem);
  if (err != cudaSuccess) return err;
  tf32x3_dkv_kernel<kHeadDim, kGated, kNarrow><<<own_grid, kThreads, TL::kDkvSmem, st>>>(
      q, k, v, dout, pad, rebased, static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      heads, seq, scale, s, gd, cl);
  return cudaGetLastError();
}

template <bool kGated>
cudaError_t launch_backward(const void* q, const void* k, const void* v, const void* out, const void* dout,
                            const void* pad, const void* lse, void* dq, void* dk, void* dv, void* delta,
                            void* dbias, void* dgate, void* part, int items, int batch, int heads, int seq,
                            const Cols& cl, float scale, const BwdStrides& s, const Gated& gd, cudaStream_t st) {
  using TL = Tile<kHeadDim>;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fdo = static_cast<const float*>(dout);
  const auto* fpad = static_cast<const uint8_t*>(pad);
  const auto* flse = static_cast<const float*>(lse);
  // delta holds Δ' and, after it, the rebased LSE in log2 units (the dQ kernel's)
  const float* rebased = static_cast<const float*>(delta) + (long long)batch * heads * seq;
  cudaError_t err = cudaSuccess;

  if (cl.chunks == 1) {
    err = cl.narrow ? launch_one_chunk<kGated, true>(fq, fk, fv, out, fdo, fpad, flse, dq, dk, dv, delta, dgate, rebased,
                                                     batch, heads, seq, cl, scale, s, gd, st)
                    : launch_one_chunk<kGated, false>(fq, fk, fv, out, fdo, fpad, flse, dq, dk, dv, delta, dgate,
                                                      rebased, batch, heads, seq, cl, scale, s, gd, st);
    if (err != cudaSuccess) return err;
  } else {
    if constexpr (kHeadDim >= 80) {
      using W = Wide<kHeadDim>;
      const int groups = (cl.chunks + kMaxChunks - 1) / kMaxChunks;
      const dim3 own_grid((seq + kWOwn - 1) / kWOwn, heads * groups, batch);
      err = allow_smem(tf32x3_dq_wide_kernel<kHeadDim, kGated>, W::kDqSmem);
      if (err != cudaSuccess) return err;
      tf32x3_dq_wide_kernel<kHeadDim, kGated><<<own_grid, kWThreads, W::kDqSmem, st>>>(
          fq, fk, fv, static_cast<const float*>(out), fdo, fpad, flse, static_cast<float*>(dq),
          static_cast<float*>(delta), static_cast<float*>(dgate), heads, seq, scale, s, gd, cl);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      err = allow_smem(tf32x3_dkv_wide_kernel<kHeadDim, kGated>, W::kDkvSmem);
      if (err != cudaSuccess) return err;
      tf32x3_dkv_wide_kernel<kHeadDim, kGated><<<own_grid, kWThreads, W::kDkvSmem, st>>>(
          fq, fk, fv, fdo, fpad, rebased, static_cast<const float*>(delta), static_cast<float*>(dk),
          static_cast<float*>(dv), heads, seq, scale, s, gd, cl);
    } else {
      return cudaErrorInvalidValue;  // plan_cols refuses it first
    }
  }
  if ((err = cudaGetLastError()) != cudaSuccess || !kGated) return err;

  const int chunks = (batch + items - 1) / items;
  const dim3 grid((seq + kOwn - 1) / kOwn, (seq + kN - 1) / kN, heads * chunks);
  float* dbias_out = static_cast<float*>(chunks > 1 ? part : dbias);
  auto launch_dbias = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, TL::kDbiasSmem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, TL::kDbiasSmem, st>>>(fq, fk, fv, fdo, fpad, rebased, static_cast<const float*>(delta),
                                                   dbias_out, batch, items, heads, seq, scale, s, gd, cl);
    return cudaGetLastError();
  };
  if (cl.chunks > 1) {
    if constexpr (kHeadDim >= 80) err = launch_dbias(tf32x3_dbias_kernel<kHeadDim, 2>);
  } else {
    err = cl.narrow ? launch_dbias(tf32x3_dbias_kernel<kHeadDim, 1>) : launch_dbias(tf32x3_dbias_kernel<kHeadDim, 0>);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || chunks == 1) return err;
  const long long n = (long long)heads * seq * seq;
  sum_chunks_kernel<<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), n, chunks);
  return cudaGetLastError();
}

}  // namespace

// The fp32 forward, gated (K1, K2: bias not null) or bias-free (K4, K5):
// out = softmax(q·kᵀ·scale (+ gate ⊙ bias) + pad) · v. fp32 q, k, v and out
// with a head width head_dim >= 1 in column chunks of chunk_width and narrow
// as the backward below takes them (the wrapper's plan); bias fp32 [H, T, T]
// and gate fp32 [B, H, T] (may be null: a gate of 1); pad one byte a key,
// nonzero = padded (may be null). lse, when not null, receives the row
// log-sum-exp of the logits (float32, contiguous [B, H, T]) for the backward
// below. strides: 20 element strides, q, k, v and out (batch, head, token),
// bias (head, query, key), gate (batch, head, token), then pad (batch,
// token). Returns a cudaError_t; 0 means the kernel was launched. A call the
// build does not take returns cudaErrorInvalidValue and launches nothing.
extern "C" int avex_tf32x3_attention_forward(const void* q, const void* k, const void* v, const void* bias,
                                             const void* gate, const void* pad, void* out, void* lse, int batch,
                                             int heads, int seq, int head_dim, int chunk_width, int narrow,
                                             float scale, const long long* strides, void* stream) {
  const Cols cl = plan_cols(head_dim, chunk_width, narrow);
  const long long groups = (cl.chunks + kMaxChunks - 1) / kMaxChunks;
  if (cl.chunks == 0 || seq <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads * groups > 65535 ||
      (gate != nullptr && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  FwdStrides s;
  memcpy(&s, strides, 12 * sizeof(long long));
  memcpy(s.pad, strides + 18, 2 * sizeof(long long));
  Gated gd;
  gd.bias = static_cast<const float*>(bias);
  gd.gate = static_cast<const float*>(gate);
  memcpy(gd.bs, strides + 12, 3 * sizeof(long long));
  memcpy(gd.gs, strides + 15, 3 * sizeof(long long));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias == nullptr)
    return (int)launch_forward<false>(q, k, v, pad, out, lse, batch, heads, seq, cl, scale, s, Gated(), st);
  return (int)launch_forward<true>(q, k, v, pad, out, lse, batch, heads, seq, cl, scale, s, gd, st);
}

// The fp32 backward from the forward's residuals, bias-free (K6, bias null)
// or gated (K3): fp32 q, k, v, out (the forward's output) and dout, with a
// head width head_dim >= 1 in column chunks of chunk_width (head_dim itself
// up to this build's width; past it a multiple of 8 up to the build's width,
// the last chunk holding what is left; the wrapper's plan), narrow = 1 when
// some row is not 16-byte aligned (a head width, chunk width or stride that
// is not a multiple of 8 elements, or a base off 16 bytes: then every row
// moves 4 bytes at a time); lse the forward's row log-sum-exp (float32,
// contiguous [B, H, T], the forward's above); bias, gate
// (may be null) and pad (one byte a key, nonzero = padded; may be null) as
// the forward's. Writes fp32 dq, dk and dv, and into delta (float32 scratch,
// contiguous [2, B, H, T]) each row's Δ' = Σ P·dP / Σ P and its LSE rebased
// by log2 Σ P, in log2 units (see the dQ kernel); the gated backward also
// writes dbias (float32 [H, T, T], contiguous) and, with a gate, dgate
// (float32 [B, H, T], contiguous). It sums dbias over chunks of
// items_per_chunk batch items in parallel, then the chunks in order, through
// dbias_part (float32 scratch [ceil(B / items_per_chunk), H, T, T]; may be
// null when that is one chunk). strides: 32 element strides, q, k, v, out,
// dout, dq, dk and dv (batch, head, token), pad (batch, token), then bias
// (head, query, key) and gate (batch, head, token). Returns a cudaError_t; 0
// means every kernel was launched. A call the build does not take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int avex_tf32x3_attention_backward(const void* q, const void* k, const void* v, const void* out,
                                              const void* dout, const void* bias, const void* gate, const void* pad,
                                              const void* lse, void* dq, void* dk, void* dv, void* delta, void* dbias,
                                              void* dgate, void* dbias_part, int items_per_chunk, int batch,
                                              int heads, int seq, int head_dim, int chunk_width, int narrow,
                                              float scale, const long long* strides, void* stream) {
  const Cols cl = plan_cols(head_dim, chunk_width, narrow);
  const long long groups = (cl.chunks + kMaxChunks - 1) / kMaxChunks;
  if (cl.chunks == 0 || seq <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads * groups > 65535 ||
      lse == nullptr || out == nullptr || (bias != nullptr && dbias == nullptr) ||
      (gate != nullptr && (bias == nullptr || dgate == nullptr)) || items_per_chunk <= 0 ||
      (items_per_chunk < batch && bias != nullptr && dbias_part == nullptr) ||
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
                                       batch, batch, heads, seq, cl, scale, s, Gated(), st);
  return (int)launch_backward<true>(q, k, v, out, dout, pad, lse, dq, dk, dv, delta, dbias, dgate, dbias_part,
                                    items_per_chunk, batch, heads, seq, cl, scale, s, gd, st);
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
  cudaError_t err = allow_smem(tf32x3_dbias_kernel<kHeadDim, 0>, TL::kDbiasSmem);
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tf32x3_dbias_kernel<kHeadDim, 0>, kThreads,
                                                        TL::kDbiasSmem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  *blocks = ((seq + kOwn - 1) / kOwn) * ((seq + kN - 1) / kN) * heads;
  *resident = (per_sm > 0 ? per_sm : 1) * sms;
  return 0;
}
