// Attention in bf16 on Hopper's tensor cores (sm_90a), plain C ABI:
//
//   gated:     out = softmax(q·kᵀ·scale + gate ⊙ bias + pad) · v, with its backward
//   bias-free: out = softmax(q·kᵀ·scale + pad) · v, with its backward
//
// Replaces, for bf16 operands, six Pallas TPU kernels of the JAX package:
//   - _attention_kernel            avex_tpu/ops/pallas_attention.py:126  (K1, gated, split q/k/v [B,H,T,D])
//   - _fused_qkv_gated_kernel      avex_tpu/ops/pallas_attention.py:389  (K2, gated, column views of [B,T,3E])
//   - _fused_qkv_gated_bwd_kernel  avex_tpu/ops/pallas_attention.py:765  (K3, its backward)
//   - _fused_qkv_kernel            avex_tpu/ops/pallas_attention.py:344  (K5, column views of [B,T,3E])
//   - _fused_qkv_bwd_kernel        avex_tpu/ops/pallas_attention.py:524  (K6, its backward)
//   - _plain_attention_kernel      avex_tpu/ops/pallas_attention.py:161  (K4, split q/k/v [B,H,T,D])
// The layouts are only strides here: every operand is a base pointer plus
// (batch, head, token) strides with the head dimension contiguous. Every
// kernel, gated or bias-free, takes any head width D >= 1. The width kD is a
// template parameter, and each build of this source instantiates one, chosen
// with -DAVEX_HEAD_DIM: 32, 64, 80, 96 or 128, one library a width, built in
// parallel. A D that is a multiple of 8 up to 128, with 16-byte aligned rows,
// runs on the kernels of the smallest kD that holds it, its columns D .. kD-1
// zero-filled on load (per 16-byte chunk, from the column index: in the
// fused layout they are the next head's) and never stored; zero columns add
// 0 to q·k, to every product and to Δ, so the result is exact. Any other
// call runs on the general kernels (forward_any_kernel, dq_any_kernel,
// dkv_any_kernel, dbias_any_kernel), with two more freedoms:
//   - narrow rows: a D or a stride that is not a multiple of 8 elements, or
//     a base off a 16-byte boundary (dh 12 in [B, T, 3E]: head h starts at
//     24·h bytes), is read element by element into the same zero-filled
//     shared tiles and written element by element; the wrapper copies no
//     operand to pad it;
//   - column chunks: past 128, D is cut into n = ceil(D/128) chunks of a
//     multiple of 8 (each starts 16-byte aligned; the last holds what is
//     left), run on the build that holds one. The block of chunk c owns O_c
//     (or dQ_c, dK_c, dV_c) and walks, for each tile of keys (or queries),
//     every chunk in turn, its own last: S = Σ Q_cc·K_ccᵀ and dP = Σ dO_cc·
//     V_ccᵀ sum over the whole width from streamed tiles, then the chunk's
//     own product. S is recomputed by every chunk's block (n times the QKᵀ
//     work); Δ = rowsum(dO ∘ O) is taken over the whole width; the LSE,
//     Δ, dgate and dbias are written once (chunk 0's blocks; dbias has no
//     chunk axis). The dK/dV work runs as two launches, dV then dK, each
//     about half the registers of dkv_kernel, whose four accumulators pass
//     255 registers once the chunk sums are carried across steps.
// Every fp32 call, forward (K1, K2, K4, K5) or backward (K3, K6), at every
// head width, runs on the tensor cores in 3xTF32 in tf32x3_attention.cu.
//
// Numerics, as the TPU kernels (pallas_attention.py:126-158, :344-430,
// :524-585, :765-843): fp32 logits and softmax; P rounded to bf16 before P·V
// and Pᵀ·dO; dS = P∘(dP−Δ)·scale rounded to bf16 before dS·K and dSᵀ·Q; every
// product accumulates in fp32; a padded key gets −inf, and a row whose keys
// are all padded gives NaN, as the plain twin's softmax does. The forward
// rounds the unnormalised P to bf16 and divides by the row sum at the end
// (the twin rounds the normalised P). The gated logits are, in the exp2
// domain, x = fmaf(s, scale·log2e, (gate·log2e)·bias) (plus the key bias
// where keys are padded or past T); without a gate the factor is log2e alone.
// Every gated kernel forms them the same way, so that the backward's P
// agrees with the log-sum-exp the forward saved. The gated backward's extra
// cotangents are dgate[b,h,t] = Σ_k bias·dL and dbias[h] = Σ_b gate ⊙ dL,
// with dL = P∘(dP−Δ) in fp32 (not scaled, not rounded).
//
// Bounds on an H100 SXM at the main paths' shapes (H=12, D=64, bf16):
//   gated forward, BEATs B=128, T=248: q, k, v read and out written once,
//     4 x 48.8 MB, plus the fp32 bias (2.95 MB, shared by every item) and
//     gate (1.5 MB): 199.5 MB, 0.0596 ms at 3.35 TB/s, against 4·B·H·T²·D =
//     24.2 GFLOP, 0.0245 ms at 989 TFLOP/s: bound by bytes;
//   forward, EAT B=128, T=513: 4 x 100.9 MB = 403.6 MB, 0.120 ms, against
//     103.5 GFLOP, 0.105 ms: bound by bytes, narrowly;
//   backward, EAT B=64, T=513: five products, 10·B·H·T²·D = 129.4 GFLOP,
//     0.131 ms, against 7 x 50.4 MB = 353 MB, 0.105 ms: bound by operations;
//   gated backward, BEATs B=64, T=248: 30.2 GFLOP, 0.031 ms, against 7 x
//     24.4 MB plus bias, dbias, gate and dgate, 178 MB, 0.053 ms: bound by
//     bytes;
//   forward, Bird-MAE huge (H=16, D=80) B=128, T=513: 4 x 168.1 MB = 672 MB,
//     0.2007 ms, against 172.5 GFLOP, 0.1744 ms: bound by bytes;
//   backward, Bird-MAE huge B=64, T=513: 215.6 GFLOP, 0.2180 ms, against 7 x
//     84.0 MB, 0.1756 ms: bound by operations.
// Against the byte bound the design reads q once and each K/V tile once per
// block of 64 queries (four times at T=248, from L2 after the first), and
// keeps the bias, the one operand of the gated forward that is [T, T] per
// head, out of device memory: all 12 heads' bias stay resident in the 50 MB
// L2 while the blocks of one item (queries fastest, then heads) run, as the
// TPU kernel's (heads, batch) grid order kept it in VMEM
// (pallas_attention.py:21-23). Every bias element is read by one lane only,
// so no block shares it: a lane loads its fragment (rows g and g+8, keys
// 8j+2t, 8j+2t+1: 32 floats a 64-key tile) from L2 straight into registers
// before the tile's QKᵀ, which hides the L2 latency behind the products.
// Staging the tile through shared memory with K and V instead costs 37 KB a
// block and timed slower at every block shape (PERF.md).
//
// Design (FlashAttention-2 on mma.sync.m16n8k16 bf16 with fp32 accumulators).
// Every block has 4 warps and owns a tile of 64 rows; each warp owns 16 of
// them, so a row's max and sum stay inside one quad of lanes. Tiles of 64
// rows x D dims are bf16 in shared memory (8 KB at D=64), filled by 16-byte
// cp.async with zero-fill past T, double-buffered so that the next key (or
// query) tile arrives while this one is multiplied. A 64-wide row's 8 chunks
// of 16 bytes are XOR-swizzled by the row's low 3 bits, so ldmatrix (and
// ldmatrix.trans for the operands read as [K, N]) has no bank conflicts, and
// so is a 128-wide row's 16; the rows of 32, 80 and 96 (4, 10 and 12
// chunks) sit at an odd stride of 5, 11 and 13 chunks instead (struct
// Layout), which spreads the 8 rows of an ldmatrix phase over all 32 banks
// too. QKᵀ takes kD/16 k-steps of 16, and P·V, dQ, dK and dV kD/8 n8
// accumulator tiles a warp; the dK/dV kernel holds two of them (232
// registers a thread at D=80, bias-free). Past 80 (dK and dV together: kD
// accumulator floats a thread, 96 or 128) the dK/dV, dQ and dbias kernels
// read the A operand of S and dP from shared memory one k-step at a time
// (mma_abt_stream) instead of holding it in registers, which keeps them
// within 255 registers without spilling (chip_smoke.py's build phase prints
// each kernel's count); the forward holds Q at every width.
// Products are fragments
// in registers: S = QKᵀ never leaves them, and P (or dS) is rounded to bf16
// and repacked from the accumulator layout straight into the A-operand layout
// of the next product. A tile whose rows all lie below T (and, in the
// forward, whose keys are unpadded) takes a branch-free path with no key bias
// (the gated variant still adds gate·bias there), which the compiler
// schedules as one block; a ragged tile multiplies only the 16-row groups
// that hold a valid row, and warps with no valid row skip the products: at
// T=513 (8 tiles and one row) and T=248 (3 tiles and 56 rows) the ragged
// tiles cost little. Bias loads of rows or keys past T are clamped to the
// last row or key (their values are never used), so they need no predicate.
// exp2 is one MUFU instruction (ex2.approx.ftz). Those two, more than the
// block's shape, set the forward's speed (PERF.md).
//   - forward: one block per (query tile, head, item); online softmax in the
//     exp2 domain (scale·log2e folded into one multiply). When a backward will
//     follow it also writes the row log-sum-exp, fp32 [B, H, T], and what
//     rounding the output to bf16 dropped, in bf16.
//   - backward: two kernels, deterministic, no atomics, and a third for the
//     gated dbias. The dQ kernel (one block per query tile, head, item) first
//     takes Δ = rowsum(dO∘O) from the forward's output plus its rounding rest
//     (and writes it), then walks the key tiles: S = QKᵀ, P = exp(L − LSE),
//     dP = dO·Vᵀ, dS, dQ += dS·K; the gated variant also sums bias∘dL over
//     the row's keys in registers (the quad, then the tiles) and writes
//     dgate once a row. The dK/dV kernel (one block per key tile, head, item)
//     walks the query tiles: Sᵀ = KQᵀ, dV += Pᵀ·dO, dPᵀ = VdOᵀ, dK += dSᵀ·Q;
//     its gated variant reads the bias transposed, a lane's 32 floats from L2
//     as scalars, and the query tile's gates from shared memory. Seven tile
//     products in all; the saved LSE is what lets the backward skip a pass for
//     the row statistics. Δ from the output rounded to bf16 alone would carry
//     2^-9·|O| of error, which is all of dS where dP − Δ cancels; the rest
//     brings it back to an fp32 output's.
//   - dbias (gated): one block per (query tile, key tile, head, chunk of
//     batch items) walks its items in order, rebuilds S and dP for its 64 x 64
//     tile from q, k, v and dO (two tile products an item, the bias fragments
//     loaded once), and sums gate ⊙ dL in registers; it writes the tile once,
//     and a last pass adds the chunks' partials in chunk order. The wrapper
//     takes as many chunks as one wave of resident blocks holds (two at
//     BEATs' B=64, T=248: 0.128 against 0.182 ms for one, PERF.md); the sum
//     runs in one fixed order, so dbias is deterministic, and it needs no
//     [64, T] rows in shared memory, so it takes any T. Each block rereads
//     its q, dO, K and V tiles from L2 for every item: that traffic, not the
//     products, bounds it.
// Outputs are staged through shared memory and written as 16-byte rows. The
// kernels are templates over the block's shape (warps, 16-row groups a warp,
// keys a forward tile) and over the gated variant;
// scripts/torch_attention_shapes.py times the others.
// mma.sync reaches about two thirds of the tensor cores' rate at best; wgmma
// on TMA-fed tiles is the route to the rest.


#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

// The head width of this build (see kHeadDim below), set with -DAVEX_HEAD_DIM.
#ifndef AVEX_HEAD_DIM
#define AVEX_HEAD_DIM 64
#endif
// The wide builds (96, 128) declare that one resident block an SM is enough,
// which lets ptxas give a thread up to 255 registers: with the thread count
// alone it held some of their kernels at 168 (three blocks of 128 threads an
// SM) and spilled. The builds up to 80 keep the bound they always had.
#if AVEX_HEAD_DIM > 80
#define AVEX_LAUNCH_BOUNDS(threads) __launch_bounds__(threads, 1)
#else
#define AVEX_LAUNCH_BOUNDS(threads) __launch_bounds__(threads)
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;                 // rows of a streamed tile (keys, or queries in dK/dV)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Element strides (batch, head, token) of q, k, v and out, then pad (batch, token).
struct FwdStrides {
  long long q[3], k[3], v[3], o[3];
  long long pad[2];
};

// The gated forward's bias and gate: fp32 [H, T, T] and [B, H, T] with their
// element strides; gate may be null (a gate of 1). vec2: a bias load may
// move two floats, from the strides, T and the base's alignment.
struct Gated {
  const float* bias = nullptr;
  const float* gate = nullptr;
  long long bs[3] = {0, 0, 0}, gs[3] = {0, 0, 0};
  bool vec2 = false;
};

// The same for q, k, v, out, dout, dq, dk and dv, then pad.
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
  long long pad[2];
};

// A [rows][kD] bf16 tile in shared memory, for head width kD (a multiple of
// 16 up to 128). A row whose 16-byte chunks come in whole groups of 8 (kD 64
// and 128) is XOR-swizzled by the row's low 3 bits. Any other row (kD 32, 80,
// 96: 4, 10 and 12 chunks) is stored unswizzled at an odd stride of kD/8 + 1
// chunks: with an odd stride the 8 rows that one ldmatrix phase reads start
// on 8 different 16-byte bank groups, so it has no bank conflicts either, at
// one chunk more a row.
template <int kD>
struct Layout {
  static_assert(kD % 16 == 0 && kD >= 16 && kD <= 128, "head widths: multiples of 16 up to 128");
  static constexpr bool kSwizzle = kD % 64 == 0;
  static constexpr int kChunks = kD / 8;                // 16-byte chunks of a row
  static constexpr int kLd = kSwizzle ? kD : kD + 8;    // elements from one row to the next
  static constexpr int kTile = kRows * kLd;             // elements of one streamed tile
  static constexpr size_t kTileBytes = kTile * sizeof(bf16);
};

// Element offset of chunk `chunk` (8 elements, 16 bytes) of row `row` in a tile.
template <int kD>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (Layout<kD>::kSwizzle) return row * kD + ((chunk ^ (row & 7)) << 3);
  else return row * Layout<kD>::kLd + (chunk << 3);
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] · b[16x8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (inputs below -126 flush to 0; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows r0 .. r0+kTileRows-1 of a [seq, dim] operand with row stride rs into
// a tile of kD columns, asynchronously; rows past seq and the chunks of
// columns dim .. kD-1 (dc = dim / 8 chunks are the operand's) are
// zero-filled, the copy reading nothing. In the fused [B, T, 3E] layout the
// columns past dim are the next head's, so the mask is the column's, not the
// row's end.
template <int kD, int kTileRows, int kThreads>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, long long rs, int r0, int seq, int dc) {
  constexpr int kChunks = Layout<kD>::kChunks;
  for (int c = threadIdx.x; c < kTileRows * kChunks; c += kThreads) {
    // c >= 0: unsigned division, a shift and a mask at 8 or 16 chunks a row
    const int row = (unsigned)c / kChunks, chunk = (unsigned)c % kChunks;
    const bool ok = r0 + row < seq && chunk < dc;
    const bf16* src = ok ? base + (long long)(r0 + row) * rs + chunk * 8 : base;
    cp_async16(tile + swz<kD>(row, chunk), src, ok);
  }
}

// A staged tile's rows r0 .. r0+kTileRows-1 (those below seq; the dc chunks
// of the operand's columns) to a [seq, dim] operand.
template <int kD, int kTileRows, int kThreads>
__device__ __forceinline__ void store_tile(bf16* base, long long rs, int r0, int seq, int dc, const bf16* tile) {
  constexpr int kChunks = Layout<kD>::kChunks;
  for (int c = threadIdx.x; c < kTileRows * kChunks; c += kThreads) {
    const int row = (unsigned)c / kChunks, chunk = (unsigned)c % kChunks;
    if (r0 + row < seq && chunk < dc)
      *reinterpret_cast<uint4*>(base + (long long)(r0 + row) * rs + chunk * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<kD>(row, chunk));
  }
}

// The columns of a call on the general kernels (below): head width D, cut
// into `chunks` column chunks of `width` columns (the last holds what is
// left), each run on this build's kD. narrow: the operands are read and
// written element by element (D, the chunk width or a stride not a multiple
// of 8, or a base not 16-byte aligned), else in 16-byte runs.
struct Cols {
  int dim = 0, width = 0, chunks = 1;
  bool narrow = false;
};

// Columns of chunk cc.
__device__ __forceinline__ int chunk_cols(const Cols& cl, int cc) { return min(cl.width, cl.dim - cc * cl.width); }

// Column chunk of step `step` of a block that owns chunk `own`: the chunks
// in turn, the block's own one last, so that its tiles are the ones in
// shared memory when the chunk's product (P·V, dS·K, Pᵀ·dO, dSᵀ·Q) runs.
__device__ __forceinline__ int step_chunk(int step, int own, int chunks) { return (own + 1 + step % chunks) % chunks; }

// load_tile of columns 0 .. cols-1 (the rest zero): in 16-byte runs by
// cp.async unless narrow, else element by element through registers (a
// synchronous store, visible after the next __syncthreads as the copies are).
template <int kD, int kTileRows, int kThreads>
__device__ __forceinline__ void load_tile_any(bf16* tile, const bf16* base, long long rs, int r0, int seq, int cols,
                                              bool narrow) {
  if (!narrow) {
    load_tile<kD, kTileRows, kThreads>(tile, base, rs, r0, seq, cols >> 3);
    return;
  }
  constexpr int kChunks = Layout<kD>::kChunks;
  for (int c = threadIdx.x; c < kTileRows * kChunks; c += kThreads) {
    const int row = (unsigned)c / kChunks, chunk = (unsigned)c % kChunks;
    union {
      uint4 v;
      unsigned short h[8];
    } x;
    const unsigned short* src = reinterpret_cast<const unsigned short*>(base) + (long long)(r0 + row) * rs + chunk * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) x.h[e] = (r0 + row < seq && chunk * 8 + e < cols) ? src[e] : (unsigned short)0;
    *reinterpret_cast<uint4*>(tile + swz<kD>(row, chunk)) = x.v;
  }
}

// store_tile of columns 0 .. cols-1: in 16-byte runs unless narrow, else
// element by element.
template <int kD, int kTileRows, int kThreads>
__device__ __forceinline__ void store_tile_any(bf16* base, long long rs, int r0, int seq, int cols, bool narrow,
                                               const bf16* tile) {
  if (!narrow) {
    store_tile<kD, kTileRows, kThreads>(base, rs, r0, seq, cols >> 3, tile);
    return;
  }
  constexpr int kChunks = Layout<kD>::kChunks;
  for (int c = threadIdx.x; c < kTileRows * kChunks; c += kThreads) {
    const int row = (unsigned)c / kChunks, chunk = (unsigned)c % kChunks;
    if (r0 + row >= seq || chunk * 8 >= cols) continue;
    union {
      uint4 v;
      unsigned short h[8];
    } x;
    x.v = *reinterpret_cast<const uint4*>(tile + swz<kD>(row, chunk));
    unsigned short* dst = reinterpret_cast<unsigned short*>(base) + (long long)(r0 + row) * rs + chunk * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (chunk * 8 + e < cols) dst[e] = x.h[e];
  }
}

// A warp owns kM groups of 16 rows (rows row0 + 16m .. row0 + 16m + 15).
// Fragments: a[m][k-step][4] (bf16 pairs), accumulators c[m][8-column block][4].

// A fragments of the warp's rows of a tile, over all kD columns (kD/16 k-steps).
template <int kD, int kM>
__device__ __forceinline__ void load_a(uint32_t a[][kD / 16][4], const bf16* tile, int row0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  const int row = row0 + (lane & 7) + ((mat & 1) << 3);
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) ldsm_x4(a[m][kk], tile + swz<kD>(row + 16 * m, 2 * kk + (mat >> 1)));
}

// acc[rows x 16·kNB] += a[rows x kD] · tileᵀ, where the tile's 16·kNB rows
// are acc's columns. Unless kFull, only the first `pairs` groups of 16
// columns are computed. Each B fragment read from shared memory feeds the
// warp's kM row groups.
template <int kD, int kM, int kNB, bool kFull>
__device__ __forceinline__ void mma_abt(float acc[][2 * kNB][4], const uint32_t a[][kD / 16][4], const bf16* tile,
                                        int pairs) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
#pragma unroll
  for (int jp = 0; jp < kNB; ++jp) {
    if (kFull || jp < pairs) {
      const int row = 16 * jp + ((mat >> 1) << 3) + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, tile + swz<kD>(row, 2 * kk + (mat & 1)));
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma(acc[m][2 * jp], a[m][kk], b[0], b[1]);
          mma(acc[m][2 * jp + 1], a[m][kk], b[2], b[3]);
        }
      }
    }
  }
}

// mma_abt with the A operand read from shared memory one k-step at a time
// (the warp's rows row0 .. of a_tile) instead of held in registers: the wide
// instantiations (kD > 80) keep their registers for the accumulators, at one
// ldmatrix a k-step and row group a call.
template <int kD, int kM, int kNB, bool kFull>
__device__ __forceinline__ void mma_abt_stream(float acc[][2 * kNB][4], const bf16* a_tile, int row0,
                                               const bf16* tile, int pairs) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  const int arow = row0 + (lane & 7) + ((mat & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[kM][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) ldsm_x4(a[m], a_tile + swz<kD>(arow + 16 * m, 2 * kk + (mat >> 1)));
#pragma unroll
    for (int jp = 0; jp < kNB; ++jp) {
      if (kFull || jp < pairs) {
        const int row = 16 * jp + ((mat >> 1) << 3) + (lane & 7);
        uint32_t b[4];
        ldsm_x4(b, tile + swz<kD>(row, 2 * kk + (mat & 1)));
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma(acc[m][2 * jp], a[m], b[0], b[1]);
          mma(acc[m][2 * jp + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
}

// acc[rows x kD] += a[rows x 16·kKS] · tile, where the tile's 16·kKS rows run
// along the contraction. Unless kFull, only the first `steps` groups of 16
// tile rows are read.
template <int kD, int kM, int kKS, bool kFull>
__device__ __forceinline__ void mma_ab(float acc[][kD / 8][4], const uint32_t a[][kKS][4], const bf16* tile,
                                       int steps) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    if (kFull || kk < steps) {
      const int row = 16 * kk + ((mat & 1) << 3) + (lane & 7);
#pragma unroll
      for (int jp = 0; jp < kD / 16; ++jp) {
        uint32_t b[4];
        ldsm_x4_trans(b, tile + swz<kD>(row, 2 * jp + (mat >> 1)));
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma(acc[m][2 * jp], a[m][kk], b[0], b[1]);
          mma(acc[m][2 * jp + 1], a[m][kk], b[2], b[3]);
        }
      }
    }
  }
}

// The products over a whole streamed tile (live == kNB) as one branch-free
// block that the compiler schedules as a whole, else predicated on `live`.
template <int kD, int kM, int kNB>
__device__ __forceinline__ void mma_abt_live(float acc[][2 * kNB][4], const uint32_t a[][kD / 16][4],
                                             const bf16* tile, int live) {
  if (live == kNB)
    mma_abt<kD, kM, kNB, true>(acc, a, tile, live);
  else
    mma_abt<kD, kM, kNB, false>(acc, a, tile, live);
}

template <int kD, int kM, int kKS>
__device__ __forceinline__ void mma_ab_live(float acc[][kD / 8][4], const uint32_t a[][kKS][4], const bf16* tile,
                                            int live) {
  if (live == kKS)
    mma_ab<kD, kM, kKS, true>(acc, a, tile, live);
  else
    mma_ab<kD, kM, kKS, false>(acc, a, tile, live);
}

template <int kD, int kM, int kNB>
__device__ __forceinline__ void mma_abt_stream_live(float acc[][2 * kNB][4], const bf16* a_tile, int row0,
                                                    const bf16* tile, int live) {
  if (live == kNB)
    mma_abt_stream<kD, kM, kNB, true>(acc, a_tile, row0, tile, live);
  else
    mma_abt_stream<kD, kM, kNB, false>(acc, a_tile, row0, tile, live);
}

// Accumulators rounded to bf16, as the A operand of the next product (the
// accumulator's columns become its contraction).
template <int kM, int kKS>
__device__ __forceinline__ void to_a(uint32_t a[][kKS][4], const float c[][2 * kKS][4]) {
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      a[m][kk][0] = pack_bf16(c[m][2 * kk][0], c[m][2 * kk][1]);
      a[m][kk][1] = pack_bf16(c[m][2 * kk][2], c[m][2 * kk][3]);
      a[m][kk][2] = pack_bf16(c[m][2 * kk + 1][0], c[m][2 * kk + 1][1]);
      a[m][kk][3] = pack_bf16(c[m][2 * kk + 1][2], c[m][2 * kk + 1][3]);
    }
}

template <int kM, int kCols = 64>
__device__ __forceinline__ void zero(float c[][kCols / 8][4]) {
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][j][e] = 0.f;
}

// What rounding x to bf16 drops: x = bf16(x) + rest(x) to about 2^-17 of x.
__device__ __forceinline__ float bf16_rest(float x) { return x - __bfloat162float(__float2bfloat16(x)); }

// The warp's accumulator rows (kD columns) into a tile as bf16; row g of
// group m scaled by s[m][0], row g+8 by s[m][1]. With kRest, the part of each
// scaled value that its bf16 rounding drops, itself rounded to bf16.
template <int kD, int kM, bool kRest = false>
__device__ __forceinline__ void stage(bf16* tile, int row0, const float c[][kD / 8][4], const float s[][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x0 = c[m][j][2 * i] * s[m][i], x1 = c[m][j][2 * i + 1] * s[m][i];
        if (kRest) x0 = bf16_rest(x0), x1 = bf16_rest(x1);
        *reinterpret_cast<uint32_t*>(tile + swz<kD>(row0 + 16 * m + g + 8 * i, j) + 2 * t) = pack_bf16(x0, x1);
      }
}

// The additive key bias of keys k0 .. k0+kKeys-1: −inf past seq or where padded.
template <int kKeys, int kThreads>
__device__ __forceinline__ void load_key_bias(float* bias, const uint8_t* pad_b, long long ps, int k0, int seq) {
  for (int i = threadIdx.x; i < kKeys; i += kThreads) {
    const int key = k0 + i;
    bias[i] = (key >= seq || (pad_b && pad_b[key * ps])) ? -INFINITY : 0.f;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Eight bf16 values (16 bytes) as floats.
__device__ __forceinline__ void load8(const bf16* p, float x[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Groups of 16 rows of a streamed tile of kTileRows rows starting at r0 that
// hold a row below seq.
template <int kTileRows = kRows>
__device__ __forceinline__ int live_groups(int r0, int seq) { return min(kTileRows / 16, (seq - r0 + 15) >> 4); }

// This lane's bias fragments of the key tile at k0, in the accumulator layout
// (bf[m][j][2i + e]: row g + 8i of group m, key k0 + 8j + 2t + e), from L2.
// row[m][i] points at the row's bias (rows past seq clamped to the last);
// unless kFull, keys past seq are clamped to the last key (their logits get
// the key bias −inf). vec2: keys contiguous, pairs 8-byte aligned, seq even.
template <int kM, int kN, bool kFull>
__device__ __forceinline__ void fetch_bias(float bf[][kN / 8][4], const float* const row[][2], long long ks, int k0,
                                           int seq, bool vec2) {
  const int t = threadIdx.x & 3;
  if (vec2) {
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const int key = kFull ? k0 + 8 * j + 2 * t : min(k0 + 8 * j + 2 * t, seq - 2);
          const float2 x = __ldg(reinterpret_cast<const float2*>(row[m][i] + key));
          bf[m][j][2 * i] = x.x;
          bf[m][j][2 * i + 1] = x.y;
        }
  } else {
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kFull ? k0 + 8 * j + 2 * t + e : min(k0 + 8 * j + 2 * t + e, seq - 1);
            bf[m][j][2 * i + e] = __ldg(row[m][i] + key * ks);
          }
  }
}

// The gate of (item b, head h, row qi), 1 without a gate.
__device__ __forceinline__ float gate_at(const Gated& gd, int b, int h, int qi) {
  return gd.gate ? __ldg(gd.gate + b * gd.gs[0] + h * gd.gs[1] + qi * gd.gs[2]) : 1.f;
}

// This lane's rows r0 + 16m + g (+8) of the bias (row pointers; rows past seq
// clamped to the last, their results are never stored).
template <int kM>
__device__ __forceinline__ void bias_rows(const Gated& gd, int h, int r0, int seq, const float* row[][2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int mm = 0; mm < kM; ++mm)
#pragma unroll
    for (int i = 0; i < 2; ++i) row[mm][i] = gd.bias + h * gd.bs[0] + min(r0 + 16 * mm + g + 8 * i, seq - 1) * gd.bs[1];
}

// The same rows' gate·log2e (log2e alone without a gate), as every gated
// kernel folds it into the logits.
template <int kM>
__device__ __forceinline__ void gate_rows(const Gated& gd, int b, int h, int r0, int seq, float gl[][2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int mm = 0; mm < kM; ++mm)
#pragma unroll
    for (int i = 0; i < 2; ++i) gl[mm][i] = gate_at(gd, b, h, min(r0 + 16 * mm + g + 8 * i, seq - 1)) * kLog2e;
}

// A block of kWarps warps, each owning kM groups of 16 rows: the block's own
// tile (queries, or keys in dK/dV) has kOwn rows; the forward streams key
// tiles of kN rows, the backward tiles of 64. Rows are kD wide.
template <int kD, int kWarps, int kM, int kN = kRows>
struct Shape {
  using L = Layout<kD>;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kOwn = 16 * kM * kWarps;
  static constexpr size_t kOwnBytes = (size_t)kOwn * L::kLd * sizeof(bf16);
  static constexpr size_t kFwdSmem = kOwnBytes + 4 * (size_t)kN * L::kLd * sizeof(bf16) + 2 * kN * sizeof(float);
  static constexpr size_t kDqSmem =
      2 * kOwnBytes + 4 * L::kTileBytes + 2 * kRows * sizeof(float) + kOwn * sizeof(float);
  static constexpr size_t kDkvSmem = 2 * kOwnBytes + 4 * L::kTileBytes + 6 * kRows * sizeof(float);
  static constexpr size_t kDbiasSmem =
      2 * (2 * kOwnBytes + 2 * L::kTileBytes) + 2 * (kRows + 3 * kOwn) * sizeof(float);
  // The general kernels double-buffer their own tiles too (a chunk a step).
  static constexpr size_t kFwdAnySmem = kFwdSmem + kOwnBytes;
  static constexpr size_t kDqAnySmem = kDqSmem + 2 * kOwnBytes;
  static constexpr size_t kDkvAnySmem = kDkvSmem + 2 * kOwnBytes;
};

// One key tile of the forward for a warp: S = Q·Kᵀ, the online softmax, and
// O += P·V. kFull: every key of the tile lies below seq and none is padded,
// so neither the key bias nor a predicate is applied. kGated: the logits add
// bf·gl, the bias fragments times the rows' gate·log2e.
template <int kD, int kM, int kN, bool kFull, bool kGated>
__device__ __forceinline__ void softmax_pv(float sc[][kN / 8][4], const bf16* vt, const float* kbias,
                                           const float bf[][kN / 8][4], const float gl[][2], int live, float c,
                                           float o[][kD / 8][4], float m[][2], float l[][2]);

template <int kD, int kM, int kN, bool kFull, bool kGated>
__device__ __forceinline__ void forward_tile(const uint32_t qf[][kD / 16][4], const bf16* kt, const bf16* vt,
                                             const float* kbias, const float bf[][kN / 8][4], const float gl[][2],
                                             int live, float c, float o[][kD / 8][4], float m[][2], float l[][2]) {
  float sc[kM][kN / 8][4];
  zero<kM, kN>(sc);
  mma_abt<kD, kM, kN / 16, kFull>(sc, qf, kt, live);
  softmax_pv<kD, kM, kN, kFull, kGated>(sc, vt, kbias, bf, gl, live, c, o, m, l);
}

// The rest of a forward tile once S = Q·Kᵀ is in sc: the logits, the online
// softmax and O += P·V.
template <int kD, int kM, int kN, bool kFull, bool kGated>
__device__ __forceinline__ void softmax_pv(float sc[][kN / 8][4], const bf16* vt, const float* kbias,
                                           const float bf[][kN / 8][4], const float gl[][2], int live, float c,
                                           float o[][kD / 8][4], float m[][2], float l[][2]) {
  constexpr int kNB = kN / 16;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int mm = 0; mm < kM; ++mm) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if (kGated) {
          const float gb = bf[mm][j][e] * gl[mm][e >> 1];
          x = fmaf(sc[mm][j][e], c, kFull ? gb : gb + kbias[8 * j + 2 * t + (e & 1)]);
        } else {
          x = kFull ? sc[mm][j][e] * c : fmaf(sc[mm][j][e], c, kbias[8 * j + 2 * t + (e & 1)]);
        }
        sc[mm][j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float shift[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[mm][i], quad_max(mx[i]));
      // A row with every key so far padded keeps m = -inf; shift by 0 there
      // so that exp2 sees -inf - 0 and gives 0 rather than NaN.
      shift[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = exp2_approx(m[mm][i] - shift[i]);
      m[mm][i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(sc[mm][j][e] - shift[e >> 1]);
        sc[mm][j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[mm][i] = l[mm][i] * corr[i] + rs[i];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[mm][j][0] *= corr[0];
      o[mm][j][1] *= corr[0];
      o[mm][j][2] *= corr[1];
      o[mm][j][3] *= corr[1];
    }
  }
  uint32_t pf[kM][kNB][4];
  to_a<kM, kNB>(pf, sc);
  mma_ab<kD, kM, kNB, kFull>(o, pf, vt, live);
}

// kExact: the operands are kD wide (dim == kD), so no column is masked; the
// forward is instantiated both ways, which keeps the exact widths' code (and
// registers) as they were before the narrower widths came.
template <int kD, int kWarps, int kM, int kN, bool kGated, bool kExact = true>
__global__ void AVEX_LAUNCH_BOUNDS(32 * kWarps)
forward_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const uint8_t* __restrict__ pad, bf16* __restrict__ out, bf16* __restrict__ out_rest,
               float* __restrict__ lse, int heads, int seq, int dim, float scale, FwdStrides s, Gated gd) {
  using S = Shape<kD, kWarps, kM, kN>;
  constexpr int kThreads = S::kThreads, kOwn = S::kOwn, kLd = Layout<kD>::kLd, kKeyTile = kN * kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                      // [kOwn][kD]
  bf16* k_s = q_s + kOwn * kLd;                                   // [2][kN][kD]
  bf16* v_s = k_s + 2 * kKeyTile;                                 // [2][kN][kD]
  float* kbias_s = reinterpret_cast<float*>(v_s + 2 * kKeyTile);  // [2][kN]

  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 * kM;
  const bool active = q0 + row0 < seq;  // warp-uniform: the warp has a query below seq
  const bf16* qb = q + b * s.q[0] + h * s.q[1];
  const bf16* kb = k + b * s.k[0] + h * s.k[1];
  const bf16* vb = v + b * s.v[0] + h * s.v[1];
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
  const int n_tiles = (seq + kN - 1) / kN;
  const int dc = kExact ? Layout<kD>::kChunks : dim >> 3;  // chunks of 8 columns the operands have
  const float c = scale * kLog2e;

  // The gated variant: this lane's rows' bias and gate·log2e.
  const float* bias_row[kM][2];
  float gl[kM][2];
  if (kGated) {
    bias_rows<kM>(gd, h, q0 + row0, seq, bias_row);
    gate_rows<kM>(gd, b, h, q0 + row0, seq, gl);
  }

  load_tile<kD, kOwn, kThreads>(q_s, qb, s.q[2], q0, seq, dc);
  load_tile<kD, kN, kThreads>(k_s, kb, s.k[2], 0, seq, dc);
  load_tile<kD, kN, kThreads>(v_s, vb, s.v[2], 0, seq, dc);
  load_key_bias<kN, kThreads>(kbias_s, pad_b, s.pad[1], 0, seq);
  cp_async_commit();

  uint32_t qf[kM][kD / 16][4];
  float o[kM][kD / 8][4];
  zero<kM, kD>(o);
  float m[kM][2], l[kM][2];  // running max (log2 units) and this lane's partial sum, rows g and g+8
#pragma unroll
  for (int mm = 0; mm < kM; ++mm) m[mm][0] = m[mm][1] = -INFINITY, l[mm][0] = l[mm][1] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = buf ^ 1, k0n = (it + 1) * kN;
      load_tile<kD, kN, kThreads>(k_s + nxt * kKeyTile, kb, s.k[2], k0n, seq, dc);
      load_tile<kD, kN, kThreads>(v_s + nxt * kKeyTile, vb, s.v[2], k0n, seq, dc);
      load_key_bias<kN, kThreads>(kbias_s + nxt * kN, pad_b, s.pad[1], k0n, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (it == 0) load_a<kD, kM>(qf, q_s, row0);
      const bf16 *kt = k_s + buf * kKeyTile, *vt = v_s + buf * kKeyTile;
      const float* kbias = kbias_s + buf * kN;
      const bool full = (it + 1) * kN <= seq;
      float bf[kM][kN / 8][4];  // the gated variant's bias fragments of this tile
      if (kGated) {
        // Issued before the tile's QKᵀ, which hides their L2 latency.
        if (full)
          fetch_bias<kM, kN, true>(bf, bias_row, gd.bs[2], it * kN, seq, gd.vec2);
        else
          fetch_bias<kM, kN, false>(bf, bias_row, gd.bs[2], it * kN, seq, gd.vec2);
      }
      if (!pad_b && full)
        forward_tile<kD, kM, kN, true, kGated>(qf, kt, vt, kbias, bf, gl, kN / 16, c, o, m, l);
      else
        forward_tile<kD, kM, kN, false, kGated>(qf, kt, vt, kbias, bf, gl, live_groups<kN>(it * kN, seq), c, o,
                                                m, l);
    }
    __syncthreads();  // every warp is done with this tile's buffers
  }

  if (active) {
    float inv[kM][2];
#pragma unroll
    for (int mm = 0; mm < kM; ++mm)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[mm][i] = quad_sum(l[mm][i]);
        inv[mm][i] = 1.f / l[mm][i];  // a fully padded row: 0 · inf = NaN, as the softmax gives
      }
    stage<kD, kM>(q_s, row0, o, inv);
    if (out_rest) stage<kD, kM, true>(k_s, row0, o, inv);  // the K/V buffers are free now
    if (lse && t == 0) {
#pragma unroll
      for (int mm = 0; mm < kM; ++mm)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qi = q0 + row0 + 16 * mm + g + 8 * i;
          if (qi < seq) lse[((long long)b * heads + h) * seq + qi] = (m[mm][i] + log2f(l[mm][i])) * kLn2;
        }
    }
  }
  __syncthreads();
  store_tile<kD, kOwn, kThreads>(out + b * s.o[0] + h * s.o[1], s.o[2], q0, seq, dc, q_s);
  if (out_rest) store_tile<kD, kOwn, kThreads>(out_rest + b * s.o[0] + h * s.o[1], s.o[2], q0, seq, dc, k_s);
}

// The forward at any head width (the general kernels): one block per (query
// tile, head and column chunk, item) owns its chunk c of the output. It walks
// the key tiles, and for each tile the chunks in turn (its own last): step
// by step S += Q_cc·K_ccᵀ from two streamed tiles, so that S sums over the
// whole width; at the tile's last step the online softmax and O_c += P·V_c.
// With one chunk Q is loaded once. The log-sum-exp is written by chunk 0.
template <int kD, int kWarps, int kM, int kN, bool kGated>
__global__ void AVEX_LAUNCH_BOUNDS(32 * kWarps)
forward_any_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const uint8_t* __restrict__ pad, bf16* __restrict__ out, bf16* __restrict__ out_rest,
                   float* __restrict__ lse, int heads, int seq, float scale, FwdStrides s, Gated gd, Cols cl) {
  using S = Shape<kD, kWarps, kM, kN>;
  constexpr int kThreads = S::kThreads, kOwn = S::kOwn, kLd = Layout<kD>::kLd, kKeyTile = kN * kLd;
  constexpr int kOwnTile = kOwn * kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                      // [2][kOwn][kD]
  bf16* k_s = q_s + 2 * kOwnTile;                                 // [2][kN][kD]
  bf16* v_s = k_s + 2 * kKeyTile;                                 // [2][kN][kD]
  float* kbias_s = reinterpret_cast<float*>(v_s + 2 * kKeyTile);  // [2][kN]

  const int n = cl.chunks, own = blockIdx.y % n, h = blockIdx.y / n, b = blockIdx.z;
  const int q0 = blockIdx.x * kOwn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 * kM;
  const bool active = q0 + row0 < seq;
  const bf16* qb = q + b * s.q[0] + h * s.q[1];
  const bf16* kb = k + b * s.k[0] + h * s.k[1];
  const bf16* vb = v + b * s.v[0] + h * s.v[1] + own * cl.width;
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
  const int n_tiles = (seq + kN - 1) / kN, steps = n_tiles * n, own_cols = chunk_cols(cl, own);
  const float c = scale * kLog2e;

  const float* bias_row[kM][2];
  float gl[kM][2];
  if (kGated) {
    bias_rows<kM>(gd, h, q0 + row0, seq, bias_row);
    gate_rows<kM>(gd, b, h, q0 + row0, seq, gl);
  }

  // Step st's tiles: Q_cc (each step with more than one chunk, once with
  // one), K_cc of its key tile, and at the tile's first step V_c and the key
  // bias.
  auto issue = [&](int st) {
    const int it = st / n, cc = step_chunk(st, own, n), col = cc * cl.width, cols = chunk_cols(cl, cc);
    if (n > 1 || st == 0)
      load_tile_any<kD, kOwn, kThreads>(q_s + (st & 1) * kOwnTile, qb + col, s.q[2], q0, seq, cols, cl.narrow);
    load_tile_any<kD, kN, kThreads>(k_s + (st & 1) * kKeyTile, kb + col, s.k[2], it * kN, seq, cols, cl.narrow);
    if (st % n == 0) {
      load_tile_any<kD, kN, kThreads>(v_s + (it & 1) * kKeyTile, vb, s.v[2], it * kN, seq, own_cols, cl.narrow);
      load_key_bias<kN, kThreads>(kbias_s + (it & 1) * kN, pad_b, s.pad[1], it * kN, seq);
    }
  };
  issue(0);
  cp_async_commit();

  float o[kM][kD / 8][4], sc[kM][kN / 8][4];
  zero<kM, kD>(o);
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mm = 0; mm < kM; ++mm) m[mm][0] = m[mm][1] = -INFINITY, l[mm][0] = l[mm][1] = 0.f;

  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      issue(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int it = st / n;
      const bool full = (it + 1) * kN <= seq;
      const int live = full ? kN / 16 : live_groups<kN>(it * kN, seq);
      if (st % n == 0) zero<kM, kN>(sc);
      mma_abt_stream_live<kD, kM, kN / 16>(sc, q_s + (n > 1 ? st & 1 : 0) * kOwnTile, row0,
                                          k_s + (st & 1) * kKeyTile, live);  // S += Q_cc·K_ccᵀ
      if (st % n == n - 1) {
        const bf16* vt = v_s + (it & 1) * kKeyTile;
        const float* kbias = kbias_s + (it & 1) * kN;
        float bf[kM][kN / 8][4];
        if (kGated) {
          if (full)
            fetch_bias<kM, kN, true>(bf, bias_row, gd.bs[2], it * kN, seq, gd.vec2);
          else
            fetch_bias<kM, kN, false>(bf, bias_row, gd.bs[2], it * kN, seq, gd.vec2);
        }
        if (!pad_b && full)
          softmax_pv<kD, kM, kN, true, kGated>(sc, vt, kbias, bf, gl, live, c, o, m, l);
        else
          softmax_pv<kD, kM, kN, false, kGated>(sc, vt, kbias, bf, gl, live, c, o, m, l);
      }
    }
    __syncthreads();  // every warp is done with this step's buffers
  }

  if (active) {
    float inv[kM][2];
#pragma unroll
    for (int mm = 0; mm < kM; ++mm)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[mm][i] = quad_sum(l[mm][i]);
        inv[mm][i] = 1.f / l[mm][i];  // a fully padded row: 0 · inf = NaN, as the softmax gives
      }
    stage<kD, kM>(q_s, row0, o, inv);
    if (out_rest) stage<kD, kM, true>(k_s, row0, o, inv);
    if (lse && own == 0 && t == 0) {
#pragma unroll
      for (int mm = 0; mm < kM; ++mm)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qi = q0 + row0 + 16 * mm + g + 8 * i;
          if (qi < seq) lse[((long long)b * heads + h) * seq + qi] = (m[mm][i] + log2f(l[mm][i])) * kLn2;
        }
    }
  }
  __syncthreads();
  const long long o_at = b * s.o[0] + h * s.o[1] + own * cl.width;
  store_tile_any<kD, kOwn, kThreads>(out + o_at, s.o[2], q0, seq, own_cols, cl.narrow, q_s);
  if (out_rest) store_tile_any<kD, kOwn, kThreads>(out_rest + o_at, s.o[2], q0, seq, own_cols, cl.narrow, k_s);
}

template <int kD, int kWarps, int kM, bool kGated>
__global__ void AVEX_LAUNCH_BOUNDS(32 * kWarps)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ out, const bf16* __restrict__ out_rest, const bf16* __restrict__ dout,
          const uint8_t* __restrict__ pad, const float* __restrict__ lse, bf16* __restrict__ dq,
          float* __restrict__ delta, float* __restrict__ dgate, int heads, int seq, int dim, float scale,
          BwdStrides s, Gated gd) {
  using S = Shape<kD, kWarps, kM>;
  using L = Layout<kD>;
  constexpr int kThreads = S::kThreads, kOwn = S::kOwn, kTile = L::kTile;
  static_assert(kThreads == kOwn || kThreads == 2 * kOwn, "one or two threads a row for Δ");
  constexpr int kPerRow = kThreads / kOwn, kRowChunks = L::kChunks / kPerRow;
  static_assert(kRowChunks * kPerRow == L::kChunks, "a row's chunks split evenly for Δ");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                     // [kOwn][kD]
  bf16* do_s = q_s + kOwn * L::kLd;                              // [kOwn][kD]
  bf16* k_s = do_s + kOwn * L::kLd;                              // [2][64][kD]
  bf16* v_s = k_s + 2 * kTile;                                   // [2][64][kD]
  float* kbias_s = reinterpret_cast<float*>(v_s + 2 * kTile);    // [2][64]
  float* delta_s = kbias_s + 2 * kRows;                          // [kOwn]

  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 * kM;
  const bool active = q0 + row0 < seq;
  const bf16* qb = q + b * s.q[0] + h * s.q[1];
  const bf16* kb = k + b * s.k[0] + h * s.k[1];
  const bf16* vb = v + b * s.v[0] + h * s.v[1];
  const bf16* ob = out + b * s.o[0] + h * s.o[1];
  const bf16* dob = dout + b * s.dout[0] + h * s.dout[1];
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
  const long long stat0 = ((long long)b * heads + h) * seq;
  const int n_tiles = (seq + kRows - 1) / kRows;
  const int dc = dim >> 3;
  const float c = scale * kLog2e;

  load_tile<kD, kOwn, kThreads>(q_s, qb, s.q[2], q0, seq, dc);
  load_tile<kD, kOwn, kThreads>(do_s, dob, s.dout[2], q0, seq, dc);
  load_tile<kD, kRows, kThreads>(k_s, kb, s.k[2], 0, seq, dc);
  load_tile<kD, kRows, kThreads>(v_s, vb, s.v[2], 0, seq, dc);
  load_key_bias<kRows, kThreads>(kbias_s, pad_b, s.pad[1], 0, seq);
  cp_async_commit();

  // Δ = rowsum(dO ∘ O) for the block's rows, kPerRow threads a row, while
  // the first tiles arrive; written for the dK/dV kernel. O is the output
  // plus the part its bf16 rounding dropped (when the forward wrote it): an
  // O rounded to bf16 puts an error of 2^-9·|O| into Δ, and where dP − Δ
  // cancels, that error is the whole of dS.
  {
    const int r = threadIdx.x / kPerRow, part = threadIdx.x % kPerRow, qi = q0 + r;
    const long long col = part * 8 * kRowChunks;
    float acc = 0.f;
    if (qi < seq) {
#pragma unroll
      for (int c8 = 0; c8 < kRowChunks; ++c8) {
        if (part * kRowChunks + c8 >= dc) break;  // columns past dim: the next head's, or past the row
        float o8[8], d8[8];
        load8(ob + (long long)qi * s.o[2] + col + c8 * 8, o8);
        load8(dob + (long long)qi * s.dout[2] + col + c8 * 8, d8);
        if (out_rest) {
          float r8[8];
          load8(out_rest + b * s.o[0] + h * s.o[1] + (long long)qi * s.o[2] + col + c8 * 8, r8);
#pragma unroll
          for (int e = 0; e < 8; ++e) o8[e] += r8[e];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(o8[e], d8[e], acc);
      }
    }
    if (kPerRow == 2) acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      delta_s[r] = acc;
      if (qi < seq) delta[stat0 + qi] = acc;
    }
  }
  float lse2[kM][2], dl[kM][2];  // this lane's rows g and g+8 of each group: LSE in log2 units, Δ
#pragma unroll
  for (int mm = 0; mm < kM; ++mm)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + row0 + 16 * mm + g + 8 * i;
      lse2[mm][i] = qi < seq ? lse[stat0 + qi] * kLog2e : INFINITY;
    }
  // The gated variant: this lane's rows' bias and gate·log2e, and its part
  // of dgate = Σ_k bias·dL (the lane's keys; the quad sums them at the end).
  const float* bias_row[kM][2];
  float gl[kM][2], dg[kM][2];
  if (kGated) {
    bias_rows<kM>(gd, h, q0 + row0, seq, bias_row);
    gate_rows<kM>(gd, b, h, q0 + row0, seq, gl);
#pragma unroll
    for (int mm = 0; mm < kM; ++mm) dg[mm][0] = dg[mm][1] = 0.f;
  }

  // Rows of up to 80 hold Q's and dO's A fragments in registers for the
  // whole walk; wider ones (kStreamA) read them from shared memory at each
  // product, which leaves their registers to the wider dQ accumulator.
  constexpr bool kStreamA = kD > 80;
  uint32_t qf[kM][kD / 16][4], dof[kM][kD / 16][4];
  float acc[kM][kD / 8][4];
  zero<kM, kD>(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = buf ^ 1, k0n = (it + 1) * kRows;
      load_tile<kD, kRows, kThreads>(k_s + nxt * kTile, kb, s.k[2], k0n, seq, dc);
      load_tile<kD, kRows, kThreads>(v_s + nxt * kTile, vb, s.v[2], k0n, seq, dc);
      load_key_bias<kRows, kThreads>(kbias_s + nxt * kRows, pad_b, s.pad[1], k0n, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (it == 0) {
        if constexpr (!kStreamA) {
          load_a<kD, kM>(qf, q_s, row0);
          load_a<kD, kM>(dof, do_s, row0);
        }
#pragma unroll
        for (int mm = 0; mm < kM; ++mm)
#pragma unroll
          for (int i = 0; i < 2; ++i) dl[mm][i] = delta_s[row0 + 16 * mm + g + 8 * i];
      }
      const int live = live_groups(it * kRows, seq);
      const float* kbias = kbias_s + buf * kRows;
      const bf16* kt = k_s + buf * kTile;
      float bf[kM][8][4];  // the gated variant's bias fragments, issued before the products
      if (kGated) {
        if ((it + 1) * kRows <= seq)
          fetch_bias<kM, kRows, true>(bf, bias_row, gd.bs[2], it * kRows, seq, gd.vec2);
        else
          fetch_bias<kM, kRows, false>(bf, bias_row, gd.bs[2], it * kRows, seq, gd.vec2);
      }
      float sc[kM][8][4], dp[kM][8][4];
      zero<kM>(sc);
      zero<kM>(dp);
      if constexpr (kStreamA) {
        mma_abt_stream_live<kD, kM, 4>(sc, q_s, row0, kt, live);                  // S = Q·Kᵀ
        mma_abt_stream_live<kD, kM, 4>(dp, do_s, row0, v_s + buf * kTile, live);  // dP = dO·Vᵀ
      } else {
        mma_abt_live<kD, kM, 4>(sc, qf, kt, live);                  // S = Q·Kᵀ
        mma_abt_live<kD, kM, 4>(dp, dof, v_s + buf * kTile, live);  // dP = dO·Vᵀ
      }
#pragma unroll
      for (int mm = 0; mm < kM; ++mm)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float kbv = kbias[8 * j + 2 * t + (e & 1)];
            const float x = kGated ? fmaf(sc[mm][j][e], c, bf[mm][j][e] * gl[mm][i] + kbv)
                                   : fmaf(sc[mm][j][e], c, kbv);
            const float dlv = exp2_approx(x - lse2[mm][i]) * (dp[mm][j][e] - dl[mm][i]);  // dL = P∘(dP − Δ)
            if (kGated) dg[mm][i] = fmaf(bf[mm][j][e], dlv, dg[mm][i]);
            sc[mm][j][e] = dlv * scale;  // dS
          }
      uint32_t dsf[kM][4][4];
      to_a<kM, 4>(dsf, sc);
      mma_ab_live<kD, kM, 4>(acc, dsf, kt, live);                 // dQ += dS·K
    }
    __syncthreads();
  }

  if (active) {
    float ones[kM][2];
#pragma unroll
    for (int mm = 0; mm < kM; ++mm) ones[mm][0] = ones[mm][1] = 1.f;
    stage<kD, kM>(q_s, row0, acc, ones);
    if (kGated && dgate) {
#pragma unroll
      for (int mm = 0; mm < kM; ++mm)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float sum = quad_sum(dg[mm][i]);
          const int qi = q0 + row0 + 16 * mm + g + 8 * i;
          if (t == 0 && qi < seq) dgate[stat0 + qi] = sum;
        }
    }
  }
  __syncthreads();
  store_tile<kD, kOwn, kThreads>(dq + b * s.dq[0] + h * s.dq[1], s.dq[2], q0, seq, dc, q_s);
}

// Σ dO·(O + rest) over the columns part·8 + {0..7} + 8·per·i below dim of one
// row (rest may be null): 16-byte loads unless narrow, else element by element.
__device__ __forceinline__ float row_delta(const bf16* o, const bf16* rest, const bf16* d, int dim, bool narrow,
                                           int part, int per) {
  float acc = 0.f;
  for (int c0 = part * 8; c0 < dim; c0 += per * 8) {
    if (!narrow) {
      float o8[8], d8[8];
      load8(o + c0, o8);
      load8(d + c0, d8);
      if (rest) {
        float r8[8];
        load8(rest + c0, r8);
#pragma unroll
        for (int e = 0; e < 8; ++e) o8[e] += r8[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(o8[e], d8[e], acc);
    } else {
      for (int e = 0; e < 8 && c0 + e < dim; ++e) {
        const float oe = __bfloat162float(o[c0 + e]) + (rest ? __bfloat162float(rest[c0 + e]) : 0.f);
        acc = fmaf(oe, __bfloat162float(d[c0 + e]), acc);
      }
    }
  }
  return acc;
}

// The dQ kernel at any head width: one block per (query tile, head and
// column chunk, item) owns dQ_c. Δ = rowsum(dO ∘ O) over the whole width;
// then, key tile by key tile, the chunks in turn (its own last): S += Q_cc·
// K_ccᵀ and dP += dO_cc·V_ccᵀ, and at the tile's last step dS and dQ_c +=
// dS·K_c. Chunk 0 writes Δ and dgate.
template <int kD, int kWarps, int kM, bool kGated>
__global__ void AVEX_LAUNCH_BOUNDS(32 * kWarps)
dq_any_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ out, const bf16* __restrict__ out_rest, const bf16* __restrict__ dout,
              const uint8_t* __restrict__ pad, const float* __restrict__ lse, bf16* __restrict__ dq,
              float* __restrict__ delta, float* __restrict__ dgate, int heads, int seq, float scale, BwdStrides s,
              Gated gd, Cols cl) {
  using S = Shape<kD, kWarps, kM>;
  using L = Layout<kD>;
  constexpr int kThreads = S::kThreads, kOwn = S::kOwn, kTile = L::kTile, kOwnTile = kOwn * L::kLd;
  static_assert(kThreads == kOwn || kThreads == 2 * kOwn, "one or two threads a row for Δ");
  constexpr int kPerRow = kThreads / kOwn;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                     // [2][kOwn][kD]
  bf16* do_s = q_s + 2 * kOwnTile;                               // [2][kOwn][kD]
  bf16* k_s = do_s + 2 * kOwnTile;                               // [2][64][kD]
  bf16* v_s = k_s + 2 * kTile;                                   // [2][64][kD]
  float* kbias_s = reinterpret_cast<float*>(v_s + 2 * kTile);    // [2][64]
  float* delta_s = kbias_s + 2 * kRows;                          // [kOwn]

  const int n = cl.chunks, own = blockIdx.y % n, h = blockIdx.y / n, b = blockIdx.z;
  const int q0 = blockIdx.x * kOwn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 * kM;
  const bool active = q0 + row0 < seq;
  const bf16* qb = q + b * s.q[0] + h * s.q[1];
  const bf16* kb = k + b * s.k[0] + h * s.k[1];
  const bf16* vb = v + b * s.v[0] + h * s.v[1];
  const bf16* dob = dout + b * s.dout[0] + h * s.dout[1];
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
  const long long stat0 = ((long long)b * heads + h) * seq;
  const int n_tiles = (seq + kRows - 1) / kRows, steps = n_tiles * n;
  const float c = scale * kLog2e;

  auto issue = [&](int st) {
    const int it = st / n, cc = step_chunk(st, own, n), col = cc * cl.width, cols = chunk_cols(cl, cc);
    const int slot = st & 1;
    if (n > 1 || st == 0) {
      load_tile_any<kD, kOwn, kThreads>(q_s + slot * kOwnTile, qb + col, s.q[2], q0, seq, cols, cl.narrow);
      load_tile_any<kD, kOwn, kThreads>(do_s + slot * kOwnTile, dob + col, s.dout[2], q0, seq, cols, cl.narrow);
    }
    load_tile_any<kD, kRows, kThreads>(k_s + slot * kTile, kb + col, s.k[2], it * kRows, seq, cols, cl.narrow);
    load_tile_any<kD, kRows, kThreads>(v_s + slot * kTile, vb + col, s.v[2], it * kRows, seq, cols, cl.narrow);
    if (st % n == 0) load_key_bias<kRows, kThreads>(kbias_s + (it & 1) * kRows, pad_b, s.pad[1], it * kRows, seq);
  };
  issue(0);
  cp_async_commit();

  {  // Δ over the whole width, kPerRow threads a row
    const int r = threadIdx.x / kPerRow, part = threadIdx.x % kPerRow, qi = q0 + r;
    float acc = 0.f;
    if (qi < seq) {
      const long long at = b * s.o[0] + h * s.o[1] + (long long)qi * s.o[2];
      acc = row_delta(out + at, out_rest ? out_rest + at : nullptr, dob + (long long)qi * s.dout[2], cl.dim,
                      cl.narrow, part, kPerRow);
    }
    if (kPerRow == 2) acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      delta_s[r] = acc;
      if (qi < seq && own == 0) delta[stat0 + qi] = acc;
    }
  }
  float lse2[kM][2], dl[kM][2];
#pragma unroll
  for (int mm = 0; mm < kM; ++mm)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + row0 + 16 * mm + g + 8 * i;
      lse2[mm][i] = qi < seq ? lse[stat0 + qi] * kLog2e : INFINITY;
    }
  const float* bias_row[kM][2];
  float gl[kM][2], dg[kM][2];
  if (kGated) {
    bias_rows<kM>(gd, h, q0 + row0, seq, bias_row);
    gate_rows<kM>(gd, b, h, q0 + row0, seq, gl);
#pragma unroll
    for (int mm = 0; mm < kM; ++mm) dg[mm][0] = dg[mm][1] = 0.f;
  }

  float acc[kM][kD / 8][4], sc[kM][8][4], dp[kM][8][4];
  zero<kM, kD>(acc);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      issue(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int it = st / n, slot = st & 1, own_slot = n > 1 ? slot : 0;
      if (st == 0) {
#pragma unroll
        for (int mm = 0; mm < kM; ++mm)
#pragma unroll
          for (int i = 0; i < 2; ++i) dl[mm][i] = delta_s[row0 + 16 * mm + g + 8 * i];
      }
      if (st % n == 0) {
        zero<kM>(sc);
        zero<kM>(dp);
      }
      const int live = live_groups(it * kRows, seq);
      const bf16* kt = k_s + slot * kTile;
      mma_abt_stream_live<kD, kM, 4>(sc, q_s + own_slot * kOwnTile, row0, kt, live);               // S += Q·Kᵀ
      mma_abt_stream_live<kD, kM, 4>(dp, do_s + own_slot * kOwnTile, row0, v_s + slot * kTile, live);  // dP += dO·Vᵀ
      if (st % n == n - 1) {
        const float* kbias = kbias_s + (it & 1) * kRows;
        float bf[kM][8][4];
        if (kGated) {
          if ((it + 1) * kRows <= seq)
            fetch_bias<kM, kRows, true>(bf, bias_row, gd.bs[2], it * kRows, seq, gd.vec2);
          else
            fetch_bias<kM, kRows, false>(bf, bias_row, gd.bs[2], it * kRows, seq, gd.vec2);
        }
#pragma unroll
        for (int mm = 0; mm < kM; ++mm)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              const float kbv = kbias[8 * j + 2 * t + (e & 1)];
              const float x = kGated ? fmaf(sc[mm][j][e], c, bf[mm][j][e] * gl[mm][i] + kbv)
                                     : fmaf(sc[mm][j][e], c, kbv);
              const float dlv = exp2_approx(x - lse2[mm][i]) * (dp[mm][j][e] - dl[mm][i]);  // dL = P∘(dP − Δ)
              if (kGated) dg[mm][i] = fmaf(bf[mm][j][e], dlv, dg[mm][i]);
              sc[mm][j][e] = dlv * scale;  // dS
            }
        uint32_t dsf[kM][4][4];
        to_a<kM, 4>(dsf, sc);
        mma_ab_live<kD, kM, 4>(acc, dsf, kt, live);  // dQ_c += dS·K_c: the last step's chunk is the block's own
      }
    }
    __syncthreads();
  }

  if (active) {
    float ones[kM][2];
#pragma unroll
    for (int mm = 0; mm < kM; ++mm) ones[mm][0] = ones[mm][1] = 1.f;
    stage<kD, kM>(q_s, row0, acc, ones);
    if (kGated && dgate) {
#pragma unroll
      for (int mm = 0; mm < kM; ++mm)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float sum = quad_sum(dg[mm][i]);
          const int qi = q0 + row0 + 16 * mm + g + 8 * i;
          if (t == 0 && qi < seq && own == 0) dgate[stat0 + qi] = sum;
        }
    }
  }
  __syncthreads();
  store_tile_any<kD, kOwn, kThreads>(dq + b * s.dq[0] + h * s.dq[1] + own * cl.width, s.dq[2], q0, seq,
                                     chunk_cols(cl, own), cl.narrow, q_s);
}

template <int kD, int kWarps, int kM, bool kGated>
__global__ void AVEX_LAUNCH_BOUNDS(32 * kWarps)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const uint8_t* __restrict__ pad, const float* __restrict__ lse,
           const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
           int seq, int dim, float scale, BwdStrides s, Gated gd) {
  using S = Shape<kD, kWarps, kM>;
  using L = Layout<kD>;
  constexpr int kThreads = S::kThreads, kOwn = S::kOwn, kTile = L::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                     // [kOwn][kD]
  bf16* v_s = k_s + kOwn * L::kLd;                               // [kOwn][kD]
  bf16* q_s = v_s + kOwn * L::kLd;                               // [2][64][kD]
  bf16* do_s = q_s + 2 * kTile;                                  // [2][64][kD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile);     // [2][64], log2 units
  float* dl_s = lse_s + 2 * kRows;                               // [2][64]
  float* gl_s = dl_s + 2 * kRows;                                // [2][64], the gated variant's gate·log2e

  const int k0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 * kM;
  const bool active = k0 + row0 < seq;  // the warp has a key below seq
  const bf16* qb = q + b * s.q[0] + h * s.q[1];
  const bf16* dob = dout + b * s.dout[0] + h * s.dout[1];
  const long long stat0 = ((long long)b * heads + h) * seq;
  const int n_tiles = (seq + kRows - 1) / kRows;
  const int dc = dim >> 3;
  const float c = scale * kLog2e;
  // Rows of up to 80 load K's and V's A fragments into registers for their
  // product; wider ones (kStreamA) read them one k-step at a time, which
  // leaves the registers to the dK and dV accumulators (16 rows x kD each).
  constexpr bool kStreamA = kD > 80;

  // The query statistics of queries q0 .. q0+63: past seq, an LSE of +inf
  // gives P = 0 and a Δ of 0 gives dS = 0.
  auto load_stats = [&](int slot, int q0) {
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      const int qi = q0 + i;
      lse_s[slot * kRows + i] = qi < seq ? lse[stat0 + qi] * kLog2e : INFINITY;
      dl_s[slot * kRows + i] = qi < seq ? delta[stat0 + qi] : 0.f;
      if (kGated) gl_s[slot * kRows + i] = gate_at(gd, b, h, min(qi, seq - 1)) * kLog2e;
    }
  };

  load_tile<kD, kOwn, kThreads>(k_s, k + b * s.k[0] + h * s.k[1], s.k[2], k0, seq, dc);
  load_tile<kD, kOwn, kThreads>(v_s, v + b * s.v[0] + h * s.v[1], s.v[2], k0, seq, dc);
  load_tile<kD, kRows, kThreads>(q_s, qb, s.q[2], 0, seq, dc);
  load_tile<kD, kRows, kThreads>(do_s, dob, s.dout[2], 0, seq, dc);
  load_stats(0, 0);
  cp_async_commit();

  float kbias[kM][2];  // this lane's keys g and g+8 of each group
  const float* bias_col[kM][2];  // the gated variant: their bias columns (keys past seq clamped)
#pragma unroll
  for (int mm = 0; mm < kM; ++mm)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + row0 + 16 * mm + g + 8 * i;
      kbias[mm][i] = (key >= seq || (pad && pad[b * s.pad[0] + key * s.pad[1]])) ? -INFINITY : 0.f;
      if (kGated) bias_col[mm][i] = gd.bias + h * gd.bs[0] + min(key, seq - 1) * gd.bs[2];
    }

  float dk_acc[kM][kD / 8][4], dv_acc[kM][kD / 8][4];
  zero<kM, kD>(dk_acc);
  zero<kM, kD>(dv_acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = buf ^ 1, q0n = (it + 1) * kRows;
      load_tile<kD, kRows, kThreads>(q_s + nxt * kTile, qb, s.q[2], q0n, seq, dc);
      load_tile<kD, kRows, kThreads>(do_s + nxt * kTile, dob, s.dout[2], q0n, seq, dc);
      load_stats(nxt, q0n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int live = live_groups(it * kRows, seq);
      const bf16* qt = q_s + buf * kTile;
      const bf16* dot = do_s + buf * kTile;
      const float* lq = lse_s + buf * kRows;
      const float* dlq = dl_s + buf * kRows;
      const float* glq = gl_s + buf * kRows;
      // The gated variant's bias, transposed: bt[m][j][2i + e] = bias[query
      // 8j + 2t + e][key g + 8i of group m], scalars from L2 issued before the
      // product (queries past seq clamped to the last).
      float bt[kM][8][4];
      if (kGated) {
#pragma unroll
        for (int mm = 0; mm < kM; ++mm)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const long long qo = min(it * kRows + 8 * j + 2 * t + e, seq - 1) * gd.bs[1];
              bt[mm][j][e] = __ldg(bias_col[mm][0] + qo);
              bt[mm][j][2 + e] = __ldg(bias_col[mm][1] + qo);
            }
      }
      float st[kM][8][4];
      zero<kM>(st);
      if constexpr (kStreamA) {
        mma_abt_stream_live<kD, kM, 4>(st, k_s, row0, qt, live);  // Sᵀ = K·Qᵀ
      } else {
        uint32_t kf[kM][kD / 16][4];
        load_a<kD, kM>(kf, k_s, row0);
        mma_abt_live<kD, kM, 4>(st, kf, qt, live);      // Sᵀ = K·Qᵀ
      }
#pragma unroll
      for (int mm = 0; mm < kM; ++mm)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const float x = kGated ? fmaf(st[mm][j][e], c, bt[mm][j][e] * glq[col] + kbias[mm][e >> 1])
                                   : fmaf(st[mm][j][e], c, kbias[mm][e >> 1]);
            st[mm][j][e] = exp2_approx(x - lq[col]);  // Pᵀ
          }
      {
        uint32_t pf[kM][4][4];
        to_a<kM, 4>(pf, st);
        mma_ab_live<kD, kM, 4>(dv_acc, pf, dot, live);  // dV += Pᵀ·dO
      }
      float dpt[kM][8][4];
      zero<kM>(dpt);
      if constexpr (kStreamA) {
        mma_abt_stream_live<kD, kM, 4>(dpt, v_s, row0, dot, live);  // dPᵀ = V·dOᵀ
      } else {
        uint32_t vf[kM][kD / 16][4];
        load_a<kD, kM>(vf, v_s, row0);
        mma_abt_live<kD, kM, 4>(dpt, vf, dot, live);    // dPᵀ = V·dOᵀ
      }
#pragma unroll
      for (int mm = 0; mm < kM; ++mm)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[mm][j][e] = st[mm][j][e] * (dpt[mm][j][e] - dlq[8 * j + 2 * t + (e & 1)]) * scale;  // dSᵀ
      {
        uint32_t dsf[kM][4][4];
        to_a<kM, 4>(dsf, st);
        mma_ab_live<kD, kM, 4>(dk_acc, dsf, qt, live);  // dK += dSᵀ·Q
      }
    }
    __syncthreads();
  }

  if (active) {
    float ones[kM][2];
#pragma unroll
    for (int mm = 0; mm < kM; ++mm) ones[mm][0] = ones[mm][1] = 1.f;
    stage<kD, kM>(k_s, row0, dk_acc, ones);
    stage<kD, kM>(v_s, row0, dv_acc, ones);
  }
  __syncthreads();
  store_tile<kD, kOwn, kThreads>(dk + b * s.dk[0] + h * s.dk[1], s.dk[2], k0, seq, dc, k_s);
  store_tile<kD, kOwn, kThreads>(dv + b * s.dv[0] + h * s.dv[1], s.dv[2], k0, seq, dc, v_s);
}

// The dK/dV kernel at any head width, in two launches (kDk: the dK one;
// else the dV one), each at about half the registers of dkv_kernel, whose
// four accumulators together pass 255 registers once the chunks' sums are
// carried across steps: one block per (key tile, head and column chunk,
// item) owns dK_c or dV_c. Query tile by query tile, the chunks in turn
// (its own last): Sᵀ += K_cc·Q_ccᵀ (and, for dK, dPᵀ += V_cc·dO_ccᵀ); at the
// tile's last step Pᵀ, then dV_c += Pᵀ·dO_c, or dSᵀ and dK_c += dSᵀ·Q_c. The
// gated variant reads each bias value from L2 where it is used.
template <int kD, int kWarps, int kM, bool kGated, bool kDk>
__global__ void __launch_bounds__(32 * kWarps, 1)  // at 64 too: the thread count alone held it below its need
dkv_any_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ dout, const uint8_t* __restrict__ pad, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int seq,
               float scale, BwdStrides s, Gated gd, Cols cl) {
  using S = Shape<kD, kWarps, kM>;
  using L = Layout<kD>;
  constexpr int kThreads = S::kThreads, kOwn = S::kOwn, kTile = L::kTile, kOwnTile = kOwn * L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                     // [2][kOwn][kD]
  bf16* v_s = k_s + 2 * kOwnTile;                                // [2][kOwn][kD] (dK)
  bf16* q_s = v_s + 2 * kOwnTile;                                // [2][64][kD]
  bf16* do_s = q_s + 2 * kTile;                                  // [2][64][kD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile);     // [2][64], log2 units
  float* dl_s = lse_s + 2 * kRows;                               // [2][64] (dK)
  float* gl_s = dl_s + 2 * kRows;                                // [2][64]

  const int n = cl.chunks, own = blockIdx.y % n, h = blockIdx.y / n, b = blockIdx.z;
  const int k0 = blockIdx.x * kOwn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 * kM;
  const bool active = k0 + row0 < seq;
  const bf16* qb = q + b * s.q[0] + h * s.q[1];
  const bf16* kb = k + b * s.k[0] + h * s.k[1];
  const bf16* vb = v + b * s.v[0] + h * s.v[1];
  const bf16* dob = dout + b * s.dout[0] + h * s.dout[1];
  const long long stat0 = ((long long)b * heads + h) * seq;
  const int n_tiles = (seq + kRows - 1) / kRows, steps = n_tiles * n;
  const float c = scale * kLog2e;

  auto issue = [&](int st) {
    const int it = st / n, cc = step_chunk(st, own, n), col = cc * cl.width, cols = chunk_cols(cl, cc);
    const int slot = st & 1;
    if (n > 1 || st == 0) {
      load_tile_any<kD, kOwn, kThreads>(k_s + slot * kOwnTile, kb + col, s.k[2], k0, seq, cols, cl.narrow);
      if (kDk) load_tile_any<kD, kOwn, kThreads>(v_s + slot * kOwnTile, vb + col, s.v[2], k0, seq, cols, cl.narrow);
    }
    load_tile_any<kD, kRows, kThreads>(q_s + slot * kTile, qb + col, s.q[2], it * kRows, seq, cols, cl.narrow);
    if (kDk || cc == own)  // the dV launch reads dO's own chunk alone
      load_tile_any<kD, kRows, kThreads>(do_s + slot * kTile, dob + col, s.dout[2], it * kRows, seq, cols,
                                         cl.narrow);
    if (st % n == 0) {  // the query tile's statistics: past seq an LSE of +inf (P = 0) and a Δ of 0
      const int sl = (it & 1) * kRows;
      for (int i = threadIdx.x; i < kRows; i += kThreads) {
        const int qi = it * kRows + i;
        lse_s[sl + i] = qi < seq ? lse[stat0 + qi] * kLog2e : INFINITY;
        if (kDk) dl_s[sl + i] = qi < seq ? delta[stat0 + qi] : 0.f;
        if (kGated) gl_s[sl + i] = gate_at(gd, b, h, min(qi, seq - 1)) * kLog2e;
      }
    }
  };
  issue(0);
  cp_async_commit();

  float kbias[kM][2];
  const float* bias_col[kM][2];
#pragma unroll
  for (int mm = 0; mm < kM; ++mm)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + row0 + 16 * mm + g + 8 * i;
      kbias[mm][i] = (key >= seq || (pad && pad[b * s.pad[0] + key * s.pad[1]])) ? -INFINITY : 0.f;
      if (kGated) bias_col[mm][i] = gd.bias + h * gd.bs[0] + min(key, seq - 1) * gd.bs[2];
    }

  float acc[kM][kD / 8][4], st_[kM][8][4], dpt[kM][8][4];  // acc: dK_c or dV_c
  zero<kM, kD>(acc);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      issue(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int it = st / n, slot = st & 1, own_slot = n > 1 ? slot : 0;
      const int live = live_groups(it * kRows, seq);
      const bf16* qt = q_s + slot * kTile;
      const bf16* dot = do_s + slot * kTile;
      if (st % n == 0) {
        zero<kM>(st_);
        if (kDk) zero<kM>(dpt);
      }
      mma_abt_stream_live<kD, kM, 4>(st_, k_s + own_slot * kOwnTile, row0, qt, live);  // Sᵀ += K·Qᵀ
      if (kDk) mma_abt_stream_live<kD, kM, 4>(dpt, v_s + own_slot * kOwnTile, row0, dot, live);  // dPᵀ += V·dOᵀ
      if (st % n == n - 1) {
        const float* lq = lse_s + (it & 1) * kRows;
        const float* dlq = dl_s + (it & 1) * kRows;
        const float* glq = gl_s + (it & 1) * kRows;
#pragma unroll
        for (int mm = 0; mm < kM; ++mm)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1);
              float x;
              if (kGated) {
                const float bv = __ldg(bias_col[mm][e >> 1] + min(it * kRows + col, seq - 1) * gd.bs[1]);
                x = fmaf(st_[mm][j][e], c, bv * glq[col] + kbias[mm][e >> 1]);
              } else {
                x = fmaf(st_[mm][j][e], c, kbias[mm][e >> 1]);
              }
              const float p = exp2_approx(x - lq[col]);  // Pᵀ
              st_[mm][j][e] = kDk ? p * (dpt[mm][j][e] - dlq[col]) * scale : p;  // dSᵀ for dK
            }
        uint32_t af[kM][4][4];
        to_a<kM, 4>(af, st_);
        mma_ab_live<kD, kM, 4>(acc, af, kDk ? qt : dot, live);  // dK_c += dSᵀ·Q_c, or dV_c += Pᵀ·dO_c
      }
    }
    __syncthreads();
  }

  if (active) {
    float ones[kM][2];
#pragma unroll
    for (int mm = 0; mm < kM; ++mm) ones[mm][0] = ones[mm][1] = 1.f;
    stage<kD, kM>(k_s, row0, acc, ones);
  }
  __syncthreads();
  bf16* dst = kDk ? dk + b * s.dk[0] + h * s.dk[1] + own * cl.width : dv + b * s.dv[0] + h * s.dv[1] + own * cl.width;
  store_tile_any<kD, kOwn, kThreads>(dst, kDk ? s.dk[2] : s.dv[2], k0, seq, chunk_cols(cl, own), cl.narrow, k_s);
}

// Σ_b gate[b,h,:,None] ⊙ dL[b,h] over one tile of kOwn queries x 64 keys and
// one chunk of `items` batch items (blockIdx.z = chunk · heads + h): the block
// walks its items in order with the next item's q, dO, K and V tiles in
// flight, rebuilds S and dP, P from the saved LSE and dL with the Δ the dQ
// kernel wrote, keeps the sum in registers and writes it to out[chunk].
template <int kD, int kWarps, int kM>
__global__ void AVEX_LAUNCH_BOUNDS(32 * kWarps)
dbias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const uint8_t* __restrict__ pad, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ out, int batch, int items, int heads, int seq,
             int dim, float scale, BwdStrides s, Gated gd) {
  using S = Shape<kD, kWarps, kM>;
  constexpr int kThreads = S::kThreads, kOwn = S::kOwn, kTile = Layout<kD>::kTile;
  constexpr int kOwnTile = kOwn * Layout<kD>::kLd;
  // As the dQ kernel: wider rows than 80 read their A fragments from shared
  // memory at each product instead of holding them in registers.
  constexpr bool kStreamA = kD > 80;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                     // [2][kOwn][kD]
  bf16* do_s = q_s + 2 * kOwnTile;                               // [2][kOwn][kD]
  bf16* k_s = do_s + 2 * kOwnTile;                               // [2][64][kD]
  bf16* v_s = k_s + 2 * kTile;                                   // [2][64][kD]
  float* kbias_s = reinterpret_cast<float*>(v_s + 2 * kTile);    // [2][64]
  float* lse_s = kbias_s + 2 * kRows;                            // [2][kOwn], log2 units
  float* dl_s = lse_s + 2 * kOwn;                                // [2][kOwn]
  float* g_s = dl_s + 2 * kOwn;                                  // [2][kOwn]

  const int q0 = blockIdx.x * kOwn, k0 = blockIdx.y * kRows, h = blockIdx.z % heads, chunk = blockIdx.z / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 * kM;
  const bool active = q0 + row0 < seq;
  const int live = live_groups(k0, seq);
  const int b0 = chunk * items, b_end = min(batch, b0 + items);
  const int dc = dim >> 3;
  const float c = scale * kLog2e;

  // Item b's tiles and row statistics into slot `slot`; rows past seq get an
  // LSE of +inf (P = 0) and a Δ of 0.
  auto issue = [&](int slot, int b) {
    load_tile<kD, kOwn, kThreads>(q_s + slot * kOwnTile, q + b * s.q[0] + h * s.q[1], s.q[2], q0, seq, dc);
    load_tile<kD, kOwn, kThreads>(do_s + slot * kOwnTile, dout + b * s.dout[0] + h * s.dout[1], s.dout[2], q0,
                                  seq, dc);
    load_tile<kD, kRows, kThreads>(k_s + slot * kTile, k + b * s.k[0] + h * s.k[1], s.k[2], k0, seq, dc);
    load_tile<kD, kRows, kThreads>(v_s + slot * kTile, v + b * s.v[0] + h * s.v[1], s.v[2], k0, seq, dc);
    load_key_bias<kRows, kThreads>(kbias_s + slot * kRows, pad ? pad + b * s.pad[0] : nullptr, s.pad[1], k0, seq);
    const long long stat0 = ((long long)b * heads + h) * seq;
    for (int i = threadIdx.x; i < kOwn; i += kThreads) {
      const int qi = q0 + i;
      lse_s[slot * kOwn + i] = qi < seq ? lse[stat0 + qi] * kLog2e : INFINITY;
      dl_s[slot * kOwn + i] = qi < seq ? delta[stat0 + qi] : 0.f;
      g_s[slot * kOwn + i] = gate_at(gd, b, h, min(qi, seq - 1));
    }
  };

  issue(0, b0);
  cp_async_commit();
  // The tile's bias fragments, the same for every item.
  const float* bias_row[kM][2];
  float bf[kM][8][4];
  bias_rows<kM>(gd, h, q0 + row0, seq, bias_row);
  if (k0 + kRows <= seq)
    fetch_bias<kM, kRows, true>(bf, bias_row, gd.bs[2], k0, seq, gd.vec2);
  else
    fetch_bias<kM, kRows, false>(bf, bias_row, gd.bs[2], k0, seq, gd.vec2);

  float acc[kM][8][4];
  zero<kM>(acc);
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
      float sc[kM][8][4], dp[kM][8][4];
      zero<kM>(sc);
      zero<kM>(dp);
      if constexpr (kStreamA) {
        mma_abt_stream_live<kD, kM, 4>(sc, q_s + buf * kOwnTile, row0, k_s + buf * kTile, live);   // S = Q·Kᵀ
        mma_abt_stream_live<kD, kM, 4>(dp, do_s + buf * kOwnTile, row0, v_s + buf * kTile, live);  // dP = dO·Vᵀ
      } else {
        uint32_t qf[kM][kD / 16][4], dof[kM][kD / 16][4];
        load_a<kD, kM>(qf, q_s + buf * kOwnTile, row0);
        load_a<kD, kM>(dof, do_s + buf * kOwnTile, row0);
        mma_abt_live<kD, kM, 4>(sc, qf, k_s + buf * kTile, live);   // S = Q·Kᵀ
        mma_abt_live<kD, kM, 4>(dp, dof, v_s + buf * kTile, live);  // dP = dO·Vᵀ
      }
      const float* kbias = kbias_s + buf * kRows;
#pragma unroll
      for (int mm = 0; mm < kM; ++mm) {
        float lse2[2], dlt[2], gv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = buf * kOwn + row0 + 16 * mm + g + 8 * i;
          lse2[i] = lse_s[r];
          dlt[i] = dl_s[r];
          gv[i] = g_s[r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float x = fmaf(sc[mm][j][e], c, bf[mm][j][e] * (gv[i] * kLog2e) + kbias[8 * j + 2 * t + (e & 1)]);
            const float dlv = exp2_approx(x - lse2[i]) * (dp[mm][j][e] - dlt[i]);  // dL
            acc[mm][j][e] = fmaf(gv[i], dlv, acc[mm][j][e]);
          }
      }
    }
    __syncthreads();  // every warp is done with this item's buffers
  }

  if (active) {
    float* base = out + ((long long)chunk * heads + h) * seq * seq;
#pragma unroll
    for (int mm = 0; mm < kM; ++mm)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + row0 + 16 * mm + g + 8 * i;
        if (qi >= seq) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e;
            if (key < seq) base[(long long)qi * seq + key] = acc[mm][j][2 * i + e];
          }
      }
  }
}

// dbias_kernel at any head width: for each item the column chunks in turn,
// S += Q_cc·K_ccᵀ and dP += dO_cc·V_ccᵀ, then gate ⊙ dL into the tile's sum.
// It has no chunk axis: dbias sums over the whole width once.
template <int kD, int kWarps, int kM>
__global__ void AVEX_LAUNCH_BOUNDS(32 * kWarps)
dbias_any_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const bf16* __restrict__ dout, const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ out, int batch, int items, int heads, int seq,
                 float scale, BwdStrides s, Gated gd, Cols cl) {
  using S = Shape<kD, kWarps, kM>;
  constexpr int kThreads = S::kThreads, kOwn = S::kOwn, kTile = Layout<kD>::kTile;
  constexpr int kOwnTile = kOwn * Layout<kD>::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                     // [2][kOwn][kD]
  bf16* do_s = q_s + 2 * kOwnTile;                               // [2][kOwn][kD]
  bf16* k_s = do_s + 2 * kOwnTile;                               // [2][64][kD]
  bf16* v_s = k_s + 2 * kTile;                                   // [2][64][kD]
  float* kbias_s = reinterpret_cast<float*>(v_s + 2 * kTile);    // [2][64]
  float* lse_s = kbias_s + 2 * kRows;                            // [2][kOwn], log2 units
  float* dl_s = lse_s + 2 * kOwn;                                // [2][kOwn]
  float* g_s = dl_s + 2 * kOwn;                                  // [2][kOwn]

  const int q0 = blockIdx.x * kOwn, k0 = blockIdx.y * kRows, h = blockIdx.z % heads, chunk = blockIdx.z / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 * kM;
  const bool active = q0 + row0 < seq;
  const int live = live_groups(k0, seq);
  const int n = cl.chunks, b0 = chunk * items, steps = (min(batch, b0 + items) - b0) * n;
  const float c = scale * kLog2e;

  // Step st: item b0 + st / n, column chunk st % n; the item's key bias and
  // row statistics with its first chunk.
  auto issue = [&](int st) {
    const int b = b0 + st / n, cc = st % n, slot = st & 1, col = cc * cl.width, cols = chunk_cols(cl, cc);
    load_tile_any<kD, kOwn, kThreads>(q_s + slot * kOwnTile, q + b * s.q[0] + h * s.q[1] + col, s.q[2], q0, seq,
                                      cols, cl.narrow);
    load_tile_any<kD, kOwn, kThreads>(do_s + slot * kOwnTile, dout + b * s.dout[0] + h * s.dout[1] + col, s.dout[2],
                                      q0, seq, cols, cl.narrow);
    load_tile_any<kD, kRows, kThreads>(k_s + slot * kTile, k + b * s.k[0] + h * s.k[1] + col, s.k[2], k0, seq, cols,
                                       cl.narrow);
    load_tile_any<kD, kRows, kThreads>(v_s + slot * kTile, v + b * s.v[0] + h * s.v[1] + col, s.v[2], k0, seq, cols,
                                       cl.narrow);
    if (cc == 0) {
      const int is = (st / n) & 1;
      load_key_bias<kRows, kThreads>(kbias_s + is * kRows, pad ? pad + b * s.pad[0] : nullptr, s.pad[1], k0, seq);
      const long long stat0 = ((long long)b * heads + h) * seq;
      for (int i = threadIdx.x; i < kOwn; i += kThreads) {
        const int qi = q0 + i;
        lse_s[is * kOwn + i] = qi < seq ? lse[stat0 + qi] * kLog2e : INFINITY;
        dl_s[is * kOwn + i] = qi < seq ? delta[stat0 + qi] : 0.f;
        g_s[is * kOwn + i] = gate_at(gd, b, h, min(qi, seq - 1));
      }
    }
  };
  issue(0);
  cp_async_commit();
  const float* bias_row[kM][2];
  float bf[kM][8][4];
  bias_rows<kM>(gd, h, q0 + row0, seq, bias_row);
  if (k0 + kRows <= seq)
    fetch_bias<kM, kRows, true>(bf, bias_row, gd.bs[2], k0, seq, gd.vec2);
  else
    fetch_bias<kM, kRows, false>(bf, bias_row, gd.bs[2], k0, seq, gd.vec2);

  float acc[kM][8][4], sc[kM][8][4], dp[kM][8][4];
  zero<kM>(acc);
  for (int st = 0; st < steps; ++st) {
    const int slot = st & 1;
    if (st + 1 < steps) {
      issue(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (st % n == 0) {
        zero<kM>(sc);
        zero<kM>(dp);
      }
      mma_abt_stream_live<kD, kM, 4>(sc, q_s + slot * kOwnTile, row0, k_s + slot * kTile, live);   // S += Q·Kᵀ
      mma_abt_stream_live<kD, kM, 4>(dp, do_s + slot * kOwnTile, row0, v_s + slot * kTile, live);  // dP += dO·Vᵀ
      if (st % n == n - 1) {
        const int is = (st / n) & 1;
        const float* kbias = kbias_s + is * kRows;
#pragma unroll
        for (int mm = 0; mm < kM; ++mm) {
          float lse2[2], dlt[2], gv[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = is * kOwn + row0 + 16 * mm + g + 8 * i;
            lse2[i] = lse_s[r];
            dlt[i] = dl_s[r];
            gv[i] = g_s[r];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              const float x = fmaf(sc[mm][j][e], c, bf[mm][j][e] * (gv[i] * kLog2e) + kbias[8 * j + 2 * t + (e & 1)]);
              const float dlv = exp2_approx(x - lse2[i]) * (dp[mm][j][e] - dlt[i]);  // dL
              acc[mm][j][e] = fmaf(gv[i], dlv, acc[mm][j][e]);
            }
        }
      }
    }
    __syncthreads();  // every warp is done with this step's buffers
  }

  if (active) {
    float* base = out + ((long long)chunk * heads + h) * seq * seq;
#pragma unroll
    for (int mm = 0; mm < kM; ++mm)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + row0 + 16 * mm + g + 8 * i;
        if (qi >= seq) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e;
            if (key < seq) base[(long long)qi * seq + key] = acc[mm][j][2 * i + e];
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
// library a width). A call whose head width D is a multiple of 8 up to kD
// with 16-byte aligned rows runs on the kernels above: columns D .. kD-1 are
// zero-filled on load and never stored, which adds 0 to every q·k, Δ and
// product, so the result is exact. Any other call runs on the general
// kernels (forward_any_kernel, dq_any_kernel, dkv_any_kernel,
// dbias_any_kernel): D cut into column chunks of at most kD, narrow rows
// read and written element by element.
constexpr int kHeadDim = AVEX_HEAD_DIM;
static_assert(kHeadDim == 32 || kHeadDim == 64 || kHeadDim == 80 || kHeadDim == 96 || kHeadDim == 128,
              "AVEX_HEAD_DIM: 32, 64, 80, 96 or 128");

bool bad_shape(int batch, int heads, int seq) {
  return seq <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535;
}

// The columns of a call of head width head_dim in chunks of chunk_width
// (the wrapper's plan), or a Cols with chunks = 0 when this build does not
// take them: a chunk wider than the build; more than one chunk of a width
// that is not a multiple of 8 (chunks start 16-byte aligned); a wide (not
// narrow) call whose widths are not multiples of 8; more head chunks than a
// grid axis holds.
Cols plan_cols(int head_dim, int chunk_width, int narrow, int heads) {
  Cols cl;
  cl.chunks = 0;
  if (head_dim <= 0 || chunk_width <= 0 || chunk_width > kHeadDim) return cl;
  const int chunks = (head_dim + chunk_width - 1) / chunk_width;
  if ((chunks > 1 && chunk_width % 8) || (!narrow && (head_dim % 8 || chunk_width % 8)) ||
      (long long)heads * chunks > 65535 || (chunks == 1 && chunk_width != head_dim))
    return cl;
  cl.dim = head_dim;
  cl.width = chunk_width;
  cl.chunks = chunks;
  cl.narrow = narrow != 0;
  return cl;
}

// Whether a call takes the general kernels.
bool general(const Cols& cl) { return cl.narrow || cl.chunks > 1; }

// The columns of a call whose head width is the build's, in 16-byte runs:
// the launchers' default (scripts/torch_attention_shapes.py launches them).
template <int kD>
constexpr Cols kExactCols{kD, kD, 1, false};

template <int kD, int kWarps, int kM, int kN, bool kGated = false>
cudaError_t launch_forward(const void* q, const void* k, const void* v, const void* pad, void* out, void* out_rest,
                           void* lse, int batch, int heads, int seq, float scale, const FwdStrides& s,
                           cudaStream_t st, const Gated& gd = Gated(), const Cols& cl = kExactCols<kD>) {
  using S = Shape<kD, kWarps, kM, kN>;
  if (general(cl)) {
    const auto kernel = forward_any_kernel<kD, kWarps, kM, kN, kGated>;
    cudaError_t err = allow_smem(kernel, S::kFwdAnySmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq + S::kOwn - 1) / S::kOwn, heads * cl.chunks, batch);
    kernel<<<grid, S::kThreads, S::kFwdAnySmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const uint8_t*>(pad), static_cast<bf16*>(out), static_cast<bf16*>(out_rest),
        static_cast<float*>(lse), heads, seq, scale, s, gd, cl);
    return cudaGetLastError();
  }
  const int dim = cl.dim;
  const auto kernel = dim == kD ? forward_kernel<kD, kWarps, kM, kN, kGated, true>
                                : forward_kernel<kD, kWarps, kM, kN, kGated, false>;
  cudaError_t err = allow_smem(kernel, S::kFwdSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + S::kOwn - 1) / S::kOwn, heads, batch);
  kernel<<<grid, S::kThreads, S::kFwdSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(pad), static_cast<bf16*>(out), static_cast<bf16*>(out_rest),
      static_cast<float*>(lse), heads, seq, dim, scale, s, gd);
  return cudaGetLastError();
}

// The gated operands: bias and gate with their element strides (bias (head,
// query, key), gate (batch, head, token)).
Gated make_gated(const void* bias, const void* gate, int seq, const long long* bias_strides,
                 const long long* gate_strides) {
  Gated gd;
  gd.bias = static_cast<const float*>(bias);
  gd.gate = static_cast<const float*>(gate);
  memcpy(gd.bs, bias_strides, 3 * sizeof(long long));
  memcpy(gd.gs, gate_strides, 3 * sizeof(long long));
  gd.vec2 = gd.bs[2] == 1 && gd.bs[0] % 2 == 0 && gd.bs[1] % 2 == 0 && seq % 2 == 0 &&
            reinterpret_cast<uintptr_t>(bias) % (2 * sizeof(float)) == 0;
  return gd;
}

// The gated operands from 20 element strides (q, k, v, out (batch, head,
// token), bias (head, query, key), gate (batch, head, token), pad (batch,
// token)); fills the FwdStrides of the rest.
Gated gated_operands(const void* bias, const void* gate, int seq, const long long* strides, FwdStrides* s) {
  memcpy(s->q, strides, 12 * sizeof(long long));
  memcpy(s->pad, strides + 18, 2 * sizeof(long long));
  return make_gated(bias, gate, seq, strides + 12, strides + 15);
}

template <int kD, int kWarps, int kM, bool kGated = false>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* out, const void* out_rest,
                      const void* dout, const void* pad, const void* lse, void* dq, void* delta, int batch,
                      int heads, int seq, float scale, const BwdStrides& s, cudaStream_t st,
                      const Gated& gd = Gated(), void* dgate = nullptr, const Cols& cl = kExactCols<kD>) {
  using S = Shape<kD, kWarps, kM>;
  if (general(cl)) {
    cudaError_t err = allow_smem(dq_any_kernel<kD, kWarps, kM, kGated>, S::kDqAnySmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq + S::kOwn - 1) / S::kOwn, heads * cl.chunks, batch);
    dq_any_kernel<kD, kWarps, kM, kGated><<<grid, S::kThreads, S::kDqAnySmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(out), static_cast<const bf16*>(out_rest), static_cast<const bf16*>(dout),
        static_cast<const uint8_t*>(pad), static_cast<const float*>(lse), static_cast<bf16*>(dq),
        static_cast<float*>(delta), static_cast<float*>(dgate), heads, seq, scale, s, gd, cl);
    return cudaGetLastError();
  }
  cudaError_t err = allow_smem(dq_kernel<kD, kWarps, kM, kGated>, S::kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + S::kOwn - 1) / S::kOwn, heads, batch);
  dq_kernel<kD, kWarps, kM, kGated><<<grid, S::kThreads, S::kDqSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(out_rest), static_cast<const bf16*>(dout),
      static_cast<const uint8_t*>(pad), static_cast<const float*>(lse), static_cast<bf16*>(dq),
      static_cast<float*>(delta), static_cast<float*>(dgate), heads, seq, cl.dim, scale, s, gd);
  return cudaGetLastError();
}

template <int kD, int kWarps, int kM, bool kGated = false>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* pad,
                       const void* lse, const void* delta, void* dk, void* dv, int batch, int heads, int seq,
                       float scale, const BwdStrides& s, cudaStream_t st, const Gated& gd = Gated(),
                       const Cols& cl = kExactCols<kD>) {
  using S = Shape<kD, kWarps, kM>;
  if (general(cl)) {  // two launches: dV, then dK
    const dim3 grid((seq + S::kOwn - 1) / S::kOwn, heads * cl.chunks, batch);
    cudaError_t err = allow_smem(dkv_any_kernel<kD, kWarps, kM, kGated, false>, S::kDkvAnySmem);
    if (err != cudaSuccess) return err;
    err = allow_smem(dkv_any_kernel<kD, kWarps, kM, kGated, true>, S::kDkvAnySmem);
    if (err != cudaSuccess) return err;
    dkv_any_kernel<kD, kWarps, kM, kGated, false><<<grid, S::kThreads, S::kDkvAnySmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, seq, scale, s,
        gd, cl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkv_any_kernel<kD, kWarps, kM, kGated, true><<<grid, S::kThreads, S::kDkvAnySmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, seq, scale, s,
        gd, cl);
    return cudaGetLastError();
  }
  cudaError_t err = allow_smem(dkv_kernel<kD, kWarps, kM, kGated>, S::kDkvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + S::kOwn - 1) / S::kOwn, heads, batch);
  dkv_kernel<kD, kWarps, kM, kGated><<<grid, S::kThreads, S::kDkvSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, seq, cl.dim, scale,
      s, gd);
  return cudaGetLastError();
}

// dbias over the batch in chunks of `items` items, one partial a chunk in
// `part` (float32 [chunks, H, T, T]; unused, may be null, with one chunk),
// summed in chunk order.
template <int kD, int kWarps, int kM>
cudaError_t launch_dbias(const void* q, const void* k, const void* v, const void* dout, const void* pad,
                         const void* lse, const void* delta, void* dbias, void* part, int batch, int items, int heads,
                         int seq, float scale, const BwdStrides& s, cudaStream_t st, const Gated& gd,
                         const Cols& cl = kExactCols<kD>) {
  using S = Shape<kD, kWarps, kM>;
  const int chunks = (batch + items - 1) / items;
  const dim3 grid((seq + S::kOwn - 1) / S::kOwn, (seq + kRows - 1) / kRows, heads * chunks);
  float* target = static_cast<float*>(chunks > 1 ? part : dbias);
  cudaError_t err;
  if (general(cl)) {
    err = allow_smem(dbias_any_kernel<kD, kWarps, kM>, S::kDbiasSmem);
    if (err != cudaSuccess) return err;
    dbias_any_kernel<kD, kWarps, kM><<<grid, S::kThreads, S::kDbiasSmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
        static_cast<const float*>(delta), target, batch, items, heads, seq, scale, s, gd, cl);
  } else {
    err = allow_smem(dbias_kernel<kD, kWarps, kM>, S::kDbiasSmem);
    if (err != cudaSuccess) return err;
    dbias_kernel<kD, kWarps, kM><<<grid, S::kThreads, S::kDbiasSmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
        static_cast<const float*>(delta), target, batch, items, heads, seq, cl.dim, scale, s, gd);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const long long n = (long long)heads * seq * seq;
  sum_chunks_kernel<<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), n, chunks);
  return cudaGetLastError();
}

// The block shapes the entry points launch: (warps, groups of 16 rows a warp;
// keys a forward tile), the same at every width.
constexpr int kFwdWarps = 4, kFwdM = 1, kFwdN = 64;
constexpr int kDqWarps = 4, kDqM = 1;
constexpr int kDkvWarps = 4, kDkvM = 1;
constexpr int kDbiasWarps = 4, kDbiasM = 1;

}  // namespace

// Every entry point takes the call's head width head_dim (D >= 1), the
// width of its column chunks chunk_width (D itself up to the build's width;
// past it a multiple of 8 up to the build's width: the chunks start at
// 16-byte aligned columns, the last holds what is left) and narrow (1: read
// and write the operands element by element, for a D or a stride that is
// not a multiple of 8 elements or a base that is not 16-byte aligned; 0:
// 16-byte runs). A call the build does not take returns
// cudaErrorInvalidValue and launches nothing.

// The gated forward (K1, K2): bf16 q, k, v and out; bias fp32 [H, T, T] and
// gate fp32 [B, H, T] (may be null: a gate of 1), any strides; pad one byte
// per key (nonzero = padded), may be null. The residuals of a backward, each
// written when not null, as the bias-free forward's below. strides: 20
// element strides, q, k, v and out (batch, head, token), bias (head, query,
// key), gate (batch, head, token), then pad (batch, token). Returns a
// cudaError_t; 0 means the kernel was launched.
extern "C" int avex_tensor_core_gated_attention_forward(const void* q, const void* k, const void* v,
                                                        const void* bias, const void* gate, const void* pad,
                                                        void* out, void* out_rest, void* lse, int batch,
                                                        int heads, int seq, int head_dim, int chunk_width,
                                                        int narrow, float scale, const long long* strides,
                                                        void* stream) {
  const Cols cl = plan_cols(head_dim, chunk_width, narrow, heads);
  if (bad_shape(batch, heads, seq) || cl.chunks == 0 || bias == nullptr) return (int)cudaErrorInvalidValue;
  FwdStrides s;
  const Gated gd = gated_operands(bias, gate, seq, strides, &s);
  return (int)launch_forward<kHeadDim, kFwdWarps, kFwdM, kFwdN, true>(
      q, k, v, pad, out, out_rest, lse, batch, heads, seq, scale, s, static_cast<cudaStream_t>(stream), gd, cl);
}

// The bias-free forward: bf16 q, k, v and out; pad is one byte per key
// (nonzero = padded) and may be null. The residuals of a backward, each written when not null: out_rest
// (bf16, out's strides) receives what rounding the output to bf16 dropped,
// lse the float32 row log-sum-exp of the scaled, padded logits, contiguous
// [B, H, T]. strides: 14 element strides, q, k, v and out (batch, head,
// token) then pad (batch, token). Returns a cudaError_t; 0 means the kernel
// was launched.
extern "C" int avex_bias_free_attention_forward(const void* q, const void* k, const void* v, const void* pad,
                                                void* out, void* out_rest, void* lse, int batch, int heads,
                                                int seq, int head_dim, int chunk_width, int narrow, float scale,
                                                const long long* strides, void* stream) {
  const Cols cl = plan_cols(head_dim, chunk_width, narrow, heads);
  if (bad_shape(batch, heads, seq) || cl.chunks == 0) return (int)cudaErrorInvalidValue;
  FwdStrides s;
  memcpy(&s, strides, sizeof(FwdStrides));
  return (int)launch_forward<kHeadDim, kFwdWarps, kFwdM, kFwdN>(q, k, v, pad, out, out_rest, lse, batch, heads, seq,
                                                                scale, s, static_cast<cudaStream_t>(stream),
                                                                Gated(), cl);
}

// The backward from the forward's residuals, bias-free (K6, bias null) or
// gated (K3): bf16 q, k, v, out (the forward's output), out_rest (may be
// null) and dout; lse as the forward wrote them; bias, gate (may be null)
// and pad as the forward's. Writes bf16 dq, dk and dv, and Δ = rowsum(dout ∘
// (out + out_rest)) into delta (float32 scratch, contiguous [B, H, T]); the
// gated backward also writes dbias (float32 [H, T, T], contiguous) and, with
// a gate, dgate (float32 [B, H, T], contiguous). It sums dbias over chunks of
// items_per_chunk batch items in parallel, then the chunks in order, through
// dbias_part (float32 scratch [ceil(B / items_per_chunk), H, T, T]; may be
// null when that is one chunk). strides: 32 element strides, q, k, v, out
// (out_rest shares them), dout, dq, dk and dv (batch, head, token), pad
// (batch, token), then bias (head, query, key) and gate (batch, head, token).
// Returns a cudaError_t; 0 means every kernel was launched.
extern "C" int avex_tensor_core_attention_backward(const void* q, const void* k, const void* v, const void* out,
                                                   const void* out_rest, const void* dout, const void* bias,
                                                   const void* gate, const void* pad, const void* lse, void* dq,
                                                   void* dk, void* dv, void* delta, void* dbias, void* dgate,
                                                   void* dbias_part, int items_per_chunk, int batch, int heads,
                                                   int seq, int head_dim, int chunk_width, int narrow, float scale,
                                                   const long long* strides, void* stream) {
  const Cols cl = plan_cols(head_dim, chunk_width, narrow, heads);
  if (bad_shape(batch, heads, seq) || cl.chunks == 0 || lse == nullptr ||
      (bias != nullptr && dbias == nullptr) || (gate != nullptr && (bias == nullptr || dgate == nullptr)) ||
      items_per_chunk <= 0 || (items_per_chunk < batch && bias != nullptr && dbias_part == nullptr) ||
      (long long)heads * ((batch + items_per_chunk - 1) / items_per_chunk) > 65535)
    return (int)cudaErrorInvalidValue;
  BwdStrides s;
  memcpy(&s, strides, sizeof(BwdStrides));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bias == nullptr) {
    err = launch_dq<kHeadDim, kDqWarps, kDqM>(q, k, v, out, out_rest, dout, pad, lse, dq, delta, batch, heads, seq,
                                              scale, s, st, Gated(), nullptr, cl);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_dkv<kHeadDim, kDkvWarps, kDkvM>(q, k, v, dout, pad, lse, delta, dk, dv, batch, heads, seq,
                                                       scale, s, st, Gated(), cl);
  }
  const Gated gd = make_gated(bias, gate, seq, strides + 26, strides + 29);
  err = launch_dq<kHeadDim, kDqWarps, kDqM, true>(q, k, v, out, out_rest, dout, pad, lse, dq, delta, batch, heads,
                                                  seq, scale, s, st, gd, dgate, cl);
  if (err != cudaSuccess) return (int)err;
  err = launch_dkv<kHeadDim, kDkvWarps, kDkvM, true>(q, k, v, dout, pad, lse, delta, dk, dv, batch, heads, seq,
                                                     scale, s, st, gd, cl);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dbias<kHeadDim, kDbiasWarps, kDbiasM>(q, k, v, dout, pad, lse, delta, dbias, dbias_part, batch,
                                                           items_per_chunk, heads, seq, scale, s, st, gd, cl);
}
