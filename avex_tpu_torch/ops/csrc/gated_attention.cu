// Attention for Hopper (sm_90a), plain C ABI, in two compile-time variants:
//
//   gated:     out = softmax(q·kᵀ·scale + gate ⊙ bias + pad) · v
//   bias-free: out = softmax(q·kᵀ·scale + pad) · v
//
// Replaces four Pallas TPU kernels of the JAX package. The gated variant:
//   - _attention_kernel        avex_tpu/ops/pallas_attention.py:126  (split q/k/v [B,H,T,D])
//   - _fused_qkv_gated_kernel  avex_tpu/ops/pallas_attention.py:389  (column views of [B,T,3E])
// The bias-free variant, which never reads a bias or a gate:
//   - _plain_attention_kernel  avex_tpu/ops/pallas_attention.py:161  (split q/k/v [B,H,T,D])
//   - _fused_qkv_kernel        avex_tpu/ops/pallas_attention.py:344  (column views of [B,T,3E])
// Both layouts are only different strides here: every operand is a base
// pointer plus (batch, head, token) strides, with the head dimension
// contiguous. Everything here is the fp32 forward of the calls the tensor
// cores' forwards do not take: narrow rows (below) and column chunks past
// 128. Every bf16 forward (K1, K2, K4, K5) runs on the tensor cores in
// tensor_core_attention.cu, every other fp32 forward (a head width that is a
// multiple of 8 up to 128, on 16-byte rows) on them in 3xTF32
// (tf32x3_attention.cu), and every fp32 backward (K3, K6), at any width, in
// 3xTF32 in tf32x3_attention.cu: this file has no backward. So the forward
// here writes, when the backward will follow, the row log-sum-exp that the
// 3xTF32 backward rebuilds P from.
//
// Head widths: both variants take any D >= 1. The width kD is a template
// parameter; each build of this source instantiates one, chosen with
// -DAVEX_HEAD_DIM (32, 64, 80, 96 or 128). A D up to 128 runs on the
// smallest kD that holds it: the columns D .. kD-1 are zero-filled on load
// (they are the next head's in the fused layout) and never stored, so they
// add 0 to every product and the result is exact. Rows whose D or a stride
// is not a multiple of 8, or whose base is off a 16-byte boundary (narrow
// rows), are loaded and stored element by element. Past 128, D is cut into
// column chunks of a multiple of 8 (the wrapper's plan): the block of chunk
// c owns that chunk of the output and sums the logits over every chunk
// (reloading the other chunks' tiles for each tile), and chunk 0's blocks
// alone write the row log-sum-exp. One code path serves
// them all: with one chunk and 16-byte rows it does what these kernels did
// when they took only the multiples of 8 up to 128.
//
// Design. One block of 128 threads owns BQ=64 query rows of one (batch, head)
// and walks the keys in tiles of BK=64. Q, the K tile and the V tile are
// staged in shared memory as fp32; the [BQ, BK] logits live in registers
// (4 rows x 8 keys per thread; the output 4 rows x D/8 dims), the gate and the shared [H,T,T] bias are
// applied there (gated variant only), and a padded key gets -inf. The
// softmax is online, in fp32: a running row max and row sum, with the
// accumulator rescaled per tile. P is rounded to v's type before the PV
// product (as the TPU kernels cast their softmax to v.dtype), the product
// accumulates in fp32, and the output is written in v's type. The TPU kernels
// held the whole [T,T] tile in VMEM; a Hopper block has at most 227 KB of
// shared memory, hence the key tiling. A ragged last tile of queries or keys
// (T = 513: 8 full tiles and 1 row) is masked, not padded.
//
// Bound on an H100, e.g. at dh 136 on two column chunks (B=128, H=6,
// T=248, gated): 4·B·H·T²·D = 25.7 GFLOP take about 384 us at the 67 TFLOP/s
// fp32 rate, against 4 x 103.6 MB of q, k, v and out plus the bias and gate,
// about 124 us at 3.35 TB/s: bound by operations. The products run on the
// fp32 FMA units, so this kernel is held back by its FMA instruction rate;
// the rows it serves are the ones the tensor-core kernels' 16-byte fragment
// loads and single-chunk tiles do not take.

#include <cuda_runtime.h>
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

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

// Shared memory of the forward at head width kD: q and the K tile
// transposed, the V tile, and the probabilities.
template <int kD>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (kD * kBlockQ + kD * kBlockK + kBlockK * kD + kBlockK * kBlockQ);
}

// Element strides. q/k/v/out/gate: (batch, head, token); bias: (head, query,
// key); pad: (batch, token). The head-dim stride of q/k/v/out is 1.
struct Strides {
  long long q[3], k[3], v[3], o[3];
  long long bias[3];
  long long gate[3];
  long long pad[2];
};

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// A thread's kC = kD/8 output columns of a row: 4, 8, 12 and 16 (head widths
// 32, 64, 96, 128) as 16-byte moves, 10 (head width 80) as five 8-byte ones
// (its columns start at 40-byte offsets).
template <int kC>
__device__ __forceinline__ void load_cols(const float* p, float* x) {
  if constexpr (kC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kC / 4; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(p + 4 * i);
      x[4 * i] = a.x; x[4 * i + 1] = a.y; x[4 * i + 2] = a.z; x[4 * i + 3] = a.w;
    }
  } else {
    static_assert(kC % 2 == 0, "an even column count");
#pragma unroll
    for (int i = 0; i < kC / 2; ++i) {
      const float2 a = *reinterpret_cast<const float2*>(p + 2 * i);
      x[2 * i] = a.x; x[2 * i + 1] = a.y;
    }
  }
}

template <int kC>
__device__ __forceinline__ void store_cols(float* p, const float* x) {
  if constexpr (kC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kC / 4; ++i)
      *reinterpret_cast<float4*>(p + 4 * i) = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kC / 2; ++i) *reinterpret_cast<float2*>(p + 2 * i) = make_float2(x[2 * i], x[2 * i + 1]);
  }
}

// store_cols for the thread's columns c0 .. c0+kC-1 of a row p (p points at
// column c0) that lie below dim: kC = kD/8 columns straddle dim when D is not
// a multiple of kC (D=72 on kD=80), and then go one by one.
template <int kC>
__device__ __forceinline__ void store_cols_below(float* p, const float* x, int c0, int dim) {
  if (c0 + kC <= dim) {
    store_cols<kC>(p, x);
  } else {
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if (c0 + j < dim) p[j] = x[j];
  }
}

// The columns of a call: head width D, cut into
// `chunks` column chunks of `width` columns (the last holds what is left),
// each run on this build's kD. narrow: the operands are read and written
// element by element (D, the chunk width or a stride not a multiple of 8,
// or a base not 16-byte aligned), else in runs of 8.
struct Cols {
  int dim = 0, width = 0, chunks = 1;
  bool narrow = false;
};

// Columns of chunk cc.
__device__ __forceinline__ int chunk_cols(const Cols& cl, int cc) { return min(cl.width, cl.dim - cc * cl.width); }

// Rows r0 .. r0+63 of a [T, cols] operand (row stride rs) into shared memory
// as kD columns: transposed into trans[kD][64] and/or as rows[64][kD]; rows
// past seq and the columns past cols are zero. Unless narrow (cols a multiple
// of 8, rows 16-byte aligned), in runs of 8; else element by element.
template <int kD, typename T>
__device__ __forceinline__ void load_rows_any(const T* base, long long rs, int r0, int seq, int cols, bool narrow,
                                              float* trans, float* rows) {
  for (int c = threadIdx.x; c < 64 * (kD / 8); c += kThreads) {
    const int r = c % 64;
    const int chunk = c / 64;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < seq && chunk * 8 < cols) {
      const T* src = base + (long long)(r0 + r) * rs + chunk * 8;
      if (!narrow) {
        load8(src, x);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (chunk * 8 + j < cols) x[j] = src[j];
      }
    }
    if (trans) {
#pragma unroll
      for (int j = 0; j < 8; ++j) trans[(chunk * 8 + j) * 64 + r] = x[j];
    }
    if (rows) store8(rows + r * kD + chunk * 8, x);
  }
}

// store_cols_below, element by element when narrow.
template <int kC>
__device__ __forceinline__ void store_cols_any(float* p, const float* x, int c0, int cols, bool narrow) {
  if (!narrow) {
    store_cols_below<kC>(p, x, c0, cols);
  } else {
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if (c0 + j < cols) p[j] = x[j];
  }
}

// acc[i][j] += Σ_c a[c][ra + i] · b[c][cb + j] over c < kLen, for a tile a
// with rows of 64 and a tile b with rows of kLdB in shared memory (4 rows x
// kC columns per thread).
template <int kLen, int kLdB, int kC>
__device__ __forceinline__ void accumulate(const float* a, const float* b, int ra, int cb,
                                           float acc[4][kC]) {
#pragma unroll 8
  for (int c = 0; c < kLen; ++c) {
    const float4 aa = *reinterpret_cast<const float4*>(a + c * 64 + ra);
    const float av[4] = {aa.x, aa.y, aa.z, aa.w};
    float bv[kC];
    load_cols<kC>(b + c * kLdB + cb, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// One block per (query tile, head and column chunk, item) owns chunk c of
// the output; for each key tile it sums S = Σ_cc Q_cc·K_ccᵀ over every
// chunk (reloading Q's chunk when there is more than one), then P·V_c.
template <typename T, bool kGated, int kD>
__global__ void AVEX_LAUNCH_BOUNDS(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const float* __restrict__ gate,
                 const uint8_t* __restrict__ pad, T* __restrict__ out, float* __restrict__ lse, int seq,
                 float scale, Strides s, Cols cl) {
  constexpr int kC = kD / 8;  // output columns a thread
  const int n = cl.chunks, own = blockIdx.y % n;  // column chunks, this block's
  const int own_cols = chunk_cols(cl, own);
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                            // [D][BQ]  q transposed
  float* k_t = q_t + kD * kBlockQ;              // [D][BK]  k tile transposed
  float* v_s = k_t + kD * kBlockK;              // [BK][D]  v tile
  float* p_t = v_s + kBlockK * kD;              // [BK][BQ] probabilities transposed

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y / n;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 7;   // keys tx*8..tx*8+7 (logits), dims tx*kC..tx*kC+kC-1 (output)
  const int ty = tid >> 3;  // query rows ty*4..ty*4+3; the 8 lanes of a row group share a warp

  const T* qb = q + b * s.q[0] + h * s.q[1];
  const T* kb = k + b * s.k[0] + h * s.k[1];
  const T* vb = v + b * s.v[0] + h * s.v[1] + own * cl.width;
  T* ob = out + b * s.o[0] + h * s.o[1] + own * cl.width;
  const float* bias_h = kGated ? bias + h * s.bias[0] : nullptr;
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;

  // Q tile, transposed into shared memory (once with one chunk); rows past
  // the sequence are zero.
  if (n == 1) load_rows_any<kD>(qb, s.q[2], q0, seq, own_cols, cl.narrow, q_t, static_cast<float*>(nullptr));

  float g[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    row_ok[i] = qi < seq;
    g[i] = 1.f;
    if (kGated && gate && row_ok[i]) g[i] = gate[b * s.gate[0] + h * s.gate[1] + qi * s.gate[2]];
  }

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    // S over every column chunk: Q's chunk (reloaded when there is more than
    // one) and K's; V's own chunk with the first.
    for (int cc = 0; cc < n; ++cc) {
      __syncthreads();  // the previous readers of q_t, k_t, v_s and p_t are done
      const int col = cc * cl.width, cols = chunk_cols(cl, cc);
      if (n > 1) load_rows_any<kD>(qb + col, s.q[2], q0, seq, cols, cl.narrow, q_t, static_cast<float*>(nullptr));
      load_rows_any<kD>(kb + col, s.k[2], k0, seq, cols, cl.narrow, k_t, static_cast<float*>(nullptr));
      if (cc == 0) load_rows_any<kD>(vb, s.v[2], k0, seq, own_cols, cl.narrow, static_cast<float*>(nullptr), v_s);
      __syncthreads();
      accumulate<kD, kBlockK, 8>(q_t, k_t, ty * 4, tx * 8, sc);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + tx * 8 + j;
        float x = -INFINITY;
        if (row_ok[i] && key < seq) {
          x = sc[i][j] * scale;
          if constexpr (kGated)
            x += g[i] * __ldg(bias_h + (long long)qi * s.bias[1] + key * s.bias[2]);
          if (pad_b && pad_b[key * s.pad[1]]) x = -INFINITY;
        }
        sc[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 4));
      const float m_new = fmaxf(m[i], tile_max);
      // A row with every key so far padded keeps m = -inf; shift by 0 there
      // so that exp() sees -inf - 0 and gives 0 rather than NaN.
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - shift);
      float tile_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - shift);
        tile_sum += p;
        p_t[(tx * 8 + j) * kBlockQ + ty * 4 + i] = p;
      }
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 4);
      l[i] = l[i] * corr + tile_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(p_t + c * kBlockQ + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[kC];
      load_cols<kC>(v_s + c * kD + tx * kC, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const int qi = q0 + ty * 4 + i;
    // The row log-sum-exp for the backward, from chunk 0's blocks (every
    // chunk's block holds the same statistics): −inf for a fully padded row.
    if (lse && own == 0 && tx == 0) lse[((long long)b * (gridDim.y / n) + h) * seq + qi] = m[i] + logf(l[i]);
    const float inv = 1.f / l[i];  // a fully padded row gives 0/0 = NaN, as the softmax does
    float y[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) y[j] = acc[i][j] * inv;
    store_cols_any<kC>(ob + (long long)qi * s.o[2] + tx * kC, y, tx * kC, own_cols, cl.narrow);
  }
}

template <typename T, bool kGated, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, const void* gate,
                   const void* pad, void* out, void* lse, int batch, int heads, int seq, float scale,
                   const Strides& s, const Cols& cl, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, kGated, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads * cl.chunks, batch);
  attention_kernel<T, kGated, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(gate),
      static_cast<const uint8_t*>(pad), static_cast<T*>(out), static_cast<float*>(lse), seq, scale, s, cl);
  return cudaGetLastError();
}

// The head width this library's kernels are built for (-DAVEX_HEAD_DIM: 32,
// 64, 80, 96 or 128; the wrapper builds one library a width).
constexpr int kHeadDim = AVEX_HEAD_DIM;
static_assert(kHeadDim == 32 || kHeadDim == 64 || kHeadDim == 80 || kHeadDim == 96 || kHeadDim == 128,
              "AVEX_HEAD_DIM: 32, 64, 80, 96 or 128");

bool bad_shape(int batch, int heads, int seq) {
  return seq <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535;
}

// The columns of a call of head width head_dim in chunks of chunk_width
// (the wrapper's plan), or a Cols with chunks = 0 when this build does not
// take them: a chunk wider than the build; more than one chunk of a width
// that is not a multiple of 8; a wide (not narrow) call whose widths are not
// multiples of 8; more head chunks than a grid axis holds.
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

template <bool kGated>
int dispatch(int dtype, const void* q, const void* k, const void* v, const void* bias,
             const void* gate, const void* pad, void* out, void* lse, int batch, int heads, int seq,
             int head_dim, int chunk_width, int narrow, float scale, const Strides& s, void* stream) {
  const Cols cl = plan_cols(head_dim, chunk_width, narrow, heads);
  if (cl.chunks == 0 || bad_shape(batch, heads, seq)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: tensor_core_attention.cu
  return (int)launch<float, kGated, kHeadDim>(q, k, v, bias, gate, pad, out, lse, batch, heads, seq, scale, s, cl,
                                              st);
}

}  // namespace

// Every entry point takes the call's head width head_dim (D >= 1), the
// width of its column chunks chunk_width (D itself up to the build's width;
// past it a multiple of 8 up to the build's width, the last chunk holding
// what is left) and narrow (1: the operands are read and written element by
// element, for a D or a stride that is not a multiple of 8 or a base that is
// not 16-byte aligned). A call the build does not take returns
// cudaErrorInvalidValue and launches nothing.
//
// dtype: must be 0 = float32 (q, k, v and out share it); bias and gate
// are float32, pad is one byte per key (nonzero = padded); gate and pad may be
// null. lse, when not null, receives the row log-sum-exp of the logits
// (float32, contiguous [B, H, T]; −inf where every key is padded) for the
// 3xTF32 backward. strides: 20 element strides in the order of struct
// Strides. Returns a cudaError_t; 0 means the kernel was launched.
extern "C" int avex_gated_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                            const void* bias, const void* gate, const void* pad,
                                            void* out, void* lse, int batch, int heads, int seq, int head_dim,
                                            int chunk_width, int narrow, float scale, const long long* strides,
                                            void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(Strides));
  return dispatch<true>(dtype, q, k, v, bias, gate, pad, out, lse, batch, heads, seq, head_dim, chunk_width,
                        narrow, scale, s, stream);
}

// The bias-free variant. dtype, pad and lse as above; pad and lse may be
// null. strides: 14 element strides, q, k, v and out (batch, head, token)
// then pad (batch, token).
extern "C" int avex_plain_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                            const void* pad, void* out, void* lse, int batch, int heads,
                                            int seq, int head_dim, int chunk_width, int narrow, float scale,
                                            const long long* strides, void* stream) {
  Strides s;
  memset(&s, 0, sizeof(Strides));
  memcpy(s.q, strides, 3 * sizeof(long long));
  memcpy(s.k, strides + 3, 3 * sizeof(long long));
  memcpy(s.v, strides + 6, 3 * sizeof(long long));
  memcpy(s.o, strides + 9, 3 * sizeof(long long));
  memcpy(s.pad, strides + 12, 2 * sizeof(long long));
  return dispatch<false>(dtype, q, k, v, nullptr, nullptr, pad, out, lse, batch, heads, seq, head_dim,
                         chunk_width, narrow, scale, s, stream);
}
