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
// contiguous. The backward of the fused layouts (K3 and K6) follows the
// forward, below, with its own design note. Everything here serves fp32
// only, and only the fp32 calls the tensor cores do not take: narrow rows
// (below) and column chunks past 128. Every bf16 forward (K1, K2, K4, K5)
// and backward (K3, K6) runs on the tensor cores in tensor_core_attention.cu,
// and every other fp32 forward and backward (a head width that is a
// multiple of 8 up to 128, on 16-byte rows) on them in 3xTF32
// (tf32x3_attention.cu): each fp32 operand split into two TF32 halves, three
// TF32 products, keeps fp32's accuracy, which one TF32 pass would not. So
// the forward here writes no row log-sum-exp: the backward of these rows,
// below, recomputes the row statistics.
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
// alone write dbias, dgate and the row statistics. One code path serves
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
                 const uint8_t* __restrict__ pad, T* __restrict__ out, int seq, float scale, Strides s,
                 Cols cl) {
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
    const float inv = 1.f / l[i];  // a fully padded row gives 0/0 = NaN, as the softmax does
    float y[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) y[j] = acc[i][j] * inv;
    store_cols_any<kC>(ob + (long long)qi * s.o[2] + tx * kC, y, tx * kC, own_cols, cl.narrow);
  }
}

template <typename T, bool kGated, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, const void* gate,
                   const void* pad, void* out, int batch, int heads, int seq, float scale, const Strides& s,
                   const Cols& cl, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, kGated, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads * cl.chunks, batch);
  attention_kernel<T, kGated, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(gate),
      static_cast<const uint8_t*>(pad), static_cast<T*>(out), seq, scale, s, cl);
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
             const void* gate, const void* pad, void* out, int batch, int heads, int seq,
             int head_dim, int chunk_width, int narrow, float scale, const Strides& s, void* stream) {
  const Cols cl = plan_cols(head_dim, chunk_width, narrow, heads);
  if (cl.chunks == 0 || bad_shape(batch, heads, seq)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: tensor_core_attention.cu
  return (int)launch<float, kGated, kHeadDim>(q, k, v, bias, gate, pad, out, batch, heads, seq, scale, s, cl, st);
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
// null. strides: 20 element strides in the order of struct Strides. Returns a
// cudaError_t; 0 means the kernel was launched.
extern "C" int avex_gated_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                            const void* bias, const void* gate, const void* pad,
                                            void* out, int batch, int heads, int seq, int head_dim,
                                            int chunk_width, int narrow, float scale, const long long* strides,
                                            void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(Strides));
  return dispatch<true>(dtype, q, k, v, bias, gate, pad, out, batch, heads, seq, head_dim, chunk_width,
                        narrow, scale, s, stream);
}

// The bias-free variant. dtype and pad as above; pad may be null. strides:
// 14 element strides, q, k, v and out (batch, head, token) then pad (batch,
// token).
extern "C" int avex_plain_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                            const void* pad, void* out, int batch, int heads,
                                            int seq, int head_dim, int chunk_width, int narrow, float scale,
                                            const long long* strides, void* stream) {
  Strides s;
  memset(&s, 0, sizeof(Strides));
  memcpy(s.q, strides, 3 * sizeof(long long));
  memcpy(s.k, strides + 3, 3 * sizeof(long long));
  memcpy(s.v, strides + 6, 3 * sizeof(long long));
  memcpy(s.o, strides + 9, 3 * sizeof(long long));
  memcpy(s.pad, strides + 12, 2 * sizeof(long long));
  return dispatch<false>(dtype, q, k, v, nullptr, nullptr, pad, out, batch, heads, seq, head_dim,
                         chunk_width, narrow, scale, s, stream);
}

// ===========================================================================
// Backward: K3 (_fused_qkv_gated_bwd_kernel, pallas_attention.py:765) and K6
// (_fused_qkv_bwd_kernel, pallas_attention.py:524), gated or bias-free by the
// same template flag. With L = q·kᵀ·scale (+ gate ⊙ bias) + pad, P = softmax(L)
// in fp32:
//
//   dV = Pᵀ·dO   dP = dO·Vᵀ   Δ = rowsum(P ∘ dP)   dL = P ∘ (dP − Δ)
//   dQ = (dL·scale)·K   dK = (dL·scale)ᵀ·Q
//   dgate[b,h,t] = Σ_k bias[h,t,k]·dL[b,h,t,k]   dbias[h] = Σ_b gate[b,h,:,None] ⊙ dL[b,h]
//
// P is rounded to v's type before Pᵀ·dO and dL·scale to q's type before the
// two products, as the TPU kernels cast them; every product accumulates in
// fp32. The residuals are the forward's inputs only (qkv, bias, gate, mask),
// as in JAX: the forward saves neither O nor the row log-sum-exp, and Δ is
// rowsum(P ∘ dP), not rowsum(dO ∘ O). dgate is computed only when there is a
// gate (JAX computes it against a gate of ones and drops it).
//
// Design. The TPU kernel holds a whole [T, T] tile per (item, head) and
// carries dbias across its sequential batch axis; Hopper blocks run in
// parallel, so the work is split in three launches:
//
//   1. dQ kernel, one block per (query tile of 64, head, chunk of batch
//      items). Per item, pass 1 walks the key tiles once for the row max,
//      the row sum and Δ (online, with the forward's rescaling); pass 2 walks
//      them again for dL, accumulates dQ = dS·K and dgate in registers, and
//      adds gate ⊙ dL into the block's [64, T] dbias rows. The rows sit in
//      shared memory while they fit (T <= 512: 64 x T fp32 beside six
//      64 x 64 tiles), and the block writes them as one partial per chunk
//      after its last item; past that they are the block's own rows of its
//      chunk's partial in device memory, written on the chunk's first item
//      and added to on the next (each thread keeps to its own elements, so
//      no two threads and no two blocks touch one address). It writes each
//      row's softmax shift, sum and Δ for launch 2.
//   2. dK/dV kernel, one block per (key tile of 64, head, item): walks the
//      query tiles, rebuilds P from launch 1's row statistics (the same fp32
//      operations in the same order, so the same P) and accumulates
//      dV = Pᵀ·dO and dK = dSᵀ·Q in registers.
//   3. (gated, more than one chunk) dbias = the sum of the partials, in chunk
//      order. No atomics anywhere: the result is deterministic.
//
// dq, dk and dv are written straight into the column views of the [B, T, 3E]
// gradient, with the strides the forward reads q, k and v with. The products
// run on the fp32 FMA units over fp32 tiles in shared memory, as in the
// forward; launch 1 computes QKᵀ and dO·Vᵀ twice and launch 2 once more:
// nine tile products where the algorithm needs five.
//
// Bound on an H100 at the BEATs training shape (B=64, H=12, T=248, D=64,
// fp32, gated): the call must read q, k, v and dO and write dq, dk and dv
// once, 7 x 48.8 MB, plus bias and dbias (2 x 2.95 MB) and gate and dgate
// (2 x 0.76 MB), 349 MB in all, about 104 us at 3.35 TB/s; its five products
// of 2·T·T·D FLOPs per (item, head) are 30 GFLOP, about 451 us at the 67
// TFLOP/s fp32 rate: bound by operations, as at EAT's (B=64, T=513,
// bias-free: 129 GFLOP, about 1.93 ms).
// The products run on the FMA units, held back by their instruction rate. It
// serves the fp32 rows the tensor cores do not take (narrow rows, column
// chunks past 128): the bf16 K3 and K6 run on them in
// tensor_core_attention.cu, the other fp32 ones in 3xTF32 in
// tf32x3_attention.cu, both from a saved log-sum-exp. Past T = 512
// the gated dQ kernel adds its dbias rows in device memory: each element is
// read and written once per batch item of the chunk, 2·B·H·T² fp32 accesses
// (at B=4, H=12, T=800: 246 MB), mostly from L2, on top of the five products.
// ===========================================================================

namespace {

// Floats of a [kD][64] or [64][kD] tile (queries or keys by head dims), and
// of a [64][64] tile (queries by keys); kBlockQ == kBlockK == 64. The dQ
// kernel holds q, dO, K (twice) and V tiles and dS; the dK/dV kernel K, V, q
// and dO transposed, q and dO, and P (then dS). The gated dQ kernel adds its
// dbias rows.
constexpr int kScoreTile = kBlockQ * kBlockK;
constexpr size_t kMaxBlockSmem = 232448;  // an H100 block's shared memory (227 KB)
template <int kD>
struct BwdTiles {
  static constexpr int kDTile = kD * kBlockQ;
  static constexpr size_t kDqSmem = sizeof(float) * (5 * kDTile + kScoreTile);
  static constexpr size_t kDkvSmem = sizeof(float) * (6 * kDTile + kScoreTile);
};

// Element strides (batch, head, token) of q, k, v, dO, dQ, dK, dV; bias
// (head, query, key); gate (batch, head, token); pad (batch, token).
struct BwdStrides {
  long long q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3];
  long long bias[3];
  long long gate[3];
  long long pad[2];
};

// acc = the [64][64] product of two transposed [kLen][64] tiles (the
// contraction runs over kLen head dims); 4 rows x 8 columns per thread.
template <int kLen>
__device__ __forceinline__ void product(const float* a, const float* b, int ra, int cb,
                                        float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  accumulate<kLen, 64, 8>(a, b, ra, cb, acc);
}

__device__ __forceinline__ float row_sum8(float x) {  // over the 8 lanes of a row group
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

// The logit of (query qi, key) from its q·k sum, as the forward computes it;
// *bias_out receives the bias value the gate multiplies (0 without a bias).
template <bool kGated>
__device__ __forceinline__ float logit(float qk, float scale, float g, const float* bias_h,
                                       const BwdStrides& s, const uint8_t* pad_b, int qi, int key,
                                       float* bias_out) {
  float x = qk * scale;
  float bv = 0.f;
  if constexpr (kGated) {
    bv = __ldg(bias_h + (long long)qi * s.bias[1] + key * s.bias[2]);
    x += g * bv;
  }
  if (pad_b && pad_b[key * s.pad[1]]) x = -INFINITY;
  *bias_out = bv;
  return x;
}

template <typename T, bool kGated, int kD>
__global__ void AVEX_LAUNCH_BOUNDS(kThreads)
attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ bias,
                    const float* __restrict__ gate, const uint8_t* __restrict__ pad,
                    T* __restrict__ dq, float* __restrict__ dgate, float* __restrict__ dbias_part,
                    float* __restrict__ stats, int batch, int heads, int seq, int items_per_chunk,
                    float scale, bool dbias_global, BwdStrides s, Cols cl) {
  constexpr int kC = kD / 8, kDT = BwdTiles<kD>::kDTile;  // dQ columns a thread; floats of a q/k/v tile
  // blockIdx.y is (head, column chunk): the block owns dQ's chunk, and chunk
  // 0's blocks alone write dbias, dgate and the row statistics.
  const int n = cl.chunks, own = blockIdx.y % n;
  const int own_cols = chunk_cols(cl, own);
  const bool writer = own == 0;
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                   // [D][BQ]  q transposed
  float* do_t = q_t + kDT;             // [D][BQ]  dO transposed
  float* k_t = do_t + kDT;             // [D][BK]  k tile transposed
  float* v_t = k_t + kDT;              // [D][BK]  v tile transposed
  float* k_s = v_t + kDT;              // [BK][D]  k tile
  float* ds_t = k_s + kDT;             // [BK][BQ] dS transposed
  float* dbias_s = ds_t + kScoreTile;  // [BQ][seq_pad] this block's dbias rows (gated, T <= 512)

  const int n_ktiles = (seq + kBlockK - 1) / kBlockK;
  const int seq_pad = n_ktiles * kBlockK;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y / n;
  const int chunk = blockIdx.z;
  const int b_end = min(batch, (chunk + 1) * items_per_chunk);
  const int tid = threadIdx.x;
  const int tx = tid & 7;   // keys tx*8.. (logits), dims tx*kC.. (dQ)
  const int ty = tid >> 3;  // query rows ty*4..ty*4+3
  const float* bias_h = kGated ? bias + h * s.bias[0] : nullptr;
  const long long bht = (long long)batch * heads * seq;
  // (dbias_global) this chunk's partial [T, T] of head h; the block owns rows q0 .. q0+63
  float* dbias_g = kGated ? dbias_part + ((long long)chunk * heads + h) * seq * seq : nullptr;

  if constexpr (kGated) {
    if (!dbias_global)
      for (int c = tid; c < kBlockQ * seq_pad; c += kThreads) dbias_s[c] = 0.f;
  }

  for (int b = chunk * items_per_chunk; b < b_end; ++b) {
    const bool first_item = b == chunk * items_per_chunk;
    const T* qb = q + b * s.q[0] + h * s.q[1];
    const T* dob = dout + b * s.dout[0] + h * s.dout[1];
    __syncthreads();  // the previous item's readers of q_t and do_t are done
    if (n == 1) {
      load_rows_any<kD>(qb, s.q[2], q0, seq, own_cols, cl.narrow, q_t, static_cast<float*>(nullptr));
      load_rows_any<kD>(dob, s.dout[2], q0, seq, own_cols, cl.narrow, do_t, static_cast<float*>(nullptr));
    }
    const T* kb = k + b * s.k[0] + h * s.k[1];
    const T* vb = v + b * s.v[0] + h * s.v[1];
    const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
    // S = Q·Kᵀ and dP = dO·Vᵀ of the key tile at k0 (with_ks: K's own
    // chunk also row-major into k_s, for dQ += dS·K). With more than one
    // chunk they sum over the chunks, reloading Q's and dO's.
    auto products = [&](int k0, float sc[4][8], float dp[4][8], bool with_ks) {
      if (n == 1) {
        __syncthreads();
        load_rows_any<kD>(kb, s.k[2], k0, seq, own_cols, cl.narrow, k_t, with_ks ? k_s : static_cast<float*>(nullptr));
        load_rows_any<kD>(vb, s.v[2], k0, seq, own_cols, cl.narrow, v_t, static_cast<float*>(nullptr));
        __syncthreads();
        product<kD>(q_t, k_t, ty * 4, tx * 8, sc);
        product<kD>(do_t, v_t, ty * 4, tx * 8, dp);
        return;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int cc = 0; cc < n; ++cc) {
        const int col = cc * cl.width, cols = chunk_cols(cl, cc);
        __syncthreads();
        load_rows_any<kD>(qb + col, s.q[2], q0, seq, cols, cl.narrow, q_t, static_cast<float*>(nullptr));
        load_rows_any<kD>(dob + col, s.dout[2], q0, seq, cols, cl.narrow, do_t, static_cast<float*>(nullptr));
        load_rows_any<kD>(kb + col, s.k[2], k0, seq, cols, cl.narrow, k_t,
                          with_ks && cc == own ? k_s : static_cast<float*>(nullptr));
        load_rows_any<kD>(vb + col, s.v[2], k0, seq, cols, cl.narrow, v_t, static_cast<float*>(nullptr));
        __syncthreads();
        accumulate<kD, kBlockK, 8>(q_t, k_t, ty * 4, tx * 8, sc);
        accumulate<kD, kBlockK, 8>(do_t, v_t, ty * 4, tx * 8, dp);
      }
    };

    float g[4], m[4], l[4], dsum[4];
    bool row_ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      row_ok[i] = qi < seq;
      g[i] = 1.f;
      if (kGated && gate && row_ok[i]) g[i] = gate[b * s.gate[0] + h * s.gate[1] + qi * s.gate[2]];
      m[i] = -INFINITY;
      l[i] = 0.f;
      dsum[i] = 0.f;
    }

    // Pass 1: row max, row sum and Σ exp(L - m)·dP, online.
    for (int k0 = 0; k0 < seq; k0 += kBlockK) {
      float sc[4][8], dp[4][8];
      products(k0, sc, dp, false);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + tx * 8 + j;
          float bv, x = -INFINITY;
          if (row_ok[i] && key < seq)
            x = logit<kGated>(sc[i][j], scale, g[i], bias_h, s, pad_b, qi, key, &bv);
          sc[i][j] = x;
          tile_max = fmaxf(tile_max, x);
        }
        const float m_new = fmaxf(m[i], row_max8(tile_max));
        const float shift = m_new == -INFINITY ? 0.f : m_new;
        const float corr = expf(m[i] - shift);
        float tile_l = 0.f, tile_d = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = expf(sc[i][j] - shift);
          tile_l += p;
          tile_d += p * dp[i][j];
        }
        l[i] = l[i] * corr + row_sum8(tile_l);
        dsum[i] = dsum[i] * corr + row_sum8(tile_d);
        m[i] = m_new;
      }
    }
    float shift[4], delta[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      shift[i] = m[i] == -INFINITY ? 0.f : m[i];
      delta[i] = dsum[i] / l[i];
    }

    // Pass 2: dL, then dQ += dS·K, dgate and dbias.
    float acc[4][kC], dg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < seq; k0 += kBlockK) {
      float sc[4][8], dp[4][8];
      products(k0, sc, dp, true);  // its first barrier: the previous tile's readers of k_s and ds_t are done
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        float dl[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + tx * 8 + j;
          dl[j] = 0.f;
          if (row_ok[i] && key < seq) {
            float bv;
            const float x = logit<kGated>(sc[i][j], scale, g[i], bias_h, s, pad_b, qi, key, &bv);
            const float p = expf(x - shift[i]) / l[i];
            dl[j] = p * (dp[i][j] - delta[i]);
            if constexpr (kGated) dg[i] = fmaf(bv, dl[j], dg[i]);
          }
          ds_t[(tx * 8 + j) * kBlockQ + ty * 4 + i] = dl[j] * scale;
        }
        if constexpr (kGated) {
          if (!writer) {
          } else if (dbias_global) {
            if (row_ok[i]) {
              float* row = dbias_g + (long long)qi * seq;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int key = k0 + tx * 8 + j;
                if (key < seq) row[key] = first_item ? g[i] * dl[j] : fmaf(g[i], dl[j], row[key]);
              }
            }
          } else {
            float* row = dbias_s + (ty * 4 + i) * seq_pad + k0 + tx * 8;
            float cur[8];
            load8(row, cur);
#pragma unroll
            for (int j = 0; j < 8; ++j) cur[j] = fmaf(g[i], dl[j], cur[j]);
            store8(row, cur);
          }
        }
      }
      __syncthreads();
      accumulate<kBlockK, kD, kC>(ds_t, k_s, ty * 4, tx * kC, acc);
    }

    T* dqb = dq + b * s.dq[0] + h * s.dq[1] + own * cl.width;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if (row_ok[i]) store_cols_any<kC>(dqb + (long long)qi * s.dq[2] + tx * kC, acc[i], tx * kC, own_cols, cl.narrow);
      const float dg_row = row_sum8(dg[i]);
      if (row_ok[i] && tx == 0 && writer) {
        const long long at = ((long long)b * heads + h) * seq + qi;
        stats[at] = shift[i];
        stats[bht + at] = l[i];
        stats[2 * bht + at] = delta[i];
        if (kGated && dgate) dgate[at] = dg_row;
      }
    }
  }

  if constexpr (kGated) {
    if (!dbias_global && writer) {
      __syncthreads();
      for (int c = tid; c < kBlockQ * seq_pad; c += kThreads) {
        const int r = c / seq_pad, key = c % seq_pad;
        if (q0 + r < seq && key < seq) dbias_g[(long long)(q0 + r) * seq + key] = dbias_s[c];
      }
    }
  }
}

template <typename T, bool kGated, int kD>
__global__ void AVEX_LAUNCH_BOUNDS(kThreads)
attention_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ bias,
                     const float* __restrict__ gate, const uint8_t* __restrict__ pad,
                     T* __restrict__ dk, T* __restrict__ dv, const float* __restrict__ stats,
                     int batch, int heads, int seq, float scale, BwdStrides s, Cols cl) {
  constexpr int kC = kD / 8, kDT = BwdTiles<kD>::kDTile;  // dK/dV columns a thread; floats of a q/k/v tile
  // blockIdx.y is (head, column chunk): the block owns dK's and dV's chunk.
  const int n = cl.chunks, own = blockIdx.y % n;
  const int own_cols = chunk_cols(cl, own);
  extern __shared__ __align__(16) float smem[];
  float* k_t = smem;          // [D][BK]  k tile transposed
  float* v_t = k_t + kDT;     // [D][BK]  v tile transposed
  float* q_t = v_t + kDT;     // [D][BQ]  q tile transposed
  float* do_t = q_t + kDT;    // [D][BQ]  dO tile transposed
  float* q_s = do_t + kDT;    // [BQ][D]  q tile
  float* do_s = q_s + kDT;    // [BQ][D]  dO tile
  float* pds = do_s + kDT;    // [BQ][BK] P, then dS

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y / n;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 7;   // queries tx*8.. (logits), dims tx*kC.. (dK, dV)
  const int ty = tid >> 3;  // key rows ty*4..ty*4+3
  const float* bias_h = kGated ? bias + h * s.bias[0] : nullptr;
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;
  const long long bht = (long long)batch * heads * seq;
  const long long row0 = ((long long)b * heads + h) * seq;

  const T* kb = k + b * s.k[0] + h * s.k[1];
  const T* vb = v + b * s.v[0] + h * s.v[1];
  if (n == 1) {
    load_rows_any<kD>(kb, s.k[2], k0, seq, own_cols, cl.narrow, k_t, static_cast<float*>(nullptr));
    load_rows_any<kD>(vb, s.v[2], k0, seq, own_cols, cl.narrow, v_t, static_cast<float*>(nullptr));
  }
  const T* qb = q + b * s.q[0] + h * s.q[1];
  const T* dob = dout + b * s.dout[0] + h * s.dout[1];

  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = k0 + ty * 4 + i < seq;

  float dk_acc[4][kC], dv_acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kBlockQ) {
    float st[4][8], dpt[4][8];  // [key][query]
    if (n == 1) {
      __syncthreads();  // the previous tile's readers of the q/dO tiles and pds are done
      load_rows_any<kD>(qb, s.q[2], q0, seq, own_cols, cl.narrow, q_t, q_s);
      load_rows_any<kD>(dob, s.dout[2], q0, seq, own_cols, cl.narrow, do_t, do_s);
      __syncthreads();
      product<kD>(k_t, q_t, ty * 4, tx * 8, st);
      product<kD>(v_t, do_t, ty * 4, tx * 8, dpt);
    } else {
      // Sᵀ and dPᵀ over every column chunk, the K, V, q and dO chunks
      // reloaded for each; q's and dO's own chunk also row-major (q_s, do_s).
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int cc = 0; cc < n; ++cc) {
        const int col = cc * cl.width, cols = chunk_cols(cl, cc);
        __syncthreads();
        load_rows_any<kD>(kb + col, s.k[2], k0, seq, cols, cl.narrow, k_t, static_cast<float*>(nullptr));
        load_rows_any<kD>(vb + col, s.v[2], k0, seq, cols, cl.narrow, v_t, static_cast<float*>(nullptr));
        load_rows_any<kD>(qb + col, s.q[2], q0, seq, cols, cl.narrow, q_t,
                          cc == own ? q_s : static_cast<float*>(nullptr));
        load_rows_any<kD>(dob + col, s.dout[2], q0, seq, cols, cl.narrow, do_t,
                          cc == own ? do_s : static_cast<float*>(nullptr));
        __syncthreads();
        accumulate<kD, kBlockQ, 8>(k_t, q_t, ty * 4, tx * 8, st);
        accumulate<kD, kBlockQ, 8>(v_t, do_t, ty * 4, tx * 8, dpt);
      }
    }
    float dl[4][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = q0 + tx * 8 + j;
      const bool q_ok = qi < seq;
      float shift = 0.f, l = 1.f, delta = 0.f, g = 1.f;
      if (q_ok) {
        shift = stats[row0 + qi];
        l = stats[bht + row0 + qi];
        delta = stats[2 * bht + row0 + qi];
        if (kGated && gate) g = gate[b * s.gate[0] + h * s.gate[1] + qi * s.gate[2]];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
        float p = 0.f;
        dl[i][j] = 0.f;
        if (q_ok && key_ok[i]) {
          float bv;
          const float x = logit<kGated>(st[i][j], scale, g, bias_h, s, pad_b, qi, key, &bv);
          p = expf(x - shift) / l;
          dl[i][j] = p * (dpt[i][j] - delta);
        }
        pds[(tx * 8 + j) * kBlockK + ty * 4 + i] = p;
      }
    }
    __syncthreads();
    accumulate<kBlockQ, kD, kC>(pds, do_s, ty * 4, tx * kC, dv_acc);  // dV += Pᵀ·dO
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pds[(tx * 8 + j) * kBlockK + ty * 4 + i] = dl[i][j] * scale;
    __syncthreads();
    accumulate<kBlockQ, kD, kC>(pds, q_s, ty * 4, tx * kC, dk_acc);  // dK += dSᵀ·Q
  }

  T* dkb = dk + b * s.dk[0] + h * s.dk[1] + own * cl.width;
  T* dvb = dv + b * s.dv[0] + h * s.dv[1] + own * cl.width;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!key_ok[i]) continue;
    const int key = k0 + ty * 4 + i;
    store_cols_any<kC>(dkb + (long long)key * s.dk[2] + tx * kC, dk_acc[i], tx * kC, own_cols, cl.narrow);
    store_cols_any<kC>(dvb + (long long)key * s.dv[2] + tx * kC, dv_acc[i], tx * kC, own_cols, cl.narrow);
  }
}

// dbias[i] = Σ_c part[c][i], in chunk order.
__global__ void dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    long long n, int chunks) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < chunks; ++c) sum += part[c * n + i];
    out[i] = sum;
  }
}

template <typename T, bool kGated, int kD>
cudaError_t launch_backward(const void* q, const void* k, const void* v, const void* dout,
                            const void* bias, const void* gate, const void* pad, void* dq,
                            void* dk, void* dv, void* dbias_part, void* dbias, void* dgate,
                            void* stats, int batch, int heads, int seq, const Cols& cl, float scale,
                            int items_per_chunk, const BwdStrides& s, cudaStream_t stream) {
  const int tiles = (seq + kBlockQ - 1) / kBlockQ;
  const int chunks = (batch + items_per_chunk - 1) / items_per_chunk;
  const size_t rows_smem = kGated ? sizeof(float) * kBlockQ * tiles * kBlockK : 0;  // the dbias rows
  const bool dbias_global = BwdTiles<kD>::kDqSmem + rows_smem > kMaxBlockSmem;      // T > 512
  const size_t dq_smem = BwdTiles<kD>::kDqSmem + (dbias_global ? 0 : rows_smem);
  constexpr size_t dkv_smem = BwdTiles<kD>::kDkvSmem;
  cudaError_t err = cudaFuncSetAttribute(attention_dq_kernel<T, kGated, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_dkv_kernel<T, kGated, kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  attention_dq_kernel<T, kGated, kD><<<dim3(tiles, heads * cl.chunks, chunks), kThreads, dq_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(bias),
      static_cast<const float*>(gate), static_cast<const uint8_t*>(pad), static_cast<T*>(dq),
      static_cast<float*>(dgate), static_cast<float*>(chunks > 1 ? dbias_part : dbias),
      static_cast<float*>(stats), batch, heads, seq, items_per_chunk, scale, dbias_global, s, cl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_dkv_kernel<T, kGated, kD><<<dim3(tiles, heads * cl.chunks, batch), kThreads, dkv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(bias),
      static_cast<const float*>(gate), static_cast<const uint8_t*>(pad), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<const float*>(stats), batch, heads, seq, scale, s, cl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (kGated && chunks > 1) {
    const long long n = (long long)heads * seq * seq;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    dbias_reduce_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(dbias_part),
                                                    static_cast<float*>(dbias), n, chunks);
  }
  return cudaGetLastError();
}

template <bool kGated>
int dispatch_backward(int dtype, const void* q, const void* k, const void* v, const void* dout,
                      const void* bias, const void* gate, const void* pad, void* dq, void* dk,
                      void* dv, void* dbias_part, void* dbias, void* dgate, void* stats, int batch,
                      int heads, int seq, int head_dim, int chunk_width, int narrow, float scale,
                      int items_per_chunk, const BwdStrides& s, void* stream) {
  const Cols cl = plan_cols(head_dim, chunk_width, narrow, heads);
  if (cl.chunks == 0 || bad_shape(batch, heads, seq) || items_per_chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: tensor_core_attention.cu
  return (int)launch_backward<float, kGated, kHeadDim>(q, k, v, dout, bias, gate, pad, dq, dk, dv, dbias_part,
                                                       dbias, dgate, stats, batch, heads, seq, cl, scale,
                                                       items_per_chunk, s, st);
}

}  // namespace

// The backward of both variants over (batch, head, token)-strided views.
// dtype must be 0 (float32; q, k, v, dout, dq, dk and dv share it). gated = 1
// reads bias (float32 [H, T, T]) and gate (float32, may be null) and writes
// dbias (float32 [H, T, T], contiguous) and, with a gate, dgate (float32
// [B, H, T], contiguous); gated = 0 ignores all four. pad may be null.
// stats: float32 scratch of 3·B·H·T. items_per_chunk: batch items per dQ
// block (gated; the bias-free variant takes one); dbias_part: float32 scratch
// of ceil(B / items_per_chunk)·H·T·T, unused (may be null) when that count is
// 1. strides: 29 element strides in the order of struct BwdStrides. Returns a
// cudaError_t; 0 means every kernel was launched.
extern "C" int avex_attention_backward(int dtype, int gated, const void* q, const void* k,
                                       const void* v, const void* dout, const void* bias,
                                       const void* gate, const void* pad, void* dq, void* dk,
                                       void* dv, void* dbias_part, void* dbias, void* dgate,
                                       void* stats, int batch, int heads, int seq, int head_dim,
                                       int chunk_width, int narrow, float scale, int items_per_chunk,
                                       const long long* strides, void* stream) {
  BwdStrides s;
  memcpy(&s, strides, sizeof(BwdStrides));
  if (gated)
    return dispatch_backward<true>(dtype, q, k, v, dout, bias, gate, pad, dq, dk, dv, dbias_part,
                                   dbias, dgate, stats, batch, heads, seq, head_dim, chunk_width, narrow,
                                   scale, items_per_chunk, s, stream);
  return dispatch_backward<false>(dtype, q, k, v, dout, nullptr, nullptr, pad, dq, dk, dv,
                                  nullptr, nullptr, nullptr, stats, batch, heads, seq, head_dim,
                                  chunk_width, narrow, scale, 1, s, stream);
}
