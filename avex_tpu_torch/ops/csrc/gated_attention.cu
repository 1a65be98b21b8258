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
// contiguous.
//
// Design. One block of 128 threads owns BQ=64 query rows of one (batch, head)
// and walks the keys in tiles of BK=64. Q, the K tile and the V tile are
// staged in shared memory as fp32; the [BQ, BK] logits live in registers
// (4 rows x 8 keys per thread), the gate and the shared [H,T,T] bias are
// applied there (gated variant only), and a padded key gets -inf. The
// softmax is online, in fp32: a running row max and row sum, with the
// accumulator rescaled per tile. P is rounded to v's type before the PV
// product (as the TPU kernels cast their softmax to v.dtype), the product
// accumulates in fp32, and the output is written in v's type. The TPU kernels
// held the whole [T,T] tile in VMEM; a Hopper block has at most 227 KB of
// shared memory, hence the key tiling. A ragged last tile of queries or keys
// (T = 513: 8 full tiles and 1 row) is masked, not padded.
//
// Bound on an H100 at the BEATs shape (B=128, H=12, T=248, D=64, bf16, gated):
// the call must read q, k, v and write out once, 4 x 48.8 MB, plus the fp32
// bias (3.0 MB) and gate (1.5 MB), 199.6 MB in all, about 60 us at 3.35 TB/s;
// its 24.2 GFLOP take about 24 us at the bf16 tensor-core rate, so the call is
// bound by bytes. At EAT's shape (B=128, H=12, T=513, D=64, bf16, bias-free)
// it moves 4 x 100.9 MB, about 120 us, against 103.5 GFLOP, about 105 us:
// bound by bytes, narrowly. The products here run on the fp32 FMA units, not
// the tensor cores (a later change: wgmma on TMA-fed K/V tiles), so this
// simple kernel is held back by its FMA instruction rate instead.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr size_t kSmemBytes =
    sizeof(float) * (kHeadDim * kBlockQ + kHeadDim * kBlockK + kBlockK * kHeadDim + kBlockK * kBlockQ);

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

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// P is rounded to v's type before PV.
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const float* __restrict__ gate,
                 const uint8_t* __restrict__ pad, T* __restrict__ out, int seq, float scale,
                 Strides s) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                            // [D][BQ]  q transposed
  float* k_t = q_t + kHeadDim * kBlockQ;        // [D][BK]  k tile transposed
  float* v_s = k_t + kHeadDim * kBlockK;        // [BK][D]  v tile
  float* p_t = v_s + kBlockK * kHeadDim;        // [BK][BQ] probabilities transposed

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 7;   // keys tx*8..tx*8+7 (logits), dims tx*8..tx*8+7 (output)
  const int ty = tid >> 3;  // query rows ty*4..ty*4+3; the 8 lanes of a row group share a warp

  const T* qb = q + b * s.q[0] + h * s.q[1];
  const T* kb = k + b * s.k[0] + h * s.k[1];
  const T* vb = v + b * s.v[0] + h * s.v[1];
  T* ob = out + b * s.o[0] + h * s.o[1];
  const float* bias_h = kGated ? bias + h * s.bias[0] : nullptr;
  const uint8_t* pad_b = pad ? pad + b * s.pad[0] : nullptr;

  // Q tile, transposed into shared memory; rows past the sequence are zero.
  for (int c = tid; c < kBlockQ * (kHeadDim / 8); c += kThreads) {
    const int r = c % kBlockQ;
    const int chunk = c / kBlockQ;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < seq) load8(qb + (long long)(q0 + r) * s.q[2] + chunk * 8, x);
#pragma unroll
    for (int j = 0; j < 8; ++j) q_t[(chunk * 8 + j) * kBlockQ + r] = x[j];
  }

  float g[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    row_ok[i] = qi < seq;
    g[i] = 1.f;
    if (kGated && gate && row_ok[i]) g[i] = gate[b * s.gate[0] + h * s.gate[1] + qi * s.gate[2]];
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers of k_t, v_s and p_t are done
    for (int c = tid; c < kBlockK * (kHeadDim / 8); c += kThreads) {
      const int r = c % kBlockK;
      const int chunk = c / kBlockK;
      float kx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + r < seq) {
        load8(kb + (long long)(k0 + r) * s.k[2] + chunk * 8, kx);
        load8(vb + (long long)(k0 + r) * s.v[2] + chunk * 8, vx);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) k_t[(chunk * 8 + j) * kBlockK + r] = kx[j];
      store8(v_s + r * kHeadDim + chunk * 8, vx);
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(q_t + d * kBlockQ + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(k_t + d * kBlockK + tx * 8);
      const float4 kc = *reinterpret_cast<const float4*>(k_t + d * kBlockK + tx * 8 + 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
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
        p_t[(tx * 8 + j) * kBlockQ + ty * 4 + i] = round_like(p, q);
      }
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 4);
      l[i] = l[i] * corr + tile_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(p_t + c * kBlockQ + ty * 4);
      const float4 va = *reinterpret_cast<const float4*>(v_s + c * kHeadDim + tx * 8);
      const float4 vc = *reinterpret_cast<const float4*>(v_s + c * kHeadDim + tx * 8 + 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float vv[8] = {va.x, va.y, va.z, va.w, vc.x, vc.y, vc.z, vc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const int qi = q0 + ty * 4 + i;
    const float inv = 1.f / l[i];  // a fully padded row gives 0/0 = NaN, as the softmax does
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = acc[i][j] * inv;
    store8(ob + (long long)qi * s.o[2] + tx * 8, y);
  }
}

template <typename T, bool kGated>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, const void* gate,
                   const void* pad, void* out, int batch, int heads, int seq, float scale,
                   const Strides& s, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, kGated>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  attention_kernel<T, kGated><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(gate),
      static_cast<const uint8_t*>(pad), static_cast<T*>(out), seq, scale, s);
  return cudaGetLastError();
}

template <bool kGated>
int dispatch(int dtype, const void* q, const void* k, const void* v, const void* bias,
             const void* gate, const void* pad, void* out, int batch, int heads, int seq,
             int head_dim, float scale, const Strides& s, void* stream) {
  if (head_dim != kHeadDim || seq <= 0 || batch <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, kGated>(q, k, v, bias, gate, pad, out, batch, heads, seq, scale, s, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, kGated>(q, k, v, bias, gate, pad, out, batch, heads, seq,
                                              scale, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); bias and gate
// are float32, pad is one byte per key (nonzero = padded); gate and pad may be
// null. strides: 22 element strides in the order of struct Strides. Returns a
// cudaError_t; 0 means the kernel was launched.
extern "C" int avex_gated_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                            const void* bias, const void* gate, const void* pad,
                                            void* out, int batch, int heads, int seq, int head_dim,
                                            float scale, const long long* strides, void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(Strides));
  return dispatch<true>(dtype, q, k, v, bias, gate, pad, out, batch, heads, seq, head_dim, scale,
                        s, stream);
}

// The bias-free variant. dtype and pad as above; pad may be null. strides: 14
// element strides, q, k, v and out (batch, head, token) then pad (batch, token).
extern "C" int avex_plain_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                            const void* pad, void* out, int batch, int heads,
                                            int seq, int head_dim, float scale,
                                            const long long* strides, void* stream) {
  Strides s;
  memset(&s, 0, sizeof(Strides));
  memcpy(s.q, strides, 3 * sizeof(long long));
  memcpy(s.k, strides + 3, 3 * sizeof(long long));
  memcpy(s.v, strides + 6, 3 * sizeof(long long));
  memcpy(s.o, strides + 9, 3 * sizeof(long long));
  memcpy(s.pad, strides + 12, 2 * sizeof(long long));
  return dispatch<false>(dtype, q, k, v, nullptr, nullptr, pad, out, batch, heads, seq, head_dim,
                         scale, s, stream);
}
