// Int8 (W8A8) dense for Hopper (sm_90a), plain C ABI. One templated body
// serves two Pallas TPU kernels of the JAX package:
//
//   - _dyn_kernel  avex_tpu/ops/pallas_int8.py:100 (launched :177), through
//     avex_int8_dynamic_dense: per-row dynamic quantization of a float x,
//     s8 x s8 -> s32 on the tensor cores, then
//     out = (float)acc * (row_scale * col_scale) (+ bias), cast to out's type;
//   - _mm_kernel   avex_tpu/ops/pallas_int8.py:46 (launched :79), through
//     avex_int8_matmul: the raw s8[M,K] x s8[K,N] -> s32[M,N], exact.
//
// Design. One block of 256 threads (8 warps, 2 x 4) owns a 128 x 128 output
// tile and walks K in tiles of 64. Each warp owns 64 x 32 outputs as 4 x 4
// mma.sync.m16n8k32 s8 tiles with int32 accumulators in registers. A and B
// tiles are staged in shared memory as int8 with an 80-byte row pitch, which
// keeps the 32-bit fragment loads free of bank conflicts. The next K tile is
// loaded from device memory into registers while the current one is in the
// tensor cores (no cp.async or TMA yet).
//
// The dynamic variant (K7) first reads its 128 rows of x over the whole K for
// the row absmax (one warp per 16 rows), keeps row_scale = max(amax, 1e-8) /
// 127 in shared memory, and quantizes each x tile as it stages it: an IEEE
// division, round-half-even (rintf) and a clip to +-127, as the plain twin
// does, so the int8 activations and the int32 sums equal the twin's exactly.
// Like the TPU kernel, it recomputes the row quantization for every N tile.
// The epilogue multiplies, then adds, with explicit round-to-nearest
// intrinsics in the twin's order, so that nvcc cannot contract it into an fma
// and the fp32 output equals the twin's to the bit.
//
// K8 takes its B operand in JAX's [K, N] layout and transposes 4 x 16 byte
// blocks in registers (byte permutes) while staging them; K7 takes the
// weight in torch's Linear layout [N, K], K-contiguous, as mma's col-major B.
// Ragged M and N are masked; K must be a multiple of 32 (16-byte loads).
//
// Bound on an H100 at BEATs' fc1 (M = 31,744 rows at B=128, K = 768, N = 3072,
// bf16 x and out): the call must read 48.8 MB of x and 2.4 MB of weights and
// write 195 MB, about 0.073 ms at 3.35 TB/s, and do 150 GOP, about 0.076 ms at
// 1,979 int8 TOP/s: bound by operations, narrowly. mma.sync without a
// pipelined TMA feed and warpgroup mma (wgmma) reaches a fraction of that
// rate; a later change makes it fast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPitch = kBK + 16;  // bytes per staged row
constexpr float kEps = 1e-8f;

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The 16 values of one staged chunk (sizeof(T) 16-byte words) as floats.
template <typename T>
__device__ __forceinline__ void chunk_to_float(const uint4 (&raw)[sizeof(T)], float (&f)[16]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j) f[j] = __uint_as_float(word(raw[j / 4], j % 4));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t w = word(raw[j / 4], j % 4);
      f[2 * j] = bf16_lo(w);
      f[2 * j + 1] = bf16_hi(w);
    }
  }
}

// max |v| over one 16-byte word of x.
template <typename T>
__device__ __forceinline__ float absmax16(const uint4& v, float m) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = word(v, i);
    if constexpr (sizeof(T) == 4) {
      m = fmaxf(m, fabsf(__uint_as_float(w)));
    } else {
      m = fmaxf(m, fabsf(bf16_lo(w)));
      m = fmaxf(m, fabsf(bf16_hi(w)));
    }
  }
  return m;
}

__device__ __forceinline__ uint32_t quant4(const float* f, float scale) {
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = rintf(__fdiv_rn(f[i], scale));  // round half to even, as torch.round
    q = fminf(fmaxf(q, -127.f), 127.f);
    packed |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * i);
  }
  return packed;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two neighbouring outputs (p[1] only when `second`), as one vector store when
// both exist and p is aligned for it (`vec`: N is even and the column even).
__device__ __forceinline__ void store_pair(float* p, float a, float b, bool second, bool vec) {
  if (second && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (second) p[1] = b;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b, bool second, bool vec) {
  if (second && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (second) p[1] = __float2bfloat16_rn(b);
  }
}
__device__ __forceinline__ void store_pair(int* p, int a, int b, bool second, bool vec) {
  if (second && vec) {
    *reinterpret_cast<int2*>(p) = make_int2(a, b);
  } else {
    p[0] = a;
    if (second) p[1] = b;
  }
}

// The twin's order: (float)acc * (row_scale * col_scale) + bias, each step
// rounded on its own (no fma contraction).
__device__ __forceinline__ float dequant(int acc, float row_scale, const float* __restrict__ col_scale,
                                         const float* __restrict__ bias, int n) {
  const float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(row_scale, __ldg(col_scale + n)));
  return bias != nullptr ? __fadd_rn(y, __ldg(bias + n)) : y;
}

// TA: the A operand's type (int8_t for K8; float or bf16 for K7, quantized in
// the kernel). TO: the output's type. kBKN: B is [K, N] (K8) instead of [N, K].
template <typename TA, typename TO, bool kDynamic, bool kBKN>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const TA* __restrict__ a, const int8_t* __restrict__ b,
                 const float* __restrict__ col_scale, const float* __restrict__ bias,
                 TO* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t s_a[kBM * kPitch];
  __shared__ __align__(16) int8_t s_b[kBN * kPitch];
  __shared__ float s_row_scale[kBM];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma fragment row group
  const int t = lane & 3;   // and thread within it
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  if constexpr (kDynamic) {
    // Row absmax over the whole K: one warp per 16 rows of the block.
    const int words = K * (int)sizeof(TA) / 16;
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      float amax = 0.f;
      if (m0 + r < M) {
        const uint4* row = reinterpret_cast<const uint4*>(a + (long long)(m0 + r) * K);
        for (int v = lane; v < words; v += 32) amax = absmax16<TA>(__ldg(row + v), amax);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      if (lane == 0) s_row_scale[r] = __fdiv_rn(fmaxf(amax, kEps), 127.f);
    }
  }

  // Register staging of the next K tile. A: 2 chunks of 16 values a thread
  // (row = chunk / 4, 16 columns at (chunk % 4) * 16). B as [N, K]: the same
  // split over 128 rows of N; B as [K, N]: threads 0-127 each take 4 K rows x
  // 16 columns of N.
  constexpr int kBWords = kBKN ? 4 : 2;
  uint4 ra[2][sizeof(TA)];
  uint4 rb[kBWords];

  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int m = m0 + (c >> 2);
      const int k = k0 + (c & 3) * 16;
      const bool ok = m < M && k < K;
      const uint4* p = reinterpret_cast<const uint4*>(a + (long long)m * K + k);
#pragma unroll
      for (int j = 0; j < (int)sizeof(TA); ++j) ra[i][j] = ok ? __ldg(p + j) : make_uint4(0, 0, 0, 0);
    }
    if constexpr (kBKN) {
      const int kg = tid >> 3;
      const int n = n0 + (tid & 7) * 16;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + kg * 4 + r;
        const bool ok = tid < 128 && k < K && n < N;
        rb[r] = ok ? __ldg(reinterpret_cast<const uint4*>(b + (long long)k * N + n)) : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kThreads;
        const int n = n0 + (c >> 2);
        const int k = k0 + (c & 3) * 16;
        rb[i] = (n < N && k < K) ? __ldg(reinterpret_cast<const uint4*>(b + (long long)n * K + k))
                                 : make_uint4(0, 0, 0, 0);
      }
    }
  };

  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2;
      uint4* dst = reinterpret_cast<uint4*>(s_a + row * kPitch + (c & 3) * 16);
      if constexpr (kDynamic) {
        float f[16];
        chunk_to_float<TA>(ra[i], f);
        const float scale = s_row_scale[row];
        *dst = make_uint4(quant4(f, scale), quant4(f + 4, scale), quant4(f + 8, scale), quant4(f + 12, scale));
      } else {
        *dst = ra[i][0];
      }
    }
    if constexpr (kBKN) {
      if (tid < 128) {
        const int kg = tid >> 3;
        const int nc = (tid & 7) * 16;
        // 4 rows of K x 16 columns of N -> 16 words, one per column, holding
        // its 4 K values in order (a 4 x 4 byte transpose per word).
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const uint32_t r0 = word(rb[0], w), r1 = word(rb[1], w), r2 = word(rb[2], w), r3 = word(rb[3], w);
          const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
          const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
          const uint32_t cols[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                                    __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<uint32_t*>(s_b + (nc + 4 * w + j) * kPitch + kg * 4) = cols[j];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kThreads;
        *reinterpret_cast<uint4*>(s_b + (c >> 2) * kPitch + (c & 3) * 16) = rb[i];
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done; row scales are written
    store_tiles();
    __syncthreads();
    if (k0 + kBK < K) load_tiles(k0 + kBK);  // in flight during the products below
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* p = s_a + (wm + mt * 16 + g) * kPitch + kk + t * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* p = s_b + (wn + nt * 8 + g) * kPitch + kk + t * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }

  // Epilogue: accumulator (mt, nt, v) sits at row g (+8 for v >= 2) and
  // column t*2 + (v & 1) of its 16 x 8 tile.
  const bool even_n = (N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm + mt * 16 + g + half * 8;
      const int m = m0 + row;
      if (m >= M) continue;
      float row_scale = 1.f;
      if constexpr (kDynamic) row_scale = s_row_scale[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + nt * 8 + t * 2;  // even
        if (n >= N) continue;
        const bool second = n + 1 < N;
        TO* dst = out + (long long)m * N + n;
        const int v0 = acc[mt][nt][half * 2];
        const int v1 = acc[mt][nt][half * 2 + 1];
        if constexpr (kDynamic) {
          const float y0 = dequant(v0, row_scale, col_scale, bias, n);
          const float y1 = second ? dequant(v1, row_scale, col_scale, bias, n + 1) : 0.f;
          store_pair(dst, y0, y1, second, even_n);
        } else {
          store_pair(dst, v0, v1, second, even_n);
        }
      }
    }
  }
}

template <typename TA, typename TO, bool kDynamic, bool kBKN>
int launch(const void* a, const void* b, const void* col_scale, const void* bias, void* out, int M, int N,
           int K, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<TA, TO, kDynamic, kBKN><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TA*>(a), static_cast<const int8_t*>(b), static_cast<const float*>(col_scale),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, N, K);
  return (int)cudaGetLastError();
}

bool bad_shape(int M, int N, int K) {
  return M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || (M + kBM - 1) / kBM > 65535;
}

}  // namespace

// K7. x_dtype / out_dtype: 0 = float32, 1 = bfloat16. x [M, K] row-major,
// weight_q int8 [N, K] row-major, weight_scale float32 [N], bias float32 [N]
// or null, out [M, N] row-major; every pointer 16-byte aligned. Returns a
// cudaError_t; 0 means the kernel was launched.
extern "C" int avex_int8_dynamic_dense(int x_dtype, int out_dtype, const void* x, const void* weight_q,
                                       const void* weight_scale, const void* bias, void* out, int M, int N,
                                       int K, void* stream) {
  if (bad_shape(M, N, K)) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float, true, false>(x, weight_q, weight_scale, bias, out, M, N, K, stream);
  if (x_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16, true, false>(x, weight_q, weight_scale, bias, out, M, N, K, stream);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float, true, false>(x, weight_q, weight_scale, bias, out, M, N, K, stream);
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, true, false>(x, weight_q, weight_scale, bias, out, M, N, K,
                                                             stream);
  return (int)cudaErrorInvalidValue;
}

// K8. xq int8 [M, K], wq int8 [K, N] (N a multiple of 16), out int32 [M, N],
// all row-major and 16-byte aligned. Returns a cudaError_t as above.
extern "C" int avex_int8_matmul(const void* xq, const void* wq, void* out, int M, int N, int K, void* stream) {
  if (bad_shape(M, N, K) || N % 16 != 0) return (int)cudaErrorInvalidValue;
  return launch<int8_t, int, false, true>(xq, wq, nullptr, nullptr, out, M, N, K, stream);
}
