// Int8 (W8A8) dense for Hopper (sm_90a), plain C ABI. Two Pallas TPU kernels
// of the JAX package:
//
//   - _dyn_kernel  avex_tpu/ops/pallas_int8.py:100 (launched :177), K7: per-row
//     dynamic quantization of a float x, s8 x s8 -> s32 on the tensor cores,
//     then out = (float)acc * (row_scale * col_scale) (+ bias), cast to out's
//     type. Two launches: avex_int8_quantize_rows, then
//     avex_int8_scaled_product;
//   - _mm_kernel   avex_tpu/ops/pallas_int8.py:46 (launched :79), K8, through
//     avex_int8_matmul: the raw s8[M,K] x s8[K,N] -> s32[M,N], exact.
//
// K7, step 1: the row quantization, once. One warp a row reads the row into
// registers (up to 3,072 values; a longer row's rest is read again) for its
// absmax, then quantizes it: row_scale = max(amax, 1e-8) / 127, an IEEE
// division, round-half-even (rintf) and a clip to +-127, as the plain twin
// does, so the int8 activations equal the twin's exactly. It writes xq int8 [M, K] and row_scale fp32 [M] into scratch the
// wrapper allocates. The TPU kernel (and this port's first K7) redid that
// work for every 128-wide tile of N: 24 times over at fc1.
//
// K7, step 2: the s8 product on wgmma (wgmma.mma_async m64n128k32
// .s32.s8.s8), both operands K-major as 8-bit wgmma takes them: xq [M, K]
// and the weight in torch's Linear layout [N, K]. A block of two warpgroups
// owns a 128 x 128 output tile; each warpgroup 64 rows, its int32 sums in
// registers (64 a thread). TMA feeds 128 x 128-byte tiles of xq and of the
// weight, with the 128-byte swizzle that the wgmma descriptors name, into a
// ring of kStages stages in shared memory; an mbarrier a stage counts the
// bytes in, another counts the two warpgroups out. One thread keeps the ring
// full: after a stage's products retire (wgmma.wait_group 1 leaves the next
// stage's in flight) it refills that stage with the tile kStages further on.
// Ragged M and N read zeros past the edge (TMA's out-of-bounds fill) and are
// masked at the store; a K tail shorter than a stage is zero-filled the same
// way and its 32-deep steps are skipped. Two blocks fit on an SM (96 KB of
// shared memory, at most 128 registers a thread), so one block's epilogue
// runs beside the other's products. The epilogue multiplies, then adds, with
// explicit round-to-nearest intrinsics in the twin's order, so that nvcc
// cannot contract it into an fma and the fp32 output equals the twin's to the
// bit; it stages the tile in the freed stages and writes whole rows in
// 16-byte runs.
//
// K8 keeps mma.sync: one block of 256 threads (8 warps, 2 x 4) owns a 128 x
// 128 output tile and walks K in tiles of 64; each warp owns 64 x 32 outputs
// as 4 x 4 mma.sync.m16n8k32 s8 tiles. A and B tiles are staged in shared
// memory with an 80-byte row pitch, free of bank conflicts; the next K tile
// is loaded into registers while the current one is in the tensor cores. It
// takes B in JAX's [K, N] layout, which 8-bit wgmma refuses, and transposes
// 4 x 16 byte blocks in registers (byte permutes) while staging them.
// K must be a multiple of 32 (16-byte rows).
//
// Bound on an H100 at BEATs' fc1 (M = 31,744 rows at B=128, K = 768, N = 3072,
// bf16 x and out): the call must read 48.8 MB of x and 2.4 MB of weights and
// write 195 MB, about 0.073 ms at 3.35 TB/s, and do 150 GOP, about 0.076 ms at
// 1,979 int8 TOP/s: bound by operations, narrowly. The quantization pass adds
// xq's write and read (24.4 MB each) to the bytes.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched through the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 16 values of one chunk of x (sizeof(T) 16-byte words) as floats.
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

// ---------------------------------------------------------------------------
// K7, step 1: row quantization
// ---------------------------------------------------------------------------

constexpr int kQuantRows = 8;  // rows (warps) a block
constexpr int kQuantCache = 6;  // chunks of 16 values a lane keeps in registers: K <= 3,072 is read once

template <typename TX>
__global__ void __launch_bounds__(32 * kQuantRows)
quantize_rows_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ row_scale, int M,
                     int K) {
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  constexpr int kWords = sizeof(TX);  // 16-byte words in a chunk of 16 values
  const int chunks = K / 16;
  const uint4* src = reinterpret_cast<const uint4*>(x + (long long)row * K);
  uint4* dst = reinterpret_cast<uint4*>(xq + (long long)row * K);
  // The lane's first kQuantCache chunks (lane, lane + 32, ...) stay in
  // registers between the absmax and the quantization; a longer row's
  // further chunks are read again (from L1 or L2).
  uint4 cache[kQuantCache][kWords];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kQuantCache; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        cache[i][w] = __ldg(src + c * kWords + w);
        amax = absmax16<TX>(cache[i][w], amax);
      }
    }
  }
  for (int c = lane + 32 * kQuantCache; c < chunks; c += 32)
#pragma unroll
    for (int w = 0; w < kWords; ++w) amax = absmax16<TX>(__ldg(src + c * kWords + w), amax);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(fmaxf(amax, kEps), 127.f);
  if (lane == 0) row_scale[row] = scale;
  auto quantize = [&](const uint4 (&raw)[kWords], int c) {
    float f[16];
    chunk_to_float<TX>(raw, f);
    dst[c] = make_uint4(quant4(f, scale), quant4(f + 4, scale), quant4(f + 8, scale), quant4(f + 12, scale));
  };
#pragma unroll
  for (int i = 0; i < kQuantCache; ++i)
    if (lane + 32 * i < chunks) quantize(cache[i], lane + 32 * i);
  for (int c = lane + 32 * kQuantCache; c < chunks; c += 32) {
    uint4 raw[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) raw[w] = __ldg(src + c * kWords + w);
    quantize(raw, c);
  }
}

// ---------------------------------------------------------------------------
// K7, step 2: the scaled s8 product on wgmma, TMA-fed
// ---------------------------------------------------------------------------

constexpr int kPBM = 128;      // rows of xq a block (two warpgroups of 64)
constexpr int kPBN = 128;      // output columns a block
constexpr int kPBK = 128;      // bytes of K a stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kPThreads = 256;
constexpr uint32_t kXTileBytes = kPBM * kPBK, kWTileBytes = kPBN * kPBK;
constexpr uint32_t kStageBytes = kXTileBytes + kWTileBytes;
constexpr size_t kProductSmem = kStages * (size_t)kStageBytes + 2 * kStages * sizeof(uint64_t) + 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Until the barrier's phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  }
}

// A box of the 2-D tensor map at (c0 along K in bytes, c1 along rows) into
// shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: start address, leading byte offset (unused for this layout), 1024
// bytes between groups of 8 rows, layout type 1 (128B).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Keeps the compiler from moving the accumulators across an asynchronous
// wgmma: they are written by the tensor cores until the wait.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] (+)= a[64 x 32] · b[128 x 32]ᵀ, s8 in, s32 accumulate; d is zeroed
// first unless `accumulate`.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

template <typename TO>
__global__ void __launch_bounds__(kPThreads, 2)
scaled_product_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                      const float* __restrict__ row_scale, const float* __restrict__ col_scale,
                      const float* __restrict__ bias, TO* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: stage tiles start on such a boundary.
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                                                 // [kStages][128][128 B]
  unsigned char* ws = xs + kStages * kXTileBytes;                           // [kStages][128][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kStages * kWTileBytes);  // [kStages] bytes in
  uint64_t* empty = full + kStages;                                         // [kStages] warpgroups out

  const int n0 = blockIdx.x * kPBN, m0 = blockIdx.y * kPBM;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n_k = (K + kPBK - 1) / kPBK;

  auto refill = [&](int stage, int kt) {
    mbar_expect_tx(&full[stage], kStageBytes);
    tma_load(xs + stage * kXTileBytes, &map_x, &full[stage], kt * kPBK, m0);
    tma_load(ws + stage * kWTileBytes, &map_w, &full[stage], kt * kPBK, n0);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages && s < n_k; ++s) refill(s, s);

  int acc[64];
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    __syncwarp();  // wgmma is .sync.aligned: the warp leaves the wait together
    const unsigned char* xa = xs + s * kXTileBytes + wg * 64 * kPBK;
    const unsigned char* wb = ws + s * kWTileBytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kPBK / 32; ++kk)
      if (kt * kPBK + kk * 32 < K) wgmma_s8(acc, smem_desc(xa + kk * 32), smem_desc(wb + kk * 32), kt > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    wgmma_wait<1>();  // the previous stage's products have retired
    fence_acc(acc);
    if (kt > 0) {
      const int ps = (kt - 1) % kStages, next = kt - 1 + kStages;
      if ((tid & 127) == 0) mbar_arrive(&empty[ps]);
      if (tid == 0 && next < n_k) {
        mbar_wait(&empty[ps], ((kt - 1) / kStages) & 1);
        refill(ps, next);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();  // both warpgroups are done with the stages: the epilogue reuses them

  // Epilogue: thread (warp w of the warpgroup, lane g·4 + t) holds rows
  // 16w + g (+8) and columns 8j + 2t (+1) of its warpgroup's 64 x 128 tile:
  // acc[4j + 2h + e] at row +8h, column +e. The dequantized tile is staged in
  // shared memory (rows padded by 16 bytes: the pairs' stores hit 32 banks)
  // and written back as 16-byte runs of whole rows.
  constexpr int kPitch = kPBN * (int)sizeof(TO) + 16;  // bytes a staged row
  static_assert(kPBM * kPitch <= kStages * (int)kStageBytes, "the staged tile fits in the stages");
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const float rs = m0 + r < M ? __ldg(row_scale + m0 + r) : 0.f;
#pragma unroll
    for (int j = 0; j < kPBN / 8; ++j) {
      const int c = 8 * j + 2 * t, n = n0 + c;
      const float y0 = n < N ? dequant(acc[4 * j + 2 * h], rs, col_scale, bias, n) : 0.f;
      const float y1 = n + 1 < N ? dequant(acc[4 * j + 2 * h + 1], rs, col_scale, bias, n + 1) : 0.f;
      store_pair(reinterpret_cast<TO*>(smem + r * kPitch) + c, y0, y1, true, true);
    }
  }
  __syncthreads();
  constexpr int kRowChunks = kPBN * (int)sizeof(TO) / 16;  // 16-byte runs a tile row
  constexpr int kPerChunk = 16 / (int)sizeof(TO);
  if ((N % kPerChunk) == 0) {  // every run of a row starts 16-byte aligned
    for (int i = tid; i < kPBM * kRowChunks; i += kPThreads) {
      const int r = i / kRowChunks, c = (i % kRowChunks) * kPerChunk;
      if (m0 + r < M && n0 + c < N)
        *reinterpret_cast<uint4*>(out + (long long)(m0 + r) * N + n0 + c) =
            *reinterpret_cast<const uint4*>(smem + r * kPitch + c * (int)sizeof(TO));
    }
  } else {
    for (int i = tid; i < kPBM * kPBN; i += kPThreads) {
      const int r = i / kPBN, c = i % kPBN;
      if (m0 + r < M && n0 + c < N)
        out[(long long)(m0 + r) * N + n0 + c] = reinterpret_cast<const TO*>(smem + r * kPitch)[c];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major int8 [rows, K] operand, in boxes of
// 128 rows x 128 bytes with the 128-byte swizzle; zeros past the edges.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int K) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kPBK, (cuuint32_t)kPBM};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO>
int launch_product(const void* xq, const void* row_scale, const void* weight_q, const void* col_scale,
                   const void* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  static_assert(kPBM == kPBN, "one box shape serves both operands");
  CUtensorMap map_x, map_w;
  if (!tensor_map(&map_x, xq, M, K) || !tensor_map(&map_w, weight_q, N, K)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(scaled_product_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kProductSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kPBN - 1) / kPBN, (M + kPBM - 1) / kPBM);
  scaled_product_kernel<TO><<<grid, kPThreads, kProductSmem, stream>>>(
      map_x, map_w, static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8: the raw s8 product on mma.sync
// ---------------------------------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPitch = kBK + 16;  // bytes per staged row

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B as [K, N]: A is staged as 2 chunks of 16 bytes a thread (row = chunk / 4,
// 16 columns at (chunk % 4) * 16); threads 0-127 each take 4 K rows x 16
// columns of B and transpose them into [N][K] rows.
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, int* __restrict__ out, int M, int N,
                   int K) {
  __shared__ __align__(16) int8_t s_a[kBM * kPitch];
  __shared__ __align__(16) int8_t s_b[kBN * kPitch];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma fragment row group
  const int t = lane & 3;   // and thread within it
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  // Register staging of the next K tile.
  uint4 ra[2];
  uint4 rb[4];

  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int m = m0 + (c >> 2);
      const int k = k0 + (c & 3) * 16;
      const bool ok = m < M && k < K;
      ra[i] = ok ? __ldg(reinterpret_cast<const uint4*>(a + (long long)m * K + k)) : make_uint4(0, 0, 0, 0);
    }
    const int kg = tid >> 3;
    const int n = n0 + (tid & 7) * 16;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + kg * 4 + r;
      const bool ok = tid < 128 && k < K && n < N;
      rb[r] = ok ? __ldg(reinterpret_cast<const uint4*>(b + (long long)k * N + n)) : make_uint4(0, 0, 0, 0);
    }
  };

  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(s_a + (c >> 2) * kPitch + (c & 3) * 16) = ra[i];
    }
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
    __syncthreads();  // the previous tile's readers are done
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
      const int m = m0 + wm + mt * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + nt * 8 + t * 2;  // even
        if (n >= N) continue;
        store_pair(out + (long long)m * N + n, acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1], n + 1 < N, even_n);
      }
    }
  }
}

bool bad_shape(int M, int N, int K) {
  return M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || (M + kBM - 1) / kBM > 65535;
}

}  // namespace

// K7, step 1. x_dtype: 0 = float32, 1 = bfloat16. x [M, K] row-major; writes
// xq int8 [M, K] and row_scale float32 [M]; every pointer 16-byte aligned.
// Returns a cudaError_t; 0 means the kernel was launched.
extern "C" int avex_int8_quantize_rows(int x_dtype, const void* x, void* xq, void* row_scale, int M, int K,
                                       void* stream) {
  if (bad_shape(M, 1, K)) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kQuantRows - 1) / kQuantRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    quantize_rows_kernel<float><<<grid, 32 * kQuantRows, 0, st>>>(static_cast<const float*>(x),
                                                                 static_cast<int8_t*>(xq),
                                                                 static_cast<float*>(row_scale), M, K);
  else if (x_dtype == 1)
    quantize_rows_kernel<__nv_bfloat16><<<grid, 32 * kQuantRows, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(row_scale), M, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K7, step 2. out_dtype: 0 = float32, 1 = bfloat16. xq int8 [M, K] and
// row_scale float32 [M] from step 1, weight_q int8 [N, K], weight_scale
// float32 [N], bias float32 [N] or null, out [M, N]; all row-major, every
// pointer 16-byte aligned. Returns a cudaError_t; 0 means the kernel was
// launched.
extern "C" int avex_int8_scaled_product(int out_dtype, const void* xq, const void* row_scale, const void* weight_q,
                                        const void* weight_scale, const void* bias, void* out, int M, int N, int K,
                                        void* stream) {
  if (bad_shape(M, N, K) || (N + kPBN - 1) / kPBN > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch_product<float>(xq, row_scale, weight_q, weight_scale, bias, out, M, N, K, st);
  if (out_dtype == 1)
    return launch_product<__nv_bfloat16>(xq, row_scale, weight_q, weight_scale, bias, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

// K8. xq int8 [M, K], wq int8 [K, N] (N a multiple of 16), out int32 [M, N],
// all row-major and 16-byte aligned. Returns a cudaError_t as above.
extern "C" int avex_int8_matmul(const void* xq, const void* wq, void* out, int M, int N, int K, void* stream) {
  if (bad_shape(M, N, K) || N % 16 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq), static_cast<int*>(out), M, N, K);
  return (int)cudaGetLastError();
}
