// Fused bucketed quantize -> bit-pack (K1) and bit-unpack -> dequantize (K2)
// for Hopper (sm_90a), and their unpacked one-byte-per-code forms (K4, K5).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   K1  src/repro/kernels/quantize.py  quantize_pack_pallas      (body _quantize_pack_kernel)
//   K2  src/repro/kernels/quantize.py  unpack_dequantize_pallas  (body _unpack_dequantize_kernel)
//   K4  src/repro/kernels/quantize.py  quantize_pallas           (body _quantize_kernel)
//   K5  src/repro/kernels/quantize.py  dequantize_pallas         (body _dequantize_kernel)
// K4 and K5 compute K1's and K2's functions at 8 bits -- one code per byte,
// any levels in 1..255, nearest or stochastic rounding -- so they launch the
// same device code with k = 1 through entry points of their own.
//
// Wire format (identical to the JAX package, byte for byte):
//   codes u8 (nb, bucket*bits/8) when 8 % bits == 0, else one byte per code;
//         byte j of a bucket holds codes j*k .. j*k+k-1 (k = 8/bits), code
//         j*k+i in bits [i*bits, (i+1)*bits) -- little-endian in the byte;
//   scale f32 (nb)  per-bucket step  max((hi-lo) * (1/levels), 1e-12);
//   zero  f32 (nb)  per-bucket offset (lo, plus r*scale for shift rounding).
//
// Bound on the H100 (gpt-1.3b, bucket 1024).  K1 moves ~5 B/value: 4 B of
// f32 read, 1 B of codes written at W8 (+8 B per bucket of scale/zero).  In
// shift and nearest mode that is its bound (0.154 ms at the 1.03e8-value
// embedding at 3.35 TB/s).  In stochastic mode it also hashes one
// threefry-2x32 block per value: 20 rounds of add/rotate/xor plus five key
// injections, ~75 32-bit integer operations, which at the card's 64 INT32
// lanes per SM per clock is ~0.45 ms at the embedding -- there the integer
// rate bounds it.  K2 reads 1 B/value and writes 4 B/value.
//
// K1's design.  The TPU kernel takes its randomness as an input array that
// XLA draws upstream; copied as is, that is an (nb, bucket) f32 array of
// thresholds drawn by ~170 int64 tensor operations per value and read back
// at 4 B/value.  K1 instead takes the key (two u32 words) and computes the
// same threefry bits as jax.random in its own threads, at the counter
// jax.random gives value j of bucket b (b*bucket + j in stochastic mode, b
// in shift mode; hi word 0, bits = x0 ^ x1), so the bytes stay equal to the
// JAX package's.  One warp owns one bucket: for buckets of 128..1024 values
// (a multiple of 128) each lane issues all of its float4 loads of the bucket
// at once and keeps the values in registers, min/max by shuffle, codes built
// from registers, and the codes of 1..8 neighbouring lanes joined by shuffle
// into whole 32-bit words, one store per word.  Other buckets take a generic
// one-warp loop (two passes over the bucket, the second through L1).  K2
// writes 16-byte vectors.  K4 runs K1's device code with its thresholds
// read from an array (the TPU kernel's interface), K5 runs K2's.
//
// Numerics: every operation is an explicitly rounded intrinsic so nvcc can
// neither contract nor reassociate: IEEE division (__fdiv_rn), half-even
// rounding (rintf), and a fused multiply-add exactly where XLA contracts
// one in the reference (shift-mode zero = lo + r*scale, decode c*scale+zero).
// Built without --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kNearest = 0, kStochastic = 1, kShift = 2 };

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Threefry-2x32, 20 rounds, at (hi, lo) = (0, count) under key (k0, k1):
// x0 ^ x1, the 32 bits jax.random's partitionable random_bits gives the
// flat index `count` (core/prng.py: _threefry2x32, bits_at).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t count) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0, x1 = count + k1;
#define QSDP_ROUND(r) x0 += x1; x1 = __funnelshift_l(x1, x1, r) ^ x0;
  QSDP_ROUND(13) QSDP_ROUND(15) QSDP_ROUND(26) QSDP_ROUND(6)  x0 += k1; x1 += k2 + 1u;
  QSDP_ROUND(17) QSDP_ROUND(29) QSDP_ROUND(16) QSDP_ROUND(24) x0 += k2; x1 += k0 + 2u;
  QSDP_ROUND(13) QSDP_ROUND(15) QSDP_ROUND(26) QSDP_ROUND(6)  x0 += k0; x1 += k1 + 3u;
  QSDP_ROUND(17) QSDP_ROUND(29) QSDP_ROUND(16) QSDP_ROUND(24) x0 += k1; x1 += k2 + 4u;
  QSDP_ROUND(13) QSDP_ROUND(15) QSDP_ROUND(26) QSDP_ROUND(6)  x0 += k2; x1 += k0 + 5u;
#undef QSDP_ROUND
  return x0 ^ x1;
}

// u32 bits -> f32 in [0, 1) as jax.random.uniform: mantissa fill of 1.0, minus 1.
__device__ __forceinline__ float unit_float(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.f);
}

// K1's randomness: drawn from the key in the kernel.
struct KeyRand {
  uint32_t k0, k1;
  int rand16;  // stochastic thresholds as the low 16 bits (compared to frac * 65536)
  __device__ __forceinline__ float threshold(long long b, int bucket, int j) const {
    const uint32_t bits = threefry_bits(k0, k1, (uint32_t)(b * bucket + j));
    return rand16 ? (float)(bits & 0xFFFFu) : unit_float(bits);
  }
  // uniform(key, (nb, 1), -0.5, 0.5)[b]: max(lo, u * (hi - lo) + lo)
  __device__ __forceinline__ float shift(long long b) const {
    return fmaxf(-0.5f, __fadd_rn(__fmul_rn(unit_float(threefry_bits(k0, k1, (uint32_t)b)), 1.f),
                                  -0.5f));
  }
};

// K4's randomness: thresholds read from an (nb, cols) array.
struct ArrayRand {
  const float* rand;
  int cols;
  __device__ __forceinline__ float threshold(long long b, int, int j) const {
    return rand[b * cols + j];
  }
  __device__ __forceinline__ float shift(long long b) const { return rand[b * cols]; }
};

// The code of value j of bucket b, in [0, levels].
template <class Rand>
__device__ __forceinline__ unsigned code_of(float xv, float lo, float scale, float r,
                                            float levels, int mode, float rand_scale,
                                            const Rand& rnd, long long b, int bucket, int j) {
  const float v = __fdiv_rn(__fsub_rn(xv, lo), scale);
  float c;
  if (mode == kNearest) {
    c = rintf(v);
  } else if (mode == kShift) {
    c = rintf(__fsub_rn(v, r));
  } else {
    const float f = floorf(v);
    const float t = rnd.threshold(b, bucket, j);
    c = f + ((t < __fmul_rn(__fsub_rn(v, f), rand_scale)) ? 1.f : 0.f);
  }
  return (unsigned)fminf(fmaxf(c, 0.f), levels);
}

// Buckets of NV * 128 values: lane l holds float4 number i*32 + l of its
// bucket (values 4*(i*32 + l) .. +3) in registers.  Codes are packed at
// pbits = bits (8 % bits == 0) or 8 (one code per byte) bits each, so a
// lane's 4 codes fill 4*pbits bits and L = 8/pbits neighbouring lanes fill
// one 32-bit word of the little-endian code stream.
template <int NV, class Rand>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
quantize_pack_vec_kernel(const float* __restrict__ x, Rand rnd, uint8_t* __restrict__ codes,
                         float* __restrict__ scale_out, float* __restrict__ zero_out,
                         long long nb, int bits, float levels, float inv_levels, int mode,
                         float rand_scale) {
  constexpr int kBucket = NV * 128;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= nb) return;
  const float4* xb = reinterpret_cast<const float4*>(x + b * kBucket);
  float4 v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = __ldcs(xb + i * 32 + lane);

  float lo = fminf(fminf(v[0].x, v[0].y), fminf(v[0].z, v[0].w));
  float hi = fmaxf(fmaxf(v[0].x, v[0].y), fmaxf(v[0].z, v[0].w));
#pragma unroll
  for (int i = 1; i < NV; ++i) {
    lo = fminf(lo, fminf(fminf(v[i].x, v[i].y), fminf(v[i].z, v[i].w)));
    hi = fmaxf(hi, fmaxf(fmaxf(v[i].x, v[i].y), fmaxf(v[i].z, v[i].w)));
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  const float scale = fmaxf(__fmul_rn(__fsub_rn(hi, lo), inv_levels), 1e-12f);
  float r = 0.f, zero = lo;
  if (mode == kShift) {
    r = rnd.shift(b);
    zero = __fmaf_rn(r, scale, lo);
  }

  const int pbits = (8 % bits == 0) ? bits : 8;
  const int lanes_per_word = 8 / pbits;
  uint32_t* cw = reinterpret_cast<uint32_t*>(codes + b * (kBucket / 8 * pbits));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = 4 * (i * 32 + lane);
    unsigned p = code_of(v[i].x, lo, scale, r, levels, mode, rand_scale, rnd, b, kBucket, j);
    p |= code_of(v[i].y, lo, scale, r, levels, mode, rand_scale, rnd, b, kBucket, j + 1) << pbits;
    p |= code_of(v[i].z, lo, scale, r, levels, mode, rand_scale, rnd, b, kBucket, j + 2)
         << (2 * pbits);
    p |= code_of(v[i].w, lo, scale, r, levels, mode, rand_scale, rnd, b, kBucket, j + 3)
         << (3 * pbits);
    for (int s = 1; s < lanes_per_word; s <<= 1)
      p |= __shfl_down_sync(kFull, p, s) << (4 * pbits * s);
    if (lane % lanes_per_word == 0) cw[(i * 32 + lane) / lanes_per_word] = p;
  }
  if (lane == 0) {
    scale_out[b] = scale;
    zero_out[b] = zero;
  }
}

// Any bucket: one warp per bucket, min/max by shuffle, then each lane
// builds whole output bytes (k codes each), reading the bucket again.
template <class Rand>
__global__ void quantize_pack_kernel(const float* __restrict__ x, Rand rnd,
                                     uint8_t* __restrict__ codes,
                                     float* __restrict__ scale_out,
                                     float* __restrict__ zero_out,
                                     long long nb, int bucket, int bits,
                                     float levels, float inv_levels,
                                     int mode, float rand_scale) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= nb) return;
  const float* xb = x + b * bucket;

  float lo = __int_as_float(0x7f800000), hi = -__int_as_float(0x7f800000);
  for (int j = lane; j < bucket; j += 32) {
    const float v = xb[j];
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  const float scale = fmaxf(__fmul_rn(__fsub_rn(hi, lo), inv_levels), 1e-12f);

  float r = 0.f, zero = lo;
  if (mode == kShift) {
    r = rnd.shift(b);
    zero = __fmaf_rn(r, scale, lo);
  }

  const int k = (8 % bits == 0) ? 8 / bits : 1;
  const int nbytes = bucket / k;
  uint8_t* cb = codes + b * nbytes;
  for (int jb = lane; jb < nbytes; jb += 32) {
    unsigned int byte = 0;
    for (int i = 0; i < k; ++i) {
      const int j = jb * k + i;
      byte |= code_of(xb[j], lo, scale, r, levels, mode, rand_scale, rnd, b, bucket, j)
              << (i * bits);
    }
    cb[jb] = (uint8_t)byte;
  }
  if (lane == 0) {
    scale_out[b] = scale;
    zero_out[b] = zero;
  }
}

template <class Rand>
cudaError_t launch_quantize(const float* x, Rand rnd, uint8_t* codes, float* scale,
                            float* zero, long long nb, int bucket, int bits, int levels,
                            float inv_levels, int mode, float rand_scale, cudaStream_t st) {
  if (nb == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((nb + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int threads = 32 * kWarpsPerBlock;
  const float lv = (float)levels;
  const bool vec = bucket % 128 == 0 && bucket <= 1024 && (uintptr_t)x % 16 == 0;
#define QSDP_VEC(nv)                                                                   \
  case nv:                                                                             \
    quantize_pack_vec_kernel<nv, Rand><<<blocks, threads, 0, st>>>(                     \
        x, rnd, codes, scale, zero, nb, bits, lv, inv_levels, mode, rand_scale);       \
    break;
  if (vec) {
    switch (bucket / 128) {
      QSDP_VEC(1) QSDP_VEC(2) QSDP_VEC(3) QSDP_VEC(4)
      QSDP_VEC(5) QSDP_VEC(6) QSDP_VEC(7) QSDP_VEC(8)
    }
  } else {
    quantize_pack_kernel<Rand><<<blocks, threads, 0, st>>>(
        x, rnd, codes, scale, zero, nb, bucket, bits, lv, inv_levels, mode, rand_scale);
  }
#undef QSDP_VEC
  return cudaGetLastError();
}

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One thread per VEC consecutive output values of one bucket.
template <typename T, int VEC>
__global__ void unpack_dequantize_kernel(const uint8_t* __restrict__ codes,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ zero,
                                         T* __restrict__ out,
                                         long long n_vec, int bucket, int bits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_vec) return;
  const long long e0 = t * VEC;
  const long long b = e0 / bucket;
  const int j0 = (int)(e0 - b * bucket);
  const int k = (8 % bits == 0) ? 8 / bits : 1;
  const unsigned int mask = (1u << bits) - 1u;
  const uint8_t* cb = codes + b * (bucket / k);
  const float s = scale[b], z = zero[b];
  alignas(16) T v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int j = j0 + i;
    const unsigned int c = (cb[j / k] >> ((j % k) * bits)) & mask;
    v[i] = to_out<T>(__fmaf_rn((float)c, s, z));
  }
  T* o = out + e0;
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
  } else if constexpr (VEC * sizeof(T) == 8) {
    *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = v[i];
  }
}

template <typename T>
cudaError_t launch_dequant(const uint8_t* codes, const float* scale, const float* zero,
                           T* out, long long nb, int bucket, int bits, cudaStream_t st) {
  const long long n = nb * (long long)bucket;
  const int threads = 256;
  if (bucket % 4 == 0) {
    const long long nv = n / 4;
    const long long blocks = (nv + threads - 1) / threads;
    unpack_dequantize_kernel<T, 4><<<(unsigned int)blocks, threads, 0, st>>>(
        codes, scale, zero, out, nv, bucket, bits);
  } else {
    const long long blocks = (n + threads - 1) / threads;
    unpack_dequantize_kernel<T, 1><<<(unsigned int)blocks, threads, 0, st>>>(
        codes, scale, zero, out, n, bucket, bits);
  }
  return cudaGetLastError();
}

}  // namespace

// K1: rounding randomness drawn in the kernel from the key (k0, k1);
// rand_bits 32 (f32 uniforms) or 16 (low 16 bits vs frac * 65536).
extern "C" int qsdp_quantize_pack(const float* x, uint32_t k0, uint32_t k1, int rand_bits,
                                  uint8_t* codes, float* scale, float* zero,
                                  long long nb, int bucket, int bits, int levels,
                                  float inv_levels, int mode, void* stream) {
  const KeyRand rnd{k0, k1, rand_bits == 16};
  return (int)launch_quantize(x, rnd, codes, scale, zero, nb, bucket, bits, levels, inv_levels,
                              mode, rand_bits == 16 ? 65536.f : 1.f, (cudaStream_t)stream);
}

extern "C" int qsdp_unpack_dequantize(const uint8_t* codes, const float* scale,
                                      const float* zero, void* out, int out_bf16,
                                      long long nb, int bucket, int bits,
                                      void* stream) {
  if (nb == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return (int)launch_dequant<__nv_bfloat16>(codes, scale, zero,
                                              (__nv_bfloat16*)out, nb, bucket, bits, st);
  return (int)launch_dequant<float>(codes, scale, zero, (float*)out, nb, bucket, bits, st);
}

// K4: unpacked quantize, one u8 code per value: (nb, bucket) f32 x and
// thresholds `rand` (stochastic: up = rand < frac; nearest: rand unused).
extern "C" int qsdp_quantize_buckets(const float* x, const float* rand,
                                     uint8_t* codes, float* scale, float* zero,
                                     long long nb, int bucket, int levels,
                                     float inv_levels, int stochastic, void* stream) {
  return (int)launch_quantize(x, ArrayRand{rand, bucket}, codes, scale, zero, nb, bucket, 8,
                              levels, inv_levels, stochastic ? kStochastic : kNearest, 1.f,
                              (cudaStream_t)stream);
}

// K5: unpacked dequantize, codes u8 (nb, bucket) -> codes * scale + zero.
extern "C" int qsdp_dequantize_buckets(const uint8_t* codes, const float* scale,
                                       const float* zero, void* out, int out_bf16,
                                       long long nb, int bucket, void* stream) {
  return qsdp_unpack_dequantize(codes, scale, zero, out, out_bf16, nb, bucket, 8, stream);
}
