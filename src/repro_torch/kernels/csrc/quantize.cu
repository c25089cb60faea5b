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
// Bound on the H100 at the serve shapes (gpt-1.3b, W8, bucket 1024): bytes.
//   K1 reads 4 B/value of f32 and writes 1 B/value of codes (+8 B per 1024
//   values of scale/zero): ~5 B/value, 0.7 flop/byte -- far below the
//   card's ~20 flop/byte f32 ridge.  K2 reads 1 B/value and writes 4 B/value.
// What the design does about it: each value is read from device memory once
// (K1's second pass over a bucket hits L1: one warp owns one 4 KB bucket),
// codes are packed in registers so sub-8-bit codes never exist unpacked in
// device memory, and K2 writes 16-byte vectors.  Neither kernel is tuned
// further yet (no TMA, no persistent blocks).
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

enum Mode { kNearest = 0, kStochastic = 1, kShift = 2 };

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp per bucket: min/max by shuffle, then each lane builds whole
// output bytes (k codes each) in registers.
__global__ void quantize_pack_kernel(const float* __restrict__ x,
                                     const float* __restrict__ rand,
                                     int rand_cols,
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
    r = rand[b * rand_cols];
    zero = __fmaf_rn(r, scale, lo);
  }

  const int k = (8 % bits == 0) ? 8 / bits : 1;
  const int nbytes = bucket / k;
  uint8_t* cb = codes + b * nbytes;
  for (int jb = lane; jb < nbytes; jb += 32) {
    unsigned int byte = 0;
    for (int i = 0; i < k; ++i) {
      const int j = jb * k + i;
      const float v = __fdiv_rn(__fsub_rn(xb[j], lo), scale);
      float c;
      if (mode == kNearest) {
        c = rintf(v);
      } else if (mode == kShift) {
        c = rintf(__fsub_rn(v, r));
      } else {
        const float f = floorf(v);
        const float t = rand[b * rand_cols + j];
        c = f + ((t < __fmul_rn(__fsub_rn(v, f), rand_scale)) ? 1.f : 0.f);
      }
      c = fminf(fmaxf(c, 0.f), levels);
      byte |= ((unsigned int)c) << (i * bits);
    }
    cb[jb] = (uint8_t)byte;
  }
  if (lane == 0) {
    scale_out[b] = scale;
    zero_out[b] = zero;
  }
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

extern "C" int qsdp_quantize_pack(const float* x, const float* rand, int rand_cols,
                                  uint8_t* codes, float* scale, float* zero,
                                  long long nb, int bucket, int bits, int levels,
                                  float inv_levels, int mode, float rand_scale,
                                  void* stream) {
  if (nb == 0) return 0;
  const long long blocks = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_pack_kernel<<<(unsigned int)blocks, 32 * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>(
      x, rand, rand_cols, codes, scale, zero, nb, bucket, bits, (float)levels,
      inv_levels, mode, rand_scale);
  return (int)cudaGetLastError();
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
  return qsdp_quantize_pack(x, rand, bucket, codes, scale, zero, nb, bucket, 8, levels,
                            inv_levels, stochastic ? kStochastic : kNearest, 1.f, stream);
}

// K5: unpacked dequantize, codes u8 (nb, bucket) -> codes * scale + zero.
extern "C" int qsdp_dequantize_buckets(const uint8_t* codes, const float* scale,
                                       const float* zero, void* out, int out_bf16,
                                       long long nb, int bucket, void* stream) {
  return qsdp_unpack_dequantize(codes, scale, zero, out, out_bf16, nb, bucket, 8, stream);
}
