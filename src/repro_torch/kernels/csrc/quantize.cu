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
// rate bounds it.  K2 reads the codes (bits/8 B a value) and 2 x 4 or 2 x 2
// B of scale/zero a bucket and writes 2 (bf16) or 4 (f32) B a value: at 8
// bits, 3 or 5 B a value, bound by bytes (a whole gpt-1.3b layer, 7
// quantized tensors of 6.7e7 values, in bf16: 0.060 ms).
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
// one-warp loop (two passes over the bucket, the second through L1).  K4
// runs K1's device code with its thresholds read from an array (the TPU
// kernel's interface), K5 runs K2's.
//
// K2's design.  The TPU kernel decodes one (rows, bucket) tile of one tensor
// per grid step; on this card a gathered layer buffer decoded tensor by
// tensor costs a launch (and a few microseconds of first-byte latency) per
// tensor, so one launch takes a table of segments (passed by value as a
// kernel parameter: codes, scale, zero and output pointers, nb, bucket,
// code width, metadata and output dtype) and decodes all of them, each into
// its own dtype, reading scale/zero straight from the wire bytes.  The
// grid is one wave of resident blocks; each warp walks units of work -- a
// bucket's codes in chunks of up to 1 KB, so a bucket of any size (4096 at
// 8 bits is 4 chunks) takes the same path -- found from the table's prefix
// counts (no division per value), keeps the unit's scale/zero in
// registers, and issues the next unit's loads before it decodes the
// current one, so every SM holds ~1 KB of codes in flight per warp, tens
// of KB per SM where ~10 KB cover the first-byte latency of the codes at
// the card's rate.  One wave, not a block per bucket: a warp's next loads
// then overlap its own stores with no block start in between, and its walk
// through the table only moves forward.  Codes come in 16-byte loads (16,
// 32 or 64 codes), go through a 1 KB shared-memory stage per warp, and
// leave as 16-byte stores of 8 bf16 or 4 f32 values, 512 contiguous bytes
// per warp instruction.  A segment whose codes or output are not 16-byte
// aligned (an odd nb shifts the next segment of a buffer by 8 bytes at 8
// bits) or whose bucket does not fill whole 16-byte loads takes a generic
// path in the same launch (one value per lane, byte loads); scale/zero
// that are not aligned to their width are read byte by byte.
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

// ---------------------------------------------------------------------------
// K2 (and K5): bit-unpack -> dequantize of a table of segments in one launch
// ---------------------------------------------------------------------------

enum SegFlags {
  kPbitsMask = 15,     // code width in the byte stream: bits (8 % bits == 0) or 8
  kMetaBf16 = 16,      // scale/zero are bf16 (else f32)
  kOutBf16 = 32,       // writes bf16 (else f32)
  kFast = 64,          // the 16-byte path (launch_wire decides)
  kMetaAligned = 128,  // scale/zero pointers aligned to their width
};

constexpr int kDqWarps = 8;
// unit indices stay ints, with room for the grid's stride above them
constexpr long long kMaxUnits = (1LL << 31) - (1LL << 24);
constexpr int kChunkBytes = 1024;  // 16-byte path: the codes one unit stages per warp
constexpr int kChunk16 = kChunkBytes / 16;

// One segment: buckets of `bucket` values, codes from `codes` (the bucket's
// bucket*pbits/8 bytes one after the other), scale[b] / zero[b] in f32 or
// bf16 at any byte address, decoded into `out` (nb, bucket).  Its work is
// `units` units, `upb` per bucket: on the 16-byte path the bucket's codes
// in chunks of kChunkBytes (the last one shorter), else the whole bucket.
struct Seg {
  const uint8_t* codes;
  const uint8_t* scale;
  const uint8_t* zero;
  void* out;
  int bucket;
  int unit0;  // the segment's first unit in the launch's count of units
  int units;
  int upb;
  int flags;
};

// Passed by value (56 bytes a segment, 3.5 KB in all: within the 4 KB of
// kernel parameters), read through the constant bank.
constexpr int kMaxSegs = 64;
struct SegTable {
  Seg seg[kMaxSegs];
  int units;  // units of all segments
};

// One unit's inputs, fetched one unit ahead of its decode.
struct Fetched {
  uint4 c[kChunk16 / 32];
  float s, z;
};

__device__ __forceinline__ float load_meta(const uint8_t* p, long long b, int flags) {
  if (flags & kMetaBf16) {
    const uint8_t* q = p + 2 * b;
    const unsigned v = (flags & kMetaAligned) ? *reinterpret_cast<const uint16_t*>(q)
                                              : (unsigned)q[0] | ((unsigned)q[1] << 8);
    return __uint_as_float(v << 16);
  }
  const uint8_t* q = p + 4 * b;
  const unsigned v = (flags & kMetaAligned)
                         ? *reinterpret_cast<const uint32_t*>(q)
                         : (unsigned)q[0] | ((unsigned)q[1] << 8) | ((unsigned)q[2] << 16) |
                               ((unsigned)q[3] << 24);
  return __uint_as_float(v);
}

// c*scale + zero, one rounding (XLA contracts the reference's expression
// into an FMA).  float(c) by the exponent trick: exact for c < 2^23, and an
// OR and an FADD where the conversion instruction runs at a quarter rate.
__device__ __forceinline__ float dq(unsigned c, float s, float z) {
  return __fmaf_rn(__fsub_rn(__uint_as_float(0x4B000000u | c), 8388608.f), s, z);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Unit v of a segment: its bucket, and (16-byte path) its chunk's first
// 16-byte word in the bucket and count of 16-byte words.
struct Unit {
  long long b;
  int w0, n16;
};

__device__ __forceinline__ Unit locate(const Seg& g, long long v) {
  Unit u;
  u.b = g.upb == 1 ? v : v / g.upb;
  const int words = g.bucket * (g.flags & kPbitsMask) / 128;
  u.w0 = (int)(v - u.b * g.upb) * kChunk16;
  u.n16 = min(kChunk16, words - u.w0);
  return u;
}

__device__ __forceinline__ Fetched fetch(const Seg& g, long long v, int lane) {
  Fetched f;
  const Unit u = locate(g, v);
  f.s = load_meta(g.scale, u.b, g.flags);
  f.z = load_meta(g.zero, u.b, g.flags);
  if (g.flags & kFast) {
    const int words = g.bucket * (g.flags & kPbitsMask) / 128;
    const uint4* src = reinterpret_cast<const uint4*>(g.codes) + u.b * words + u.w0;
#pragma unroll
    for (int i = 0; i < kChunk16 / 32; ++i) {
      const int c = lane + 32 * i;
      f.c[i] = c < u.n16 ? __ldcs(src + c) : make_uint4(0, 0, 0, 0);
    }
  }
  return f;
}

// The 16-byte path: the warp's codes go through shared memory so that each
// lane's 16-byte store takes the codes of 8 (bf16) or 4 (f32) neighbouring
// values, and the warp stores 512 contiguous bytes per instruction.
__device__ __forceinline__ void decode_fast(const Seg& g, long long v, const Fetched& f,
                                            uint4* stage, int lane) {
  const int pbits = g.flags & kPbitsMask;
  const unsigned mask = (1u << pbits) - 1u;
  const Unit u = locate(g, v);
  // the chunk's first value (16-byte words hold 128 / pbits values each)
  const long long o0 = u.b * g.bucket + (long long)u.w0 * (128 / pbits);
  const int nvals = u.n16 * (128 / pbits);
  __syncwarp();  // the previous unit's reads of the stage are done
#pragma unroll
  for (int i = 0; i < kChunk16 / 32; ++i)
    if (lane + 32 * i < u.n16) stage[lane + 32 * i] = f.c[i];
  __syncwarp();
  const uint64_t* st = reinterpret_cast<const uint64_t*>(stage);
  if (g.flags & kOutBf16) {
    uint4* o = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(g.out) + o0);
    const int nst = nvals / 8;
#pragma unroll 4
    for (int i = lane; i < nst; i += 32) {
      const int bit = i * 8 * pbits;
      const uint64_t w = st[bit >> 6] >> (bit & 63);
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = bf16x2(dq((unsigned)(w >> (2 * j * pbits)) & mask, f.s, f.z),
                      dq((unsigned)(w >> ((2 * j + 1) * pbits)) & mask, f.s, f.z));
      o[i] = make_uint4(r[0], r[1], r[2], r[3]);
    }
  } else {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(g.out) + o0);
    const int nst = nvals / 4;
#pragma unroll 4
    for (int i = lane; i < nst; i += 32) {
      const int bit = i * 4 * pbits;
      const uint64_t w = st[bit >> 6] >> (bit & 63);
      o[i] = make_float4(dq((unsigned)w & mask, f.s, f.z),
                         dq((unsigned)(w >> pbits) & mask, f.s, f.z),
                         dq((unsigned)(w >> (2 * pbits)) & mask, f.s, f.z),
                         dq((unsigned)(w >> (3 * pbits)) & mask, f.s, f.z));
    }
  }
}

// Any bucket, codes and output at any alignment: one value per lane and
// step, codes read byte by byte (a unit is a whole bucket here).
__device__ __forceinline__ void decode_generic(const Seg& g, long long b, float s, float z,
                                               int lane) {
  const int pbits = g.flags & kPbitsMask;
  const unsigned mask = (1u << pbits) - 1u;
  const uint8_t* src = g.codes + b * (g.bucket * pbits / 8);
  const long long o = b * g.bucket;
  for (int j = lane; j < g.bucket; j += 32) {
    const int bit = j * pbits;
    const float v = dq(((unsigned)src[bit >> 3] >> (bit & 7)) & mask, s, z);
    if (g.flags & kOutBf16)
      static_cast<__nv_bfloat16*>(g.out)[o + j] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(g.out)[o + j] = v;
  }
}

// A grid of about one wave of resident blocks; warp w of the grid decodes
// units w, w + W, w + 2W, ... (W warps in all) of the table, issuing the
// next unit's loads before it decodes the current one.
__global__ void __launch_bounds__(32 * kDqWarps)
unpack_dequantize_kernel(const __grid_constant__ SegTable t) {
  __shared__ uint4 stage_all[kDqWarps][kChunk16];
  const int lane = threadIdx.x & 31;
  uint4* stage = stage_all[threadIdx.x >> 5];
  const int stride = gridDim.x * kDqWarps;
  int u = blockIdx.x * kDqWarps + (threadIdx.x >> 5);
  if (u >= t.units) return;
  int s = 0;
  while (u >= t.seg[s].unit0 + t.seg[s].units) ++s;
  Fetched cur = fetch(t.seg[s], u - t.seg[s].unit0, lane);
  for (;;) {
    const int un = u + stride;
    int sn = s;
    Fetched nxt = cur;
    if (un < t.units) {
      while (un >= t.seg[sn].unit0 + t.seg[sn].units) ++sn;
      nxt = fetch(t.seg[sn], un - t.seg[sn].unit0, lane);
    }
    const Seg& g = t.seg[s];
    if (g.flags & kFast)
      decode_fast(g, u - g.unit0, cur, stage, lane);
    else
      decode_generic(g, u - g.unit0, cur.s, cur.z, lane);
    if (un >= t.units) break;
    u = un;
    s = sn;
    cur = nxt;
  }
}

int resident_blocks() {
  constexpr int kMaxDevices = 64;
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unpack_dequantize_kernel,
                                                    32 * kDqWarps, 0) != cudaSuccess)
    return 0;
  const int r = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cache[dev] = r;
  return r;
}

// Segment description rows, as the wrapper passes them (8 int64 each).
enum DescCol { kCodes, kScale, kZero, kOut, kNb, kBucket, kBits, kDescFlags, kDescCols };
enum DescFlags { kDescMetaBf16 = 1, kDescOutBf16 = 2 };

cudaError_t launch_wire(const long long* desc, int n_seg, cudaStream_t st) {
  SegTable t;
  int n = 0;
  long long units = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long* d = desc + (long long)i * kDescCols;
    const int bits = (int)d[kBits];
    const long long nb = d[kNb], bucket = d[kBucket];
    if (bits < 1 || bits > 8 || nb < 0 || bucket < 1 || bucket > (1 << 24))
      return cudaErrorInvalidValue;
    if (nb == 0) continue;
    if (n == kMaxSegs) return cudaErrorInvalidValue;
    const int pbits = (8 % bits == 0) ? bits : 8;
    if (bucket * pbits % 8) return cudaErrorInvalidValue;
    const bool meta_bf16 = d[kDescFlags] & kDescMetaBf16, out_bf16 = d[kDescFlags] & kDescOutBf16;
    const long long code_bytes = bucket * pbits / 8, mb = meta_bf16 ? 2 : 4;
    const bool fast = code_bytes % 16 == 0 && d[kCodes] % 16 == 0 && d[kOut] % 16 == 0;
    const bool aligned = d[kScale] % mb == 0 && d[kZero] % mb == 0;
    const long long upb = fast ? (code_bytes + kChunkBytes - 1) / kChunkBytes : 1;
    if (nb > kMaxUnits / upb || units + nb * upb > kMaxUnits) return cudaErrorInvalidValue;
    Seg& g = t.seg[n++];
    g.codes = reinterpret_cast<const uint8_t*>(d[kCodes]);
    g.scale = reinterpret_cast<const uint8_t*>(d[kScale]);
    g.zero = reinterpret_cast<const uint8_t*>(d[kZero]);
    g.out = reinterpret_cast<void*>(d[kOut]);
    g.bucket = (int)bucket;
    g.unit0 = (int)units;
    g.units = (int)(nb * upb);
    g.upb = (int)upb;
    g.flags = pbits | (meta_bf16 ? kMetaBf16 : 0) | (out_bf16 ? kOutBf16 : 0) |
              (fast ? kFast : 0) | (aligned ? kMetaAligned : 0);
    units += nb * upb;
  }
  t.units = (int)units;
  if (units == 0) return cudaSuccess;
  const int resident = resident_blocks();
  if (resident == 0) return cudaGetLastError();
  const long long want = (units + kDqWarps - 1) / kDqWarps;
  const int blocks = (int)(want < resident ? want : resident);
  unpack_dequantize_kernel<<<blocks, 32 * kDqWarps, 0, st>>>(t);
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

// K2 over a table of n_seg segments, one launch: rows of 8 int64
// (codes, scale, zero, out pointers; nb, bucket, bits; flags 1 = bf16
// scale/zero, 2 = bf16 out).  At most 64 segments with nb > 0.
extern "C" int qsdp_unpack_dequantize_wire(const long long* desc, int n_seg, void* stream) {
  return (int)launch_wire(desc, n_seg, (cudaStream_t)stream);
}

// K2 on one tensor: (nb, bucket*bits/8) codes, (nb, 1) f32 scale/zero.
extern "C" int qsdp_unpack_dequantize(const uint8_t* codes, const float* scale,
                                      const float* zero, void* out, int out_bf16,
                                      long long nb, int bucket, int bits,
                                      void* stream) {
  const long long desc[kDescCols] = {(long long)codes, (long long)scale, (long long)zero,
                                     (long long)out, nb, bucket, bits,
                                     out_bf16 ? kDescOutBf16 : 0};
  return (int)launch_wire(desc, 1, (cudaStream_t)stream);
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
