// Row-quantized matmul (K3) for Hopper (sm_90a):
//     y = x @ dequant(W),  dequant(W)[k, n] = c[k, n] * s[k, seg(n)] + z[k, seg(n)]
//       = (x * s^T) @ c  +  (x @ z) 1^T                  (per N-segment)
// with u8 codes c (K, N), per-(K-row, N-segment) affine s/z (K, n_seg) f32,
// seg(n) = n / (N / n_seg), x (M, K) f32 or bf16, f32 accumulation, and y in
// x's dtype.  The dense weight is never written to device memory.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K3  src/repro/kernels/dequant_matmul.py  rowquant_matmul_pallas  (body _dqmm_kernel)
//
// Bound on the H100 at the serve shapes (decode MLP of gpt-1.3b, M = batch
// = 4; w_gate/w_up K=2048 N=8192 n_seg=8, w_down K=8192 N=2048 n_seg=2):
// bytes.  The codes are 16.8 MB per call against 134 MFLOP, 8 flop/byte --
// a GEMV, 5.0 us at 3.35 TB/s.  FMAs on the CUDA cores, no tensor cores,
// although the main loop ends up instruction-bound (PERF.md).
//
// Design: ONE launch, one block per SM.
// - Tiles.  A block owns TN = 16 * tpr columns (tpr threads per K-row, each
//   copying 16 codes at a time) and one of S K-ranges; its threads (512 at
//   M <= 4, 256 above) are row groups of tpr threads that walk the K-range
//   interleaved.  About one block per SM, with TN as wide as S <= 8 allows
//   (wide rows keep DRAM bursts long).
// - Bytes in flight.  Codes stream through a kStages-deep ring in shared
//   memory with cp.async (16 bytes per copy, no registers held while in
//   flight): each thread keeps kStages - 1 batches of U K-rows on the way
//   while it converts the batch that landed, 48 KB per block at M <= 4.  A
//   thread reads back only what it copied itself, so the ring needs no
//   barrier.
// - Precomputed scale.  Each block writes x[m,k] * s[k, seg] and
//   x[m,k] * z[k, seg] for its K-range and the segments of its tile into
//   shared memory first; per K-row a thread then reads them as float4s, and
//   the rank-1 term costs one add per (row, m), not one FMA per code.
// - M is a template parameter (1..8; M > 8 runs tiles of 8 rows on the
//   grid's z dimension), so the FMAs are exactly M per code.
// - u8 -> f32 by a byte permute into the mantissa of 2^23 (0x4B0000cc) minus
//   2^23: exact for 0..255, two full-rate instructions instead of I2F.
// - Deterministic split-K in the same launch.  Each block sums its row
//   groups in shared memory and writes its (M, TN) partial to a small
//   scratch (S * M * N floats); the last block of a tile to finish (an
//   atomic ticket per tile) adds the S partials in K order and writes y, so
//   the sum never depends on timing.  It then resets the ticket, so the
//   tickets stay zero between launches.
//   Why not a thread-block cluster with a distributed-shared-memory sum:
//   a cluster's blocks must share one GPC, and at one block per SM
//   clusters of 4 or 8 cannot cover all 132 SMs of an H100 (its GPCs are
//   not all multiples of 4 SMs); at N = 2048 a cluster of <= 8 blocks also
//   forces 64-byte tiles to fill the card.  Both cost more than the
//   partials' round trip through L2 (PERF.md).
// A generic one-thread-per-output kernel covers what the tiles cannot:
// codes not 16-byte aligned, N or the segment width not a multiple of 16,
// or a K-range whose table does not fit in shared memory.
//
// The tiling lives only here: qsdp_rowquant_workspace tells the caller how
// many tickets and partial floats to allocate (tickets zeroed once).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kGenericThreads = 256;
constexpr int kColsPerThread = 16;
constexpr int kMaxM = 8;
constexpr int kMaxSplit = 8;
constexpr int kMaxTn = 512;
constexpr int kStages = 4;             // cp.async ring depth
constexpr int kStage = 4;              // table rows a thread loads at once
// dynamic shared memory a block may take: 227 KB less 1 KB for the static
// __shared__ variables
constexpr size_t kSmemMax = 232448 - 1024;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// byte i of w as an exact float: 0x4B0000cc is 2^23 + cc.  `magic` is
// kMagic, handed to the kernel as an argument so that it stays in a
// register: as an immediate, ptxas moves each byte's selector into a
// register instead, once per code.
constexpr uint32_t kMagic = 0x4B000000u;
__device__ __forceinline__ float byte_to_f32(uint32_t w, uint32_t magic, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, magic, 0x7440 + i)), 8388608.f);
}

struct Tiling {
  int tpr, tn, n_tiles, m_tiles, splits, kc, n_ts;
  size_t smem;
};

template <int MT>
__host__ __device__ constexpr int padded_m() { return (MT + 3) / 4 * 4; }

// Threads per block, and K-rows a thread copies per ring stage: 16 warps
// per SM at M <= 4 (their 64 accumulators leave room for 512 threads
// under the 128-register cap); 8 warps above, where the accumulators
// alone take M * 16 registers
template <int MT>
__host__ __device__ constexpr int threads() { return MT <= 4 ? 512 : 256; }
template <int MT>
__host__ __device__ constexpr int rows_per_stage() { return 2; }

// Shared memory, in floats: [ring | row-group partials (G, MT, TN)] (the
// partials reuse the ring once it is drained), then the (rows, n_ts,
// {x*s, x*z}, MP) table.
template <int MT>
__host__ __device__ inline int ring_floats() {
  const int ring = kStages * rows_per_stage<MT>() * threads<MT>() * 4;
  const int part = threads<MT>() * kColsPerThread * MT;
  return ring > part ? ring : part;
}

template <int MT>
__host__ __device__ inline int table_floats(int kc, int n_ts) {
  return kc * n_ts * 2 * padded_m<MT>();
}

template <int MT, typename TX>
__global__ void __launch_bounds__(threads<MT>())
rowquant_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
                const float* __restrict__ scale, const float* __restrict__ zero,
                float* __restrict__ partial, int* __restrict__ tickets, TX* __restrict__ y,
                int M, int K, int N, int n_seg, int tpr, int kc, int n_ts, uint32_t magic) {
  constexpr int MP = padded_m<MT>();
  constexpr int U = rows_per_stage<MT>();
  constexpr int kThreads = threads<MT>();
  extern __shared__ float4 smem4[];
  __shared__ int last;
  float* smem = reinterpret_cast<float*>(smem4);
  uint4* ring = reinterpret_cast<uint4*>(smem4);  // (kStages, U, kThreads)
  float* tab = smem + ring_floats<MT>();

  const int tid = threadIdx.x;
  const int tn = tpr * kColsPerThread, G = kThreads / tpr;
  const int g = tid / tpr, c = tid - (tid / tpr) * tpr;
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  const int split = blockIdx.y, splits = gridDim.y;
  const int col0 = blockIdx.x * tn;
  const int n0 = col0 + c * kColsPerThread;
  const bool active = n0 < N;
  const int m0 = blockIdx.z * MT;
  const int mt = min(MT, M - m0);
  const int segw = N / n_seg;
  const int first_seg = col0 / segw;
  const int ts = active ? n0 / segw - first_seg : 0;
  const int k_begin = split * kc;
  const int rows = max(0, min(K, k_begin + kc) - k_begin);
  const uint8_t* cbase = codes + (long long)k_begin * N + n0;
  // this thread's rows: g + (b * U + u) * G for batch b
  const int n_batches = active && rows > g ? cdiv(rows - g, U * G) : 0;

  auto issue = [&](int b) {
    if (b < n_batches) {
      uint4* slot = ring + (b % kStages) * U * kThreads + tid;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = g + (b * U + u) * G;
        if (kk < rows) __pipeline_memcpy_async(slot + u * kThreads, cbase + (long long)kk * N, 16);
      }
    }
    __pipeline_commit();
  };

  // x * s and x * z for this block's rows and tile segments; a thread
  // issues the loads of kStage rows before it stores any, and the first
  // code batches right behind the first of those loads, so the table's
  // inputs are not queued behind the codes
  const int row_f = n_ts * 2 * MP;
  bool issued = false;
  for (int t = 0; t < n_ts; ++t) {
    const int sg = min(first_seg + t, n_seg - 1);
    for (int kk0 = 0; kk0 < rows; kk0 += kThreads * kStage) {
      float xv[kStage][MT], sv[kStage], zv[kStage];
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        const int kk = kk0 + i * kThreads + tid;
        const bool ok = kk < rows;
        const long long k = k_begin + (ok ? kk : 0);
        sv[i] = ok ? scale[k * n_seg + sg] : 0.f;
        zv[i] = ok ? zero[k * n_seg + sg] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m)
          xv[i][m] = (ok && m < mt) ? to_f32(x[(long long)(m0 + m) * K + k]) : 0.f;
      }
      if (!issued) {
#pragma unroll
        for (int b = 0; b < kStages - 1; ++b) issue(b);
        issued = true;
      }
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        const int kk = kk0 + i * kThreads + tid;
        if (kk < rows) {
          float* row = tab + kk * row_f + t * 2 * MP;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            row[m] = __fmul_rn(xv[i][m], sv[i]);
            row[MP + m] = __fmul_rn(xv[i][m], zv[i]);
          }
        }
      }
    }
  }
  if (!issued) {
#pragma unroll
    for (int b = 0; b < kStages - 1; ++b) issue(b);
  }
  __syncthreads();

  float acc[MT][kColsPerThread];
  float accz[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    accz[m] = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;
  }
  for (int b = 0; b < n_batches; ++b) {
    // refill the slot consumed in the previous iteration, then wait for batch b
    issue(b + kStages - 1);
    __pipeline_wait_prior(kStages - 1);
    const uint4* slot = ring + (b % kStages) * U * kThreads + tid;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = g + (b * U + u) * G;
      if (kk < rows) {
        const float4* tp = reinterpret_cast<const float4*>(tab + kk * row_f + ts * 2 * MP);
        float xs[MP], xz[MP];
#pragma unroll
        for (int q = 0; q < MP / 4; ++q) {
          const float4 a = tp[q], bz = tp[MP / 4 + q];
          xs[4 * q] = a.x; xs[4 * q + 1] = a.y; xs[4 * q + 2] = a.z; xs[4 * q + 3] = a.w;
          xz[4 * q] = bz.x; xz[4 * q + 1] = bz.y; xz[4 * q + 2] = bz.z; xz[4 * q + 3] = bz.w;
        }
        const uint4 q4 = slot[u * kThreads];
        const uint32_t w[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const float cf = byte_to_f32(w[i], magic, bb);
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[m][4 * i + bb] = fmaf(xs[m], cf, acc[m][4 * i + bb]);
          }
#pragma unroll
        for (int m = 0; m < MT; ++m) accz[m] += xz[m];
      }
    }
  }
  __pipeline_wait_prior(0);

  // sum the row groups in shared memory (reusing the ring), in group order
  __syncthreads();
  float* part = smem;  // (G, MT, TN)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; j += 4)
      *reinterpret_cast<float4*>(part + (g * MT + m) * tn + c * kColsPerThread + j) =
          make_float4(acc[m][j] + accz[m], acc[m][j + 1] + accz[m], acc[m][j + 2] + accz[m],
                      acc[m][j + 3] + accz[m]);
  __syncthreads();
  float* mine = splits > 1 ? partial + ((long long)tile * splits + split) * MT * tn : nullptr;
  for (int o = tid; o < MT * tn; o += kThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int gg = 0; gg < G; ++gg) s += part[gg * MT * tn + o];
    if (splits > 1) {
      mine[o] = s;
    } else {
      const int m = o / tn, n = col0 + o - (o / tn) * tn;
      if (m < mt && n < N) store(y + (long long)(m0 + m) * N + n, s);
    }
  }
  if (splits == 1) return;

  // the last block of this tile to finish adds the splits' partials in K order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* tile_part = partial + (long long)tile * splits * MT * tn;
  for (int o = tid; o < MT * tn; o += kThreads) {
    float v[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) v[q] = q < splits ? __ldcg(tile_part + q * MT * tn + o) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) s += v[q];
    const int m = o / tn, n = col0 + o - (o / tn) * tn;
    if (m < mt && n < N) store(y + (long long)(m0 + m) * N + n, s);
  }
  if (tid == 0) tickets[tile] = 0;
}

// One thread per output: codes not 16-byte aligned, ragged N or segments,
// or K-ranges too long for shared memory.
template <typename TX>
__global__ void rowquant_generic_kernel(const TX* __restrict__ x,
                                        const uint8_t* __restrict__ codes,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ zero, TX* __restrict__ y,
                                        int M, int K, int N, int n_seg) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * N) return;
  const int m = (int)(i / N), n = (int)(i - (long long)m * N);
  const int sg = n / (N / n_seg);
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const float w = __fmaf_rn((float)codes[(long long)k * N + n], scale[(long long)k * n_seg + sg],
                              zero[(long long)k * n_seg + sg]);
    acc = fmaf(to_f32(x[(long long)m * K + k]), w, acc);
  }
  store(y + i, acc);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

// Columns per block and K-ranges per tile for these shapes: about one block
// per SM, the widest tile whose splits leave at most 1024 partial columns
// per tile for the last block to add up.
template <int MT>
bool tiling_m(int M, int K, int N, int n_seg, const uint8_t* codes, Tiling* t) {
  const int segw = N / n_seg;
  if ((uintptr_t)codes % 16 || N % kColsPerThread || segw % kColsPerThread) return false;
  const int m_tiles = cdiv(M, MT);
  int tpr = kMaxTn / kColsPerThread, splits = 1;
  for (;; tpr /= 2) {
    const int tiles = cdiv(N, kColsPerThread * tpr) * m_tiles;
    splits = std::min({kMaxSplit, K, std::max(1, (sm_count() + tiles / 2) / tiles)});
    if (tpr == 1 || splits * kColsPerThread * tpr <= 1024) break;
  }
  t->tpr = tpr;
  t->tn = kColsPerThread * tpr;
  t->n_tiles = cdiv(N, t->tn);
  t->m_tiles = m_tiles;
  t->splits = splits;
  t->kc = cdiv(K, splits);
  t->n_ts = 1;
  for (int tile = 0; tile < t->n_tiles; ++tile) {
    const int last = std::min(N, (tile + 1) * t->tn) - 1;
    t->n_ts = std::max(t->n_ts, last / segw - tile * t->tn / segw + 1);
  }
  t->smem = sizeof(float) * ((size_t)ring_floats<MT>() + table_floats<MT>(t->kc, t->n_ts));
  return t->smem <= kSmemMax;
}

bool tiling(int M, int K, int N, int n_seg, const uint8_t* codes, Tiling* t) {
  switch (std::min(M, kMaxM)) {
    case 1: return tiling_m<1>(M, K, N, n_seg, codes, t);
    case 2: return tiling_m<2>(M, K, N, n_seg, codes, t);
    case 3: return tiling_m<3>(M, K, N, n_seg, codes, t);
    case 4: return tiling_m<4>(M, K, N, n_seg, codes, t);
    case 5: return tiling_m<5>(M, K, N, n_seg, codes, t);
    case 6: return tiling_m<6>(M, K, N, n_seg, codes, t);
    case 7: return tiling_m<7>(M, K, N, n_seg, codes, t);
    default: return tiling_m<8>(M, K, N, n_seg, codes, t);
  }
}

template <int MT, typename TX>
cudaError_t launch_m(const Tiling& t, bool tiled, const TX* x, const uint8_t* codes,
                     const float* scale, const float* zero, float* partial, int* tickets,
                     TX* y, int M, int K, int N, int n_seg, cudaStream_t st) {
  if (!tiled) {
    const long long n_out = (long long)M * N;
    rowquant_generic_kernel<TX><<<(unsigned)((n_out + kGenericThreads - 1) / kGenericThreads),
                                   kGenericThreads, 0,
                                   st>>>(x, codes, scale, zero, y, M, K, N, n_seg);
    return cudaGetLastError();
  }
  auto kern = rowquant_kernel<MT, TX>;
  // allow the most shared memory once per device (a per-launch call costs
  // host time on every decode step)
  static unsigned long long devices_set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!(devices_set >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return e;
    devices_set |= 1ull << dev;
  }
  kern<<<dim3(t.n_tiles, t.splits, t.m_tiles), threads<MT>(), t.smem, st>>>(
      x, codes, scale, zero, partial, tickets, y, M, K, N, n_seg, t.tpr, t.kc, t.n_ts, kMagic);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(const TX* x, const uint8_t* codes, const float* scale, const float* zero,
                   float* partial, int* tickets, TX* y, int M, int K, int N, int n_seg,
                   cudaStream_t st) {
  Tiling t;
  const bool tiled = tiling(M, K, N, n_seg, codes, &t);
#define QSDP_M(mt) \
  launch_m<mt, TX>(t, tiled, x, codes, scale, zero, partial, tickets, y, M, K, N, n_seg, st)
  switch (std::min(M, kMaxM)) {
    case 1: return QSDP_M(1);
    case 2: return QSDP_M(2);
    case 3: return QSDP_M(3);
    case 4: return QSDP_M(4);
    case 5: return QSDP_M(5);
    case 6: return QSDP_M(6);
    case 7: return QSDP_M(7);
    default: return QSDP_M(8);
  }
#undef QSDP_M
}

}  // namespace

// What qsdp_rowquant_matmul needs from the caller for these shapes and this
// codes pointer: `tickets` ints, all zero on the first call (each launch
// leaves them zero), and `partial` floats of scratch.
extern "C" int qsdp_rowquant_workspace(int M, int K, int N, int n_seg, const void* codes,
                                       int* tickets, long long* partial) {
  Tiling t;
  *tickets = 0;
  *partial = 0;
  if (M < 1 || K < 1 || N < 1 || n_seg < 1 || N % n_seg) return 0;
  if (tiling(M, K, N, n_seg, (const uint8_t*)codes, &t) && t.splits > 1) {
    *tickets = t.n_tiles * t.m_tiles;
    *partial = (long long)t.n_tiles * t.m_tiles * t.splits * std::min(M, kMaxM) * t.tn;
  }
  return 0;
}

extern "C" int qsdp_rowquant_matmul(const void* x, int x_bf16, const uint8_t* codes,
                                    const float* scale, const float* zero, int n_seg,
                                    float* partial, int* tickets, void* y, int M, int K, int N,
                                    void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K < 1 || n_seg < 1 || N % n_seg) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return (int)launch<__nv_bfloat16>((const __nv_bfloat16*)x, codes, scale, zero, partial,
                                      tickets, (__nv_bfloat16*)y, M, K, N, n_seg, st);
  return (int)launch<float>((const float*)x, codes, scale, zero, partial, tickets, (float*)y, M,
                            K, N, n_seg, st);
}
