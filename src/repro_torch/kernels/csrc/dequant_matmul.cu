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
// = 4; w_gate/w_up K=2048 N=8192, w_down K=8192 N=2048): bytes.  The codes
// are 16.8 MB per call against 134 MFLOP of work, 8 flop/byte -- a GEMV.
// What the design does about it: the codes are read once, as 4 consecutive
// bytes per thread (a warp reads 128 contiguous bytes per K-row), and the
// K dimension is split across blocks so that ~2 blocks per SM stream codes
// even when N/1024 * M/8 tiles alone could not fill 132 SMs.  Split-K
// partial sums go to an f32 scratch (ksplit, M, N) that a second kernel
// reduces in a fixed order, so results are deterministic.  Plain FMA loops,
// no tensor cores: at M <= 8 the math is far from the bound.
//
// Each block: 256 threads x 4 columns = 1024 columns, up to 8 rows of x,
// one K-chunk (<= 1024 rows) of x staged in shared memory as f32.  The
// tiling lives only here: the caller asks qsdp_rowquant_split for the
// split-K factor and sizes the (ksplit, M, N) scratch from it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;
constexpr int kBlockN = kThreads * kCols;
constexpr int kBlockM = 8;
constexpr int kMaxChunk = 1024;
constexpr int kTargetBlocks = 264;  // two blocks per SM of an H100 (132 SMs)

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Split-K factor: enough blocks to keep ~2 per SM busy, every K-chunk at
// most kMaxChunk rows and none empty.
int split_for(int M, int K, int N) {
  const int tiles = cdiv(N, kBlockN) * cdiv(M, kBlockM);
  int split = cdiv(K, kMaxChunk);
  const int fill = std::min(cdiv(kTargetBlocks, tiles), cdiv(K, 32));
  if (fill > split) split = fill;
  return cdiv(K, cdiv(K, split));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TX>
__global__ void rowquant_partial_kernel(const TX* __restrict__ x,
                                        const uint8_t* __restrict__ codes,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ zero,
                                        int n_seg, float* __restrict__ partial,
                                        int M, int K, int N, int kchunk) {
  __shared__ float xs[kBlockM * kMaxChunk];
  const int n0 = blockIdx.x * kBlockN + threadIdx.x * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kBlockM;
  const int k_begin = split * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int mt = min(kBlockM, M - m0);

  for (int i = threadIdx.x; i < kBlockM * kchunk; i += kThreads) {
    const int m = i / kchunk, kk = i - m * kchunk;
    const int k = k_begin + kk;
    xs[i] = (m < mt && k < k_end) ? to_f32(x[(long long)(m0 + m) * K + k]) : 0.f;
  }
  __syncthreads();
  if (n0 >= N) return;

  const int seg = N / n_seg;
  int sg[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) sg[j] = min(n0 + j, N - 1) / seg;
  const bool one_seg = sg[0] == sg[kCols - 1];
  const bool vec = (N % 4 == 0) && ((uintptr_t)codes % 4 == 0);

  float acc[kBlockM][kCols];    // (x * s) @ c
  float acc_z[kBlockM][kCols];  // x @ z, the rank-1 term
#pragma unroll
  for (int m = 0; m < kBlockM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = acc_z[m][j] = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    const uint8_t* crow = codes + (long long)k * N;
    float c[kCols];
    if (vec) {
      const uchar4 q = *reinterpret_cast<const uchar4*>(crow + n0);
      c[0] = q.x; c[1] = q.y; c[2] = q.z; c[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = (n0 + j < N) ? (float)crow[n0 + j] : 0.f;
    }
    const float* srow = scale + (long long)k * n_seg;
    const float* zrow = zero + (long long)k * n_seg;
    float s[kCols], z[kCols];
    if (one_seg) {
      const float s0 = srow[sg[0]], z0 = zrow[sg[0]];
#pragma unroll
      for (int j = 0; j < kCols; ++j) { s[j] = s0; z[j] = z0; }
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) { s[j] = srow[sg[j]]; z[j] = zrow[sg[j]]; }
    }
    const float* xk = xs + (k - k_begin);
#pragma unroll
    for (int m = 0; m < kBlockM; ++m) {
      const float xv = xk[m * kchunk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[m][j] = fmaf(xv * s[j], c[j], acc[m][j]);
        acc_z[m][j] = fmaf(xv, z[j], acc_z[m][j]);
      }
    }
  }

  for (int m = 0; m < mt; ++m) {
    float* prow = partial + ((long long)split * M + m0 + m) * N;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (n0 + j < N) prow[n0 + j] = acc[m][j] + acc_z[m][j];
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TX>
__global__ void rowquant_reduce_kernel(const float* __restrict__ partial, TX* __restrict__ y,
                                       int ksplit, long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int s = 0; s < ksplit; ++s) acc += partial[(long long)s * mn + i];
  store(y + i, acc);
}

template <typename TX>
cudaError_t launch(const TX* x, const uint8_t* codes, const float* scale, const float* zero,
                   int n_seg, float* partial, TX* y, int M, int K, int N, int ksplit,
                   cudaStream_t st) {
  if (ksplit != split_for(M, K, N) || N % n_seg) return cudaErrorInvalidValue;
  const int kchunk = cdiv(K, ksplit);
  dim3 grid((N + kBlockN - 1) / kBlockN, ksplit, (M + kBlockM - 1) / kBlockM);
  rowquant_partial_kernel<TX><<<grid, kThreads, 0, st>>>(x, codes, scale, zero, n_seg,
                                                         partial, M, K, N, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long mn = (long long)M * N;
  const int threads = 256;
  rowquant_reduce_kernel<TX><<<(unsigned int)((mn + threads - 1) / threads), threads, 0, st>>>(
      partial, y, ksplit, mn);
  return cudaGetLastError();
}

}  // namespace

// The split-K factor qsdp_rowquant_matmul expects for these shapes (K >= 1):
// its `partial` scratch holds split * M * N floats.
extern "C" int qsdp_rowquant_split(int M, int K, int N) { return split_for(M, K, N); }

extern "C" int qsdp_rowquant_matmul(const void* x, int x_bf16, const uint8_t* codes,
                                    const float* scale, const float* zero, int n_seg,
                                    float* partial, void* y, int M, int K, int N,
                                    int ksplit, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return (int)launch<__nv_bfloat16>((const __nv_bfloat16*)x, codes, scale, zero, n_seg,
                                      partial, (__nv_bfloat16*)y, M, K, N, ksplit, st);
  return (int)launch<float>((const float*)x, codes, scale, zero, n_seg, partial, (float*)y,
                            M, K, N, ksplit, st);
}
