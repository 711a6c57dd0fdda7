// Matrix product with the BatchNorm batch statistics in its epilogue, for
// Hopper (sm_90a), FP32 FMA on the CUDA cores.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_fused.py:
// _mm_bn_kernel (launched by matmul_bn_stats, wrapped by conv1x1_bn_stats).
// Same function: for x (M, K) and w (K, N) of one dtype,
//   y    = x @ w, products accumulated in f32 (bf16 products are exact in
//          f32; f32 inputs use full FP32, not TF32), written once in x's
//          dtype;
//   s_n  = Σ_m y_mn and ss_n = Σ_m y_mn² over the UNROUNDED f32 products,
//          so that BN's mean = s/M and biased variance = ss/M − mean² never
//          read y again.
// The TPU kernel keeps each column tile's sums resident in VMEM across a
// sequential sweep over row tiles.  On the card blocks run in parallel and
// in no order, so the sweep becomes two passes:
//   1. a grid over (row tile, column tile): each block computes its 64x64
//      tile of y, stores it, and writes the tile's per-column partial sums
//      (Σy, Σy² of the f32 values) to a (N, ceil(M/64)) f32 scratch;
//   2. one block per column sums that column's partials in a fixed order.
// Each output has one writer and nothing uses atomics, so the result is
// deterministic.  Rows past M and columns past N are masked here (the TPU
// kernel asserts M and N are multiples of its tiles; ResNet-50 at batch 64
// has M = 12,544 and 3,136, which are not multiples of 512).
//
// What bounds it on the H100: bytes for the wide, shallow products (M
// 200,704 rows of K = 64 or 256 and N = 64 or 256 at ResNet-50's stage 0),
// operations for the deep ones (K, N 512-2048 at stage 3).  This first
// version runs the products as FP32 FMAs (67 TFLOP/s peak), not on the
// tensor cores, so it is slower than its bound at every shape.  What the
// design does about the bound:
//   * y is written once and never re-read: the statistics come from the
//     f32 accumulators while the tile is in registers;
//   * x and w tiles are staged in shared memory as f32 (16 deep), x
//     transposed, so each thread reads four rows and four columns as two
//     16-byte loads per step and does 16 FMAs with them (a 4x4 patch);
//   * the scratch of partial sums is N·ceil(M/64)·8 bytes, a few percent
//     of y's bytes, and the second pass reads it coalesced.
// Tensor-core (wgmma/TMA) versions are later work.
//
// Any M, K, N > 0; float32 or bfloat16.  The wrapper allocates y, s, ss and
// the scratch and passes the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;              // rows of y per block
constexpr int BN = 64;              // columns of y per block
constexpr int BK = 16;              // depth of one staged step
constexpr int TX = 16;              // threads along columns
constexpr int TY = 16;              // threads along rows
constexpr int NTHREADS = TX * TY;
constexpr int LDA = BM + 4;         // x tile stored transposed: As[k][m]
constexpr int RED_THREADS = 256;    // threads of the column-sum pass

static_assert(BM == 4 * TY && BN == 4 * TX, "each thread owns a 4x4 patch");
static_assert((LDA * 4) % 16 == 0, "float4 reads of the x tile stay aligned");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even
}

// Pass 1: one 64x64 tile of y and its per-column partial sums.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
mm_bn_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, float* __restrict__ part_s,
                  float* __restrict__ part_ss, int M, int K, int N) {
  __shared__ __align__(16) float As[BK][LDA];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red_s[TY][BN];
  __shared__ float red_ss[TY][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int rt = blockIdx.x;                    // row tile
  const long long m0 = (long long)rt * BM;
  const int n0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile (BM x BK), read along K, stored transposed; zero past M and K
#pragma unroll
    for (int e = 0; e < (BM * BK) / NTHREADS; ++e) {
      const int idx = tid + e * NTHREADS;
      const int r = idx / BK, c = idx % BK;
      const long long m = m0 + r;
      const int k = k0 + c;
      As[c][r] = (m < M && k < K) ? to_f32(x[m * K + k]) : 0.f;
    }
    // w tile (BK x BN), read along N; zero past K and N
#pragma unroll
    for (int e = 0; e < (BK * BN) / NTHREADS; ++e) {
      const int idx = tid + e * NTHREADS;
      const int r = idx / BN, c = idx % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? to_f32(w[(long long)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // y in x's dtype; the sums from the f32 accumulators of valid rows
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, css[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      const float v = acc[i][j];
      cs[j] += v;
      css[j] += v * v;
      if (n < N) y[m * N + n] = from_f32<T>(v);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[ty][tx * 4 + j] = cs[j];
    red_ss[ty][tx * 4 + j] = css[j];
  }
  __syncthreads();
  if (tid < BN) {
    const int n = n0 + tid;
    if (n < N) {
      float s = 0.f, ss = 0.f;
      for (int r = 0; r < TY; ++r) {          // fixed order
        s += red_s[r][tid];
        ss += red_ss[r][tid];
      }
      const long long at = (long long)n * gridDim.x + rt;
      part_s[at] = s;
      part_ss[at] = ss;
    }
  }
}

// Pass 2: one block per column sums its row tiles' partials in a fixed
// order (strided per thread, then a fixed tree).
__global__ void __launch_bounds__(RED_THREADS)
column_sum_kernel(const float* __restrict__ part_s,
                  const float* __restrict__ part_ss, float* __restrict__ s,
                  float* __restrict__ ss, int R) {
  __shared__ float sh_s[RED_THREADS];
  __shared__ float sh_ss[RED_THREADS];
  const int n = blockIdx.x;
  const float* ps = part_s + (long long)n * R;
  const float* pss = part_ss + (long long)n * R;
  float a = 0.f, b = 0.f;
  for (int r = threadIdx.x; r < R; r += RED_THREADS) {
    a += ps[r];
    b += pss[r];
  }
  sh_s[threadIdx.x] = a;
  sh_ss[threadIdx.x] = b;
  __syncthreads();
  for (int step = RED_THREADS / 2; step > 0; step /= 2) {
    if (threadIdx.x < step) {
      sh_s[threadIdx.x] += sh_s[threadIdx.x + step];
      sh_ss[threadIdx.x] += sh_ss[threadIdx.x + step];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    s[n] = sh_s[0];
    ss[n] = sh_ss[0];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, void* s, void* ss,
                   void* scratch, int M, int K, int N, cudaStream_t stream) {
  const int R = (M + BM - 1) / BM;
  float* part_s = static_cast<float*>(scratch);
  float* part_ss = part_s + (long long)R * N;
  const dim3 grid(R, (N + BN - 1) / BN);
  mm_bn_tile_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      part_s, part_ss, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_sum_kernel<<<N, RED_THREADS, 0, stream>>>(
      part_s, part_ss, static_cast<float*>(s), static_cast<float*>(ss), R);
  return cudaGetLastError();
}

}  // namespace

// f32 elements of the scratch that matmul_bn_stats needs for (M, N): the
// per-row-tile partial sums Σy and Σy², each (N, ceil(M/64)).
extern "C" long long matmul_bn_stats_scratch_floats(int M, int N) {
  return 2LL * ((M + BM - 1) / BM) * N;
}

// x: contiguous (M, K); w: contiguous (K, N); y: contiguous (M, N), all of
// one dtype (is_bf16 ? bfloat16 : float32); s, ss: (N,) float32; scratch:
// matmul_bn_stats_scratch_floats(M, N) float32.  Returns the launches'
// cudaError_t (0 on success); does not synchronise.
extern "C" int matmul_bn_stats(const void* x, const void* w, void* y, void* s,
                               void* ss, void* scratch, int M, int K, int N,
                               int is_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, y, s, ss, scratch, M, K, N, st)
              : launch<float>(x, w, y, s, ss, scratch, M, K, N, st);
  return (int)err;
}

extern "C" const char* matmul_bn_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
