// Flash-attention backward, dq pass, for Hopper (sm_90a), FP32 FMA on the
// CUDA cores.
//
// Replaces the TPU kernel deeplearning4j_tpu/parallel/ring.py:
// _flash_bwd_dq_kernel (launched by _flash_backward).  Same function, for
// query row i of one (b·h) and every key j:
//   s_ij  = (q_i · k_j) · scale, accumulated in f32 (scale = f32(1/sqrt(d)));
//   causal (top-left aligned): s_ij = -1e30 for j > i, and k tiles wholly in
//   the future of the q tile are skipped;
//   p_ij  = exp(s_ij − lse_i), lse_i the forward's per-row logsumexp (f32);
//   dp_ij = dO_i · v_j, accumulated in f32;
//   ds_ij = p_ij · (dp_ij − δ_i) · scale, δ_i = rowsum(dO_i ⊙ O_i) in f32
//   (computed outside the kernel, as the reference does);
//   dq_i  = Σ_j ds_ij · k_j with ds rounded to k's dtype first (the
//   reference's ds.astype(k.dtype)), accumulated in f32, stored in q's dtype.
// lse and δ are (b·h, tq) f32: the TPU kernel replicates them over 128
// lanes, a Mosaic layout rule the card does not have.
//
// What bounds it on the H100: operations.  Three products of 2·tq·tk·d
// FLOPs each (QKᵀ, dO·Vᵀ, dS·K) and tq·tk exps, against (4·tq + tk)·d
// elements and two f32 rows moved.  This first version runs the products as
// FP32 FMAs (67 TFLOP/s peak), not on the tensor cores.  What the design
// does about the bound:
//   * the TPU carries dq_acc across a sequential k grid axis; here a block
//     owns 64 query rows of one (b·h) and loops over 64-key tiles itself,
//     so p, dp and ds never reach device memory and dq stays in registers;
//   * Q and dO are staged once per block, K and V once per key tile, all
//     transposed with a row stride of 65 floats so that the fills and the
//     inner-loop reads are free of bank conflicts; the dS·K product reads
//     the same transposed K tile, so K is staged once;
//   * each thread owns a 4x4 patch of S and dP (every value read from
//     shared memory feeds 4 FMAs) and a 4x(d/16) patch of dq;
//   * causal k tiles in the future are never loaded, and blocks are issued
//     heaviest (last query rows) first so the short tail fills the card.
// No atomics: each dq row is written by one block, so the result is
// deterministic.  Tensor-core (wgmma/TMA) versions are later work.
//
// Any tq, tk (ragged tiles masked here), 0 < d <= 128, float32 or bfloat16.
// The wrapper allocates dq and passes the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per tile
constexpr int TX = 16;              // threads along keys (S) and head dim (dq)
constexpr int TY = 16;              // threads along query rows
constexpr int NTHREADS = TX * TY;
constexpr int RQ = BQ / TY;         // rows per thread: ty + TY*i
constexpr int RK = BK / TX;         // keys per thread: tx + TX*j
constexpr int LDT = BQ + 1;         // padded stride of the transposed tiles and dS

static_assert(BQ == BK, "the transposed tiles share the padded stride LDT");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// NC: head-dim columns per thread, so the head dim is padded to DP = 16·NC.
template <typename T, int NC>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tk, int d, int causal, float scale) {
  constexpr int DP = NC * TX;
  extern __shared__ float smem[];
  float* Qt = smem;                 // [DP][LDT]  Q tile, transposed
  float* Dt = Qt + DP * LDT;        // [DP][LDT]  dO tile, transposed
  float* Kt = Dt + DP * LDT;        // [DP][LDT]  K tile, transposed
  float* Vt = Kt + DP * LDT;        // [DP][LDT]  V tile, transposed
  float* Ss = Vt + DP * LDT;        // [BQ][LDT]  ds of the current tile

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const size_t qbase = (size_t)bh * tq * d;
  const size_t kbase = (size_t)bh * tk * d;

  for (int i = tid; i < BQ * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP;
    float qx = 0.f, dx = 0.f;
    if (q0 + r < tq && c < d) {
      const size_t g = qbase + (size_t)(q0 + r) * d + c;
      qx = to_f32(q[g]);
      dx = to_f32(dout[g]);
    }
    Qt[c * LDT + r] = qx;
    Dt[c * LDT + r] = dx;
  }

  float lse_r[RQ], del_r[RQ], acc[RQ][NC];
  bool row_ok[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + TY * i;
    row_ok[i] = r < tq;
    lse_r[i] = row_ok[i] ? lse[(size_t)bh * tq + r] : 0.f;
    del_r[i] = row_ok[i] ? delta[(size_t)bh * tq + r] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // Keys past the tile's last row are in the future of every row in it.
  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's Kt/Vt/Ss reads are done
    for (int i = tid; i < BK * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < tk && c < d) {
        const size_t g = kbase + (size_t)(k0 + r) * d + c;
        kx = to_f32(k[g]);
        vx = to_f32(v[g]);
      }
      Kt[c * LDT + r] = kx;
      Vt[c * LDT + r] = vx;
    }
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float qa[RQ], da[RQ], kb[RK], vb[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qa[i] = Qt[c * LDT + ty + TY * i];
        da[i] = Dt[c * LDT + ty + TY * i];
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        kb[j] = Kt[c * LDT + tx + TX * j];
        vb[j] = Vt[c * LDT + tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kp = k0 + tx + TX * j;
        const bool masked = !row_ok[i] || kp >= tk || (causal && kp > qp);
        float ds = 0.f;   // a masked score is -1e30: p = 0, so ds = 0
        if (!masked) {
          const float p = expf(s[i][j] * scale - lse_r[i]);
          ds = p * (dp[i][j] - del_r[i]) * scale;
        }
        Ss[(ty + TY * i) * LDT + tx + TX * j] = to_f32(from_f32<T>(ds));
      }
    }
    __syncthreads();

    const int kn = min(BK, tk - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float kb[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kb[c] = Kt[(tx + TX * c) * LDT + kk];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float ds = Ss[(ty + TY * i) * LDT + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds, kb[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    if (!row_ok[i]) continue;
    const size_t row = qbase + (size_t)(q0 + ty + TY * i) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + TX * c;
      if (col < d) dq[row + col] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int tq, int tk, int d, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int DP = NC * TX;
  const int smem = (4 * DP * LDT + BQ * LDT) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<T, NC><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int tq, int tk, int d, int causal,
                     float scale, cudaStream_t s) {
  if (d <= 16) return launch<T, 1>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s);
  if (d <= 32) return launch<T, 2>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s);
  if (d <= 64) return launch<T, 4>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s);
  return launch<T, 8>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s);
}

}  // namespace

// q, dout, dq: contiguous (bh, tq, d); k, v: contiguous (bh, tk, d), all of
// one dtype (is_bf16 ? bfloat16 : float32); lse, delta: contiguous (bh, tq)
// float32.  Returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int tq,
                                 int tk, int d, int causal, int is_bf16,
                                 float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s)
              : dispatch<float>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s);
  return (int)err;
}

extern "C" const char* flash_attn_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
