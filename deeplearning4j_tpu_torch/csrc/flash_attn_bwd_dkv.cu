// Flash-attention backward, dk/dv pass, for Hopper (sm_90a), FP32 FMA on
// the CUDA cores.
//
// Replaces the TPU kernel deeplearning4j_tpu/parallel/ring.py:
// _flash_bwd_dkv_kernel (launched by _flash_backward).  Same function, for
// key j of one (b·h) and every query row i:
//   s_ij, p_ij = exp(s_ij − lse_i), dp_ij = dO_i · v_j and
//   ds_ij = p_ij · (dp_ij − δ_i) · scale are recomputed exactly as in the dq
//   pass (csrc/flash_attn_bwd_dq.cu), causal top-left aligned;
//   dv_j = Σ_i p_ij · dO_i with p rounded to dO's dtype (p.astype(do.dtype));
//   dk_j = Σ_i ds_ij · q_i with ds rounded to q's dtype (ds.astype(q.dtype));
//   both accumulated in f32 and stored in k's and v's dtype.
// lse and δ are (b·h, tq) f32 (the TPU's 128-lane replication dropped).
//
// What bounds it on the H100: operations.  Four products of 2·tq·tk·d FLOPs
// each (KQᵀ, V·dOᵀ, Pᵀ·dO, dSᵀ·Q) and tq·tk exps, against (2·tq + 4·tk)·d
// elements and two f32 rows moved.  This first version runs the products as
// FP32 FMAs (67 TFLOP/s peak), not on the tensor cores.  What the design
// does about the bound:
//   * the TPU carries dk_acc/dv_acc across a sequential q grid axis; here a
//     block owns 64 keys of one (b·h) and loops over 64-row query tiles
//     itself, keeping both accumulators in registers for the whole loop;
//   * K and V are staged once per block, Q and dO once per query tile, all
//     transposed with a row stride of 65 floats (bank-conflict free); the
//     Pᵀ·dO and dSᵀ·Q products read the same transposed Q and dO tiles;
//   * each thread owns a 4x4 patch of Sᵀ and dPᵀ and a 4x(d/16) patch of
//     dk and of dv;
//   * causal: query tiles wholly before the key tile see none of its keys
//     and are never loaded; blocks are issued in key order, which is
//     heaviest first.
// No atomics: each dk/dv row is written by one block, so the result is
// deterministic.  Tensor-core (wgmma/TMA) versions are later work.
//
// Any tq, tk (ragged tiles masked here), 0 < d <= 128, float32 or bfloat16.
// The wrapper allocates dk and dv and passes the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 64;              // keys per block
constexpr int BQ = 64;              // query rows per tile
constexpr int TX = 16;              // threads along query rows (S) and head dim
constexpr int TY = 16;              // threads along keys
constexpr int NTHREADS = TX * TY;
constexpr int RK = BK / TY;         // keys per thread: ty + TY*i
constexpr int RQ = BQ / TX;         // query rows per thread: tx + TX*j
constexpr int LDT = BK + 1;         // padded stride of the transposed tiles, P and dS

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
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, int d, int causal,
                     float scale) {
  constexpr int DP = NC * TX;
  extern __shared__ float smem[];
  float* Kt = smem;                 // [DP][LDT]  K tile, transposed
  float* Vt = Kt + DP * LDT;        // [DP][LDT]  V tile, transposed
  float* Qt = Vt + DP * LDT;        // [DP][LDT]  Q tile, transposed
  float* Dt = Qt + DP * LDT;        // [DP][LDT]  dO tile, transposed
  float* Ps = Dt + DP * LDT;        // [BK][LDT]  p in dO's dtype, [key][row]
  float* Ss = Ps + BK * LDT;        // [BK][LDT]  ds in q's dtype, [key][row]
  float* Ls = Ss + BK * LDT;        // [BQ]       lse of the tile's rows
  float* Es = Ls + BQ;              // [BQ]       δ of the tile's rows

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t qbase = (size_t)bh * tq * d;
  const size_t kbase = (size_t)bh * tk * d;

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

  float dka[RK][NC], dva[RK][NC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // Query tiles that end before k0 see no key of this block (BQ == BK, so
  // the first tile that does starts at k0).
  for (int q0 = causal ? k0 : 0; q0 < tq; q0 += BQ) {
    __syncthreads();   // the previous tile's Qt/Dt/Ps/Ss/Ls/Es reads are done
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
    if (tid < BQ) {
      const bool ok = q0 + tid < tq;
      Ls[tid] = ok ? lse[(size_t)bh * tq + q0 + tid] : 0.f;
      Es[tid] = ok ? delta[(size_t)bh * tq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[RK][RQ], dp[RK][RQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float ka[RK], va[RK], qb[RQ], db[RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        ka[i] = Kt[c * LDT + ty + TY * i];
        va[i] = Vt[c * LDT + ty + TY * i];
      }
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        qb[j] = Qt[c * LDT + tx + TX * j];
        db[j] = Dt[c * LDT + tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
          dp[i][j] = fmaf(va[i], db[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int kp = k0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int r = tx + TX * j;
        const int qp = q0 + r;
        const bool masked = kp >= tk || qp >= tq || (causal && kp > qp);
        float p = 0.f, ds = 0.f;   // a masked score is -1e30: p = 0
        if (!masked) {
          p = expf(s[i][j] * scale - Ls[r]);
          ds = p * (dp[i][j] - Es[r]) * scale;
        }
        Ps[(ty + TY * i) * LDT + r] = to_f32(from_f32<T>(p));
        Ss[(ty + TY * i) * LDT + r] = to_f32(from_f32<T>(ds));
      }
    }
    __syncthreads();

    const int qn = min(BQ, tq - q0);
#pragma unroll 4
    for (int qq = 0; qq < qn; ++qq) {
      float qv[NC], dov[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        qv[c] = Qt[(tx + TX * c) * LDT + qq];
        dov[c] = Dt[(tx + TX * c) * LDT + qq];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float p = Ps[(ty + TY * i) * LDT + qq];
        const float ds = Ss[(ty + TY * i) * LDT + qq];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dva[i][c] = fmaf(p, dov[c], dva[i][c]);
          dka[i][c] = fmaf(ds, qv[c], dka[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = k0 + ty + TY * i;
    if (r >= tk) continue;
    const size_t row = kbase + (size_t)r * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + TX * c;
      if (col < d) {
        dk[row + col] = from_f32<T>(dka[i][c]);
        dv[row + col] = from_f32<T>(dva[i][c]);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int bh, int tq, int tk, int d,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int DP = NC * TX;
  const int smem =
      (4 * DP * LDT + 2 * BK * LDT + 2 * BQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tk + BK - 1) / BK, bh);
  flash_bwd_dkv_kernel<T, NC><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int bh, int tq, int tk, int d,
                     int causal, float scale, cudaStream_t s) {
  if (d <= 16) return launch<T, 1>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s);
  if (d <= 32) return launch<T, 2>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s);
  if (d <= 64) return launch<T, 4>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s);
  return launch<T, 8>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s);
}

}  // namespace

// q, dout: contiguous (bh, tq, d); k, v, dk, dv: contiguous (bh, tk, d), all
// of one dtype (is_bf16 ? bfloat16 : float32); lse, delta: contiguous
// (bh, tq) float32.  Returns the launch's cudaError_t (0 on success); does
// not synchronise.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int tq, int tk, int d, int causal,
                                  int is_bf16, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s)
              : dispatch<float>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s);
  return (int)err;
}

extern "C" const char* flash_attn_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
