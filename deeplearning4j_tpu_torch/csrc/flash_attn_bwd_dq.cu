// Flash-attention backward, dq pass, for Hopper (sm_90a) on the tensor
// cores: TMA loads through an mbarrier ring, wgmma products, ds in registers.
//
// Replaces the TPU kernel deeplearning4j_tpu/parallel/ring.py:
// _flash_bwd_dq_kernel (launched by _flash_backward).  Same function, for
// query row i of one (b·h) and every key j:
//   s_ij  = (q_i · k_j) · scale, accumulated in f32 (scale = f32(1/sqrt(d))
//   of the caller's unpadded d);
//   causal (top-left aligned): s_ij = -1e30 for j > i (here p_ij = 0, the
//   same), and key tiles wholly in the future of the query tile are skipped;
//   p_ij  = exp(s_ij − lse_i), lse_i the forward's per-row logsumexp (f32);
//   dp_ij = dO_i · v_j, accumulated in f32;
//   ds_ij = p_ij · (dp_ij − δ_i) · scale, δ_i = rowsum(dO_i ⊙ O_i) in f32
//   (computed outside the kernel, as the reference does);
//   dq_i  = Σ_j ds_ij · k_j with ds rounded to k's dtype first (the
//   reference's ds.astype(k.dtype)), accumulated in f32, stored in q's dtype.
// lse and δ are (b·h, tq) f32: the TPU kernel replicates them over 128
// lanes, a Mosaic layout rule the card does not have.
//
// What bounds it on the H100, at the attention net's training shape (b·h 32,
// t 2048, d 16, bf16): the exponentials, one per score (134M, 0.032 ms on
// the 16 special-function lanes of 132 SMs), as in the forward.  The three
// products are 6·d = 96 FLOPs a score, 0.014 ms on the bf16 tensor cores.
// So the score loop is kept short: p = 2^(s·scale·log2 e − lse·log2 e) is
// one FFMA and one MUFU.EX2, ds = p·(dp·scale − δ·scale) an FFMA and an
// FMUL, and the mask runs only on tiles that cross the diagonal or the
// ragged end of the keys.  In
// float32 the products bound it instead: they run as split TF32 (x = hi +
// lo, hi·hi + hi·lo + lo·hi, float32 accuracy at 495/3 TFLOP/s) rather than
// on the CUDA cores' 67 TFLOP/s.
//
// Design (hopper.cuh holds the TMA, mbarrier and wgmma pieces and the tile
// products, shared with the forward csrc/flash_attn_fwd.cu):
//   * A block owns BQ = 64 query rows of one (b·h): one consumer warpgroup
//     (warps 0-3) and one producer warp (warp 4).  The producer's elected
//     thread loads the Q and dO tiles once, then keeps an NS-stage ring of
//     K and V tiles in flight.  The TPU's sequential k grid axis becomes
//     this loop; dq stays in registers for the whole of it.  lse and δ of
//     the thread's two rows are read once, with ordinary loads.
//   * Tensor maps are 3-D (d, t, b·h): rows past t and columns past d read
//     as zeros, so ragged tiles and the padded head dim cost nothing.  A
//     zero K row adds nothing to dq; the mask still zeroes p past tk, where
//     exp(0 − lse) may overflow.
//   * bf16: S = Q·Kᵀ and dP = dO·Vᵀ are wgmma m64nBKk16 with every operand
//     K-major in shared memory.  ds is computed on the accumulator fragment
//     and packed to bf16 pairs in registers as the A operand of dQ += dS·K,
//     which reads K's tile where TMA left it as an MN-major B operand (the
//     transpose bit): ds never touches shared memory.  S and dP of tile i go
//     to the tensor cores with dS·K of tile i − 1, and ds of tile i is
//     computed while that product is in flight (at d 16 this still leaves
//     three blocks an SM, and it measured faster than one tile at a time).
//   * f32: the same loop on tf32 wgmma, each product in three (hi·hi +
//     hi·lo + lo·hi).  Q and dO (once) and each K and V tile are split in
//     shared memory (hi in place, lo beside it).  TF32 wgmma takes only
//     K-major operands, so K's tile is also written transposed (d rows of
//     keys), split, its keys of each group of 8 in the order (0, 2, 4, 6, 1,
//     3, 5, 7) in which the accumulator holds them: ds is split in registers.
//   * Blocks run heaviest (last query rows) first, so that the short causal
//     tail fills the card.
// No atomics: each dq row is written by one block, so the result is
// deterministic.
//
// Any tq, tk; d <= 128 with d · elem a multiple of 16 bytes and 16-byte
// aligned bases (the wrapper pads and copies otherwise); float32 or bfloat16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;               // query rows per block
constexpr int NCONS = 128;           // consumer threads: one warpgroup
constexpr int NTHREADS = NCONS + 32; // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int DP>
struct Cfg {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int ELEM = sizeof(T);
  // Key tile: f32 shrinks it so that the splits fit shared memory at d 128.
  static constexpr int BK = BF16 ? 64 : (DP <= 16 ? 64 : DP <= 32 ? 32 : 16);
  static constexpr int NS = (BF16 ? DP <= 64 : DP <= 32) ? 3 : 2;
  static constexpr int ROWB = DP * ELEM;             // bytes of a padded row
  static constexpr int SW = ROWB < 128 ? ROWB : 128; // swizzle = TMA box row
  static constexpr int NP = ROWB / SW;               // column panels
  static constexpr int PCOLS = SW / ELEM;            // columns per panel
  static constexpr int Q_BYTES = BQ * ROWB;          // the Q or the dO tile
  static constexpr int KV_BYTES = BK * ROWB;         // one K or V tile
  static constexpr int KT_BYTES = DP * BK * 4;       // f32: Kᵀ hi or lo
  // f32 only, after the ring: Q lo, dO lo, K lo, V lo, Kᵀ hi, Kᵀ lo.
  static constexpr int EXTRA =
      BF16 ? 0 : 2 * Q_BYTES + 2 * KV_BYTES + 2 * KT_BYTES;
  static constexpr int SMEM = 2 * Q_BYTES + 2 * NS * KV_BYTES + EXTRA
                              + 8 * (2 * NS + 1) + 1024;   // barriers, align
  static_assert(SMEM <= 232448, "a block must fit the opt-in shared memory");
};

// ds = p·(dp − δ)·scale on the S and dP accumulator fragments of one key
// tile (k0 its first key, row the thread's first row), p = exp(s·scale −
// lse) = 2^(s·c + nl) with c = scale·log2 e and nl = −lse·log2 e of the
// row, and ds = p·(dp·scale − dl) with dl = δ·scale of the row: an FFMA, an
// EX2, an FFMA and an FMUL a score (the same value as the reference's
// p·(dp − δ)·scale up to f32 rounding).  Where asked, keys past tk and
// (causal) keys after the row get p = 0.  Leaves ds in s.
template <int BK>
__device__ __forceinline__ void ds_tile(float (&s)[BK / 2],
                                        const float (&dp)[BK / 2],
                                        const float (&nl)[2],
                                        const float (&dl)[2], float c,
                                        float scale, bool mask, int k0,
                                        int row, int tk, int causal, int t4) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i / 2) & 1;
    float p = ex2(fmaf(s[i], c, nl[h]));
    if (mask) {
      const int key = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      if (key >= tk || (causal && key > row + 8 * h)) p = 0.f;
    }
    s[i] = p * fmaf(dp[i], scale, -dl[h]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tk, int d, int causal, float scale) {
  using C = Cfg<T, DP>;
  constexpr int BK = C::BK, SW = C::SW, NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sD = sQ + C::Q_BYTES;                 // dO
  uint8_t* sK = sD + C::Q_BYTES;                 // [NS][KV_BYTES]
  uint8_t* sV = sK + NS * C::KV_BYTES;           // [NS][KV_BYTES]
  uint8_t* sQlo = sV + NS * C::KV_BYTES;         // f32 only
  uint8_t* sDlo = sQlo + C::Q_BYTES;
  uint8_t* sKlo = sDlo + C::Q_BYTES;
  uint8_t* sVlo = sKlo + C::KV_BYTES;
  uint8_t* sKth = sVlo + C::KV_BYTES;
  uint8_t* sKtl = sKth + C::KT_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NS * C::KV_BYTES + C::EXTRA);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  // Keys past the tile's last row are in the future of every row in it.
  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  const int ntiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // Producer warp: one thread issues every copy.
    if (threadIdx.x == NCONS) {
      prefetch_tensor_map(&qmap);
      prefetch_tensor_map(&dmap);
      prefetch_tensor_map(&kmap);
      prefetch_tensor_map(&vmap);
      mbar_arrive_expect_tx(qbar, 2 * C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p) {
        tma_load_3d(sQ + p * BQ * SW, &qmap, qbar, p * C::PCOLS, q0, bh);
        tma_load_3d(sD + p * BQ * SW, &dmap, qbar, p * C::PCOLS, q0, bh);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(&empty[s], ((it / NS) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
        uint8_t* kt = sK + s * C::KV_BYTES;
        uint8_t* vt = sV + s * C::KV_BYTES;
#pragma unroll
        for (int p = 0; p < C::NP; ++p) {
          tma_load_3d(kt + p * BK * SW, &kmap, &full[s], p * C::PCOLS,
                      it * BK, bh);
          tma_load_3d(vt + p * BK * SW, &vmap, &full[s], p * C::PCOLS,
                      it * BK, bh);
        }
      }
    }
    return;
  }

  // Consumer warpgroup.  Thread (warp w, lane = 4g + t) holds rows
  // row = q0 + 16w + g and row + 8 of every accumulator, columns 8j + 2t
  // and 8j + 2t + 1.
  const int tid = threadIdx.x;
  const int t4 = tid % 4;
  const int row = q0 + (tid / 32) * 16 + (tid % 32) / 4;
  const float c = scale * LOG2E;
  float nl[2], dl[2];     // −lse·log2 e and δ·scale of the two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    nl[h] = r < tq ? -lse[(size_t)bh * tq + r] * LOG2E : -INFINITY;
    dl[h] = r < tq ? delta[(size_t)bh * tq + r] * scale : 0.f;
  }

  float dqacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqacc[i] = 0.f;
  float sacc[BK / 2], pacc[BK / 2];
  // Only tiles that cross the diagonal or the ragged end of the keys mask.
  const auto masked = [&](int k0) {
    return k0 + BK > tk || (causal && k0 + BK - 1 > q0);
  };

  mbar_wait(qbar, 0);
  if constexpr (C::BF16) {
    uint32_t da[BK / 16][4];
    mbar_wait(&full[0], 0);
    wgmma_fence();
    mma_ss_bf16<BK, DP, SW>(sacc, sQ, sK, false);
    mma_ss_bf16<BK, DP, SW>(pacc, sD, sV, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(sacc);
    fence_regs<BK / 2>(pacc);
    ds_tile<BK>(sacc, pacc, nl, dl, c, scale, masked(0), 0, row, tk, causal,
                t4);
    pack_frags_bf16<BK>(da, sacc);
    for (int it = 1; it < ntiles; ++it) {
      const int s = it % NS, sp = (it - 1) % NS;
      mbar_wait(&full[s], (it / NS) & 1);
      wgmma_fence();
      mma_ss_bf16<BK, DP, SW>(sacc, sQ, sK + s * C::KV_BYTES, false);
      mma_ss_bf16<BK, DP, SW>(pacc, sD, sV + s * C::KV_BYTES, false);
      wgmma_commit();
      mma_rs_bf16_tb<BK, DP, SW>(dqacc, da, sK + sp * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<BK / 2>(sacc);
      fence_regs<BK / 2>(pacc);
      ds_tile<BK>(sacc, pacc, nl, dl, c, scale, masked(it * BK), it * BK,
                  row, tk, causal, t4);
      wgmma_wait<0>();
      fence_regs<DP / 2>(dqacc);
      fence_regs<BK / 4>(&da[0][0]);
      mbar_arrive(&empty[sp]);
      pack_frags_bf16<BK>(da, sacc);
    }
    wgmma_fence();
    mma_rs_bf16_tb<BK, DP, SW>(dqacc, da, sK + ((ntiles - 1) % NS) * C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dqacc);
    fence_regs<BK / 4>(&da[0][0]);
  } else {
    split_tf32<NCONS>(sQ, sQlo, C::Q_BYTES, tid);
    split_tf32<NCONS>(sD, sDlo, C::Q_BYTES, tid);
    fence_proxy_async();
    named_bar_sync(1, NCONS);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % NS;
      uint8_t* kt = sK + s * C::KV_BYTES;
      uint8_t* vt = sV + s * C::KV_BYTES;
      mbar_wait(&full[s], (it / NS) & 1);
      // Every warp is past the last tile's products before the lo and
      // transposed buffers are overwritten.
      if (it > 0) named_bar_sync(1, NCONS);
      transpose_split<DP, BK, SW, NCONS>(kt, sKth, sKtl, tid);
      split_tf32<NCONS>(vt, sVlo, C::KV_BYTES, tid);
      named_bar_sync(1, NCONS);   // all of K read before it is split
      split_tf32<NCONS>(kt, sKlo, C::KV_BYTES, tid);
      fence_proxy_async();
      named_bar_sync(1, NCONS);
      wgmma_fence();
      mma_ss_tf32x3<BK, DP, SW>(sacc, sQ, sQlo, kt, sKlo, false);
      mma_ss_tf32x3<BK, DP, SW>(pacc, sD, sDlo, vt, sVlo, false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(sacc);
      fence_regs<BK / 2>(pacc);
      mbar_arrive(&empty[s]);   // K and V read; Kᵀ is a copy
      ds_tile<BK>(sacc, pacc, nl, dl, c, scale, masked(it * BK), it * BK,
                  row, tk, causal, t4);
      uint32_t ah[BK / 8][4], al[BK / 8][4];
      split_frags_tf32<BK>(ah, al, sacc);
      wgmma_fence();
      mma_rs_tf32x3<BK, DP>(dqacc, ah, al, sKth, sKtl);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DP / 2>(dqacc);
      fence_regs<BK / 2>(&ah[0][0]);
      fence_regs<BK / 2>(&al[0][0]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= tq) continue;
    T* out = dq + ((size_t)bh * tq + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < d) store2(out + col, dqacc[4 * j + 2 * h], dqacc[4 * j + 2 * h + 1]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int tq, int tk, int d, int causal,
                   float scale, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  CUtensorMap qm, km, vm, dm;
  cudaError_t err;
  if ((err = tensor_map_3d(&qm, q, C::ELEM, d, tq, bh, C::PCOLS, BQ, C::SW)) ||
      (err = tensor_map_3d(&dm, dout, C::ELEM, d, tq, bh, C::PCOLS, BQ, C::SW)) ||
      (err = tensor_map_3d(&km, k, C::ELEM, d, tk, bh, C::PCOLS, C::BK, C::SW)) ||
      (err = tensor_map_3d(&vm, v, C::ELEM, d, tk, bh, C::PCOLS, C::BK, C::SW)))
    return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<T, DP><<<grid, NTHREADS, C::SMEM, stream>>>(
      qm, km, vm, dm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), tq, tk, d,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int tq, int tk, int d, int causal,
                     float scale, cudaStream_t s) {
  if (d <= 16) return launch<T, 16>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s);
  if (d <= 32) return launch<T, 32>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s);
  if (d <= 64) return launch<T, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s);
  return launch<T, 128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, causal, scale, s);
}

}  // namespace

// q, dout, dq: contiguous (bh, tq, d); k, v: contiguous (bh, tk, d), all of
// one dtype (is_bf16 ? bfloat16 : float32), 16-byte aligned, d · elem a
// multiple of 16 bytes; lse, delta: contiguous (bh, tq) float32; scale: the
// softmax scale.  Returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int tq,
                                 int tk, int d, int causal, int is_bf16,
                                 float scale, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 ||
      (d * elem) % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
        reinterpret_cast<uintptr_t>(dq)) & 15) != 0)
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
