// Flash-attention forward for Hopper (sm_90a) on the tensor cores: TMA loads
// through an mbarrier ring, wgmma products, the softmax in registers.
//
// Replaces the TPU kernel deeplearning4j_tpu/parallel/ring.py:_flash_kernel
// (launched by _flash_forward).  Same function:
//   S   = Q Kᵀ · scale from storage-dtype operands, f32 accumulation
//         (scale = f32(1/sqrt(d)) of the caller's unpadded d);
//   causal (top-left aligned): keys with k_pos > q_pos score -1e30 (here
//   -inf, which gives the same p = 0), and key tiles wholly in the future
//   are skipped;
//   online softmax with a running max m and a running sum l of the
//   unrounded f32 p; p is rounded to v's dtype before P·V (B1's
//   p.astype(v.dtype)), which accumulates in f32;
//   O = acc / max(l, 1e-30) in q's dtype; lse = m + log(max(l, 1e-30)) in
//   f32, natural log, shape (b·h, tq) (the TPU kernel replicates it over
//   128 lanes, a Mosaic layout rule the card does not have).
//
// What bounds it on the H100, at the main paths' shapes:
//   * bf16 training, b·h 32, t 2048, d 16, not causal: the exponentials.
//     One per score, 134M of them, on 16 special-function lanes per SM
//     (0.032 ms), while both products together are 4·d = 64 FLOPs per
//     score, 0.009 ms on the bf16 tensor cores.  So every instruction per
//     score beyond the exp counts: a score costs one FFMA (scale·log2(e)
//     and the running max folded into the exp2 argument), one MUFU.EX2, one
//     FMNMX and one FADD, and half a bf16x2 convert; the mask is applied
//     only in tiles that cross the diagonal or the ragged end.
//   * f32 serving, b·h 48, t 1024, d 64, causal: the products.  Float32 on
//     the CUDA cores peaks at 67 TFLOP/s; TF32 on the tensor cores at 495
//     but keeps 11 bits of mantissa, which would break float32 tolerances.
//     So each f32 operand x splits into hi = tf32(x) and lo = tf32(x - hi)
//     and each product is hi·hi + hi·lo + lo·hi with f32 accumulation (the
//     dropped lo·lo is 2^-22 of it): float32 accuracy at up to 495/3 = 165
//     TFLOP/s.
//
// Design (hopper.cuh holds the TMA, mbarrier and wgmma pieces):
//   * A block owns BQ = 64 query rows of one (b·h): one consumer warpgroup
//     (warps 0-3) and one producer warp (warp 4).  The producer's elected
//     thread loads the Q tile once, then keeps an NS-stage ring of K and V
//     tiles in flight with TMA, each stage completing on a "full" mbarrier
//     and returned by the consumers through an "empty" one.  The TPU's
//     sequential k grid axis becomes this loop; m, l and the O accumulator
//     stay in registers for the whole of it.  Several blocks share an SM,
//     so one block's softmax overlaps another's products.
//   * Tensor maps are 3-D (d, t, b·h): rows past t and columns past d read
//     as zeros, so a ragged tile never reads the next head's rows and the
//     head dim pads to the wgmma depth for free.  A row wider than 128
//     bytes is loaded as 128-byte column panels (128-byte swizzle); narrower
//     rows use the 32- or 64-byte swizzle of their own width.
//   * Key tiles: bf16 128 keys for d <= 64, 64 for d = 128 (the S and O
//     accumulators share the registers); f32 64 keys for d <= 32, 32 above,
//     so that two f32 blocks fit an SM's shared memory at d = 64.
//   * bf16: S = Q·Kᵀ is wgmma m64nBKk16 with Q and K K-major in shared
//     memory.  The f32 accumulator fragment of S is, pair by pair, the
//     A-register fragment of the next bf16 wgmma, so p is packed to bf16x2
//     in registers and O += P·V reads V's tile where TMA left it, as an
//     MN-major B operand (the transpose bit).  P never touches shared memory.
//   * f32: the same loop on tf32 wgmma.  Q (once) and each K tile are split
//     in shared memory: hi in place, lo beside it.  TF32 wgmma takes only
//     K-major operands, so V's tile is written transposed (d rows of keys),
//     split into hi and lo.  The f32 accumulator fragment of S holds keys
//     (2t, 2t+1) of each 8-key group where the tf32 A fragment wants (t,
//     t+4); rather than stage P through shared memory, the transposed V
//     stores its keys in that order (logical key t <- key 2t, t+4 <- 2t+1):
//     the sum over keys does not depend on their order, and the transpose
//     costs the same in any order.  P is then split in registers.
//   * Blocks run heaviest (last query rows) first so that the short causal
//     tail fills the card.
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
constexpr int NS = 3;                // K/V ring stages
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int DP>
struct Cfg {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int ELEM = sizeof(T);
  static constexpr int BK = BF16 ? (DP <= 64 ? 128 : 64) : (DP <= 32 ? 64 : 32);
  // f32 caps registers at three blocks an SM (136 a thread, no spills);
  // bf16 holds S of one tile and P of the last, and takes what it needs.
  static constexpr int MIN_BLOCKS = BF16 ? 1 : 3;
  static constexpr int ROWB = DP * ELEM;             // bytes of a padded row
  static constexpr int SW = ROWB < 128 ? ROWB : 128; // swizzle = TMA box row
  static constexpr int NP = ROWB / SW;               // column panels
  static constexpr int PCOLS = SW / ELEM;            // columns per panel
  static constexpr int Q_BYTES = BQ * ROWB;
  static constexpr int KV_BYTES = BK * ROWB;         // one K or V tile
  static constexpr int VT_BYTES = DP * BK * 4;       // f32: transposed V
  // f32 only, after the ring: Q lo, K lo, Vᵀ hi, Vᵀ lo.
  static constexpr int EXTRA = BF16 ? 0 : Q_BYTES + KV_BYTES + 2 * VT_BYTES;
  static constexpr int SMEM = Q_BYTES + 2 * NS * KV_BYTES + EXTRA
                              + 8 * (2 * NS + 1) + 1024;   // barriers, align
};

// One online-softmax step over a tile of raw scores s (the S accumulator
// fragment; k0 its first key, row the thread's first global row): masks
// where asked, updates the running max m and this thread's row sums l, and
// leaves p = exp(s·scale - m) in s and in corr the factor that rescales O.
// exp(x·scale - m) = 2^(x·c - m·c) with c = scale·log2(e): one FFMA and one
// MUFU.EX2 a score.  Two partial maxima and sums a row shorten the chains.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float c, bool mask, int k0,
                                             int row, int tk, int causal,
                                             int t4) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      if (key >= tk || (causal && key > row + 8 * ((i / 2) & 1)))
        s[i] = -INFINITY;
    }
  }
  float mx[2][2] = {{m[0], -INFINITY}, {m[1], -INFINITY}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h][j & 1] = fmaxf(mx[h][j & 1], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
  float moff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = fmaxf(mx[h][0], mx[h][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    moff[h] = x == -INFINITY ? 0.f : x * c;   // a row with no key yet
    corr[h] = ex2(m[h] * c - moff[h]);
    m[h] = x;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float& p0 = s[4 * j + 2 * h];
      float& p1 = s[4 * j + 2 * h + 1];
      p0 = ex2(fmaf(p0, c, -moff[h]));
      p1 = ex2(fmaf(p1, c, -moff[h]));
      sum[h][j & 1] += p0 + p1;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + (sum[h][0] + sum[h][1]);
}

template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS, Cfg<T, DP>::MIN_BLOCKS)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 T* __restrict__ o, float* __restrict__ lse, int tq, int tk,
                 int d, int causal, float scale) {
  using C = Cfg<T, DP>;
  constexpr int BK = C::BK, SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + C::Q_BYTES;                 // [NS][KV_BYTES]
  uint8_t* sV = sK + NS * C::KV_BYTES;           // [NS][KV_BYTES]
  uint8_t* sQlo = sV + NS * C::KV_BYTES;         // f32 only
  uint8_t* sKlo = sQlo + C::Q_BYTES;
  uint8_t* sVth = sKlo + C::KV_BYTES;
  uint8_t* sVtl = sVth + C::VT_BYTES;
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
      prefetch_tensor_map(&kmap);
      prefetch_tensor_map(&vmap);
      mbar_arrive_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p)
        tma_load_3d(sQ + p * BQ * SW, &qmap, qbar, p * C::PCOLS, q0, bh);
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

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of the raw scores
  float l[2] = {0.f, 0.f};               // this thread's part of the row sums
  float corr[2], sacc[BK / 2];
  // Only tiles that cross the diagonal or the ragged end of the keys mask.
  const auto masked = [&](int k0) {
    return k0 + BK > tk || (causal && k0 + BK - 1 > q0);
  };

  mbar_wait(qbar, 0);
  if constexpr (C::BF16) {
    // Software pipeline: S of tile i goes to the tensor cores with P·V of
    // tile i - 1, and the softmax of tile i runs while P·V is in flight.
    uint32_t pa[BK / 16][4];
    mbar_wait(&full[0], 0);
    wgmma_fence();
    mma_ss_bf16<BK, DP, SW>(sacc, sQ, sK, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(sacc);
    softmax_tile<BK>(sacc, m, l, corr, c, masked(0), 0, row, tk, causal, t4);
    pack_frags_bf16<BK>(pa, sacc);
    for (int it = 1; it < ntiles; ++it) {
      const int s = it % NS, sp = (it - 1) % NS;
      mbar_wait(&full[s], (it / NS) & 1);
      wgmma_fence();
      mma_ss_bf16<BK, DP, SW>(sacc, sQ, sK + s * C::KV_BYTES, false);
      wgmma_commit();
      mma_rs_bf16_tb<BK, DP, SW>(oacc, pa, sV + sp * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<BK / 2>(sacc);
      softmax_tile<BK>(sacc, m, l, corr, c, masked(it * BK), it * BK, row,
                       tk, causal, t4);
      wgmma_wait<0>();
      fence_regs<DP / 2>(oacc);
      fence_regs<BK / 4>(&pa[0][0]);
      mbar_arrive(&empty[sp]);
      rescale<DP>(oacc, corr);
      pack_frags_bf16<BK>(pa, sacc);
    }
    wgmma_fence();
    mma_rs_bf16_tb<BK, DP, SW>(oacc, pa, sV + ((ntiles - 1) % NS) * C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(oacc);
    fence_regs<BK / 4>(&pa[0][0]);
  } else {
    split_tf32<NCONS>(sQ, sQlo, C::Q_BYTES, tid);
    fence_proxy_async();
    named_bar_sync(1, NCONS);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % NS;
      uint8_t* kt = sK + s * C::KV_BYTES;
      mbar_wait(&full[s], (it / NS) & 1);
      // Every warp is past the last tile's products before K lo and Vᵀ
      // are overwritten.
      if (it > 0) named_bar_sync(1, NCONS);
      split_tf32<NCONS>(kt, sKlo, C::KV_BYTES, tid);
      transpose_split<DP, BK, SW, NCONS>(sV + s * C::KV_BYTES, sVth, sVtl,
                                         tid);
      fence_proxy_async();
      named_bar_sync(1, NCONS);
      // S = Q·Kᵀ as hi·hi + hi·lo + lo·hi, 8 of d a step.
      wgmma_fence();
      mma_ss_tf32x3<BK, DP, SW>(sacc, sQ, sQlo, kt, sKlo, false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(sacc);
      mbar_arrive(&empty[s]);   // K read, V already transposed
      softmax_tile<BK>(sacc, m, l, corr, c, masked(it * BK), it * BK, row,
                       tk, causal, t4);
      rescale<DP>(oacc, corr);
      // P·V, 8 keys a step: accumulator registers (2t, 2t+1) of rows g and
      // g + 8 are the A fragment's logical keys (t, t + 4).
      uint32_t ah[BK / 8][4], al[BK / 8][4];
      split_frags_tf32<BK>(ah, al, sacc);
      wgmma_fence();
      mma_rs_tf32x3<BK, DP>(oacc, ah, al, sVth, sVtl);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DP / 2>(oacc);
      fence_regs<BK / 2>(&ah[0][0]);
      fence_regs<BK / 2>(&al[0][0]);
    }
  }

  const size_t obase = (size_t)bh * tq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = row + 8 * h;
    if (r >= tq) continue;
    const float lf = fmaxf(lt, 1e-30f);
    T* orow = o + (obase + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < d)
        store2(orow + col, oacc[4 * j + 2 * h] / lf,
               oacc[4 * j + 2 * h + 1] / lf);
    }
    if (t4 == 0) lse[obase + r] = m[h] * scale + logf(lf);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int d, int causal,
                   float scale, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  CUtensorMap qm, km, vm;
  cudaError_t err;
  if ((err = tensor_map_3d(&qm, q, C::ELEM, d, tq, bh, C::PCOLS, BQ, C::SW)) ||
      (err = tensor_map_3d(&km, k, C::ELEM, d, tk, bh, C::PCOLS, C::BK, C::SW)) ||
      (err = tensor_map_3d(&vm, v, C::ELEM, d, tk, bh, C::PCOLS, C::BK, C::SW)))
    return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, DP><<<grid, NTHREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<T*>(o), static_cast<float*>(lse), tq, tk, d,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int tq, int tk, int d, int causal,
                     float scale, cudaStream_t s) {
  if (d <= 16) return launch<T, 16>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s);
  if (d <= 32) return launch<T, 32>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s);
  return launch<T, 128>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s);
}

}  // namespace

// q, k, v: contiguous (bh, tq|tk, d) of one dtype (is_bf16 ? bfloat16 :
// float32), 16-byte aligned, d · elem a multiple of 16 bytes; o: (bh, tq, d)
// of that dtype; lse: (bh, tq) float32; scale: the softmax scale.  Returns
// the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int tq, int tk,
                              int d, int causal, int is_bf16, float scale,
                              void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 ||
      (d * elem) % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s)
              : dispatch<float>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s);
  return (int)err;
}

extern "C" const char* flash_attn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
