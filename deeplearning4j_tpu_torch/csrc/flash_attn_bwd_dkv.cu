// Flash-attention backward, dk/dv pass, for Hopper (sm_90a) on the tensor
// cores: TMA loads through an mbarrier ring, wgmma products, pᵀ and dsᵀ in
// registers.
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
// What bounds it on the H100, at the attention net's training shape (b·h 32,
// t 2048, d 16, bf16): the exponentials, one per score, 0.032 ms, as in the
// dq pass; the four products are 8·d = 128 FLOPs a score (0.018 ms on the
// bf16 tensor cores).  In float32 the products bound it: split TF32, as in
// the dq pass.
//
// Design (hopper.cuh holds the TMA, mbarrier and wgmma pieces and the tile
// products):
//   * A block owns BK = 64 keys of one (b·h): one consumer warpgroup and one
//     producer warp.  The producer's elected thread loads the K and V tiles
//     once, then keeps an NS-stage ring of Q and dO tiles of BN query rows
//     in flight.  The TPU's sequential q grid axis becomes this loop; dk and
//     dv stay in registers for the whole of it.
//   * Keys are the M dimension: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are wgmma
//     m64nBNk16 with every operand K-major, so the thread's registers hold
//     pᵀ and dsᵀ as rows of keys, which is the register A fragment of dV +=
//     Pᵀ·dO and dK += dSᵀ·Q.  Those read dO's and Q's tiles where TMA left
//     them, as MN-major B operands (the transpose bit).  Neither pᵀ nor dsᵀ
//     touches shared memory.  The query tile is wgmma's N: it shrinks at
//     d 128 so that the dK and dV accumulators fit beside Sᵀ and dPᵀ.
//   * lse and δ now index the accumulator's columns, BN/2 of each a thread
//     and tile: the consumers stage the tile's rows in shared memory (one
//     value a thread, loaded a tile ahead with an ordinary load, since a
//     (b·h, tq) f32 row of a ragged tq cannot be TMA-mapped), double
//     buffered, behind the barrier of the tile.
//   * bf16: one tile at a time (Sᵀ and dPᵀ, then pᵀ and dsᵀ, then dV and
//     dK).  Issuing Sᵀ and dPᵀ of tile i with dV and dK of tile i − 1, as
//     the dq pass does, keeps both tiles' fragments live; at d 16 that
//     leaves room for one block fewer on an SM, and it measured slower.
//   * f32: the same loop on tf32 wgmma, each product in three (hi·hi +
//     hi·lo + lo·hi).  K and V (once) and each Q and dO tile are split in
//     shared memory (hi in place, lo beside it); Q's and dO's tiles are also
//     written transposed and split, queries of each group of 8 in the order
//     (0, 2, 4, 6, 1, 3, 5, 7) in which the accumulator holds them.
//   * Ragged ends: rows past t read as zeros, so a query row past tq adds
//     nothing (its Q and dO rows are zero) and a key row past tk is not
//     stored.  Causal: query tiles wholly before the key block are never
//     loaded, and a key block that no query sees (keys past tq − 1) loads
//     nothing and writes zeros.  Blocks are issued in key order, which is
//     heaviest first.
// No atomics: each dk/dv row is written by one block, so the result is
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

constexpr int BK = 64;               // keys per block
constexpr int NCONS = 128;           // consumer threads: one warpgroup
constexpr int NTHREADS = NCONS + 32; // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int DP>
struct Cfg {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int ELEM = sizeof(T);
  // Query rows a tile (wgmma's N): smaller where dK and dV take more
  // registers (bf16 d 128) or the splits more shared memory (f32).
  static constexpr int BN = BF16 ? (DP <= 64 ? 64 : 32)
                                 : (DP <= 16 ? 64 : DP <= 32 ? 32 : 16);
  static constexpr int NS = (BF16 || DP <= 32) ? 3 : 2;
  static constexpr int ROWB = DP * ELEM;             // bytes of a padded row
  static constexpr int SW = ROWB < 128 ? ROWB : 128; // swizzle = TMA box row
  static constexpr int NP = ROWB / SW;               // column panels
  static constexpr int PCOLS = SW / ELEM;            // columns per panel
  static constexpr int K_BYTES = BK * ROWB;          // the K or the V tile
  static constexpr int Q_BYTES = BN * ROWB;          // one Q or dO tile
  static constexpr int QT_BYTES = DP * BN * 4;       // f32: a transposed tile
  // f32 only, after the ring: K lo, V lo, Q lo, dO lo, Qᵀ and dOᵀ hi, lo.
  static constexpr int EXTRA =
      BF16 ? 0 : 2 * K_BYTES + 2 * Q_BYTES + 4 * QT_BYTES;
  static constexpr int ROWS_BYTES = 2 * 2 * BN * 4;  // staged lse, δ: 2 tiles
  static constexpr int SMEM = 2 * K_BYTES + 2 * NS * Q_BYTES + EXTRA
                              + ROWS_BYTES + 8 * (2 * NS + 1) + 1024;
  static_assert(SMEM <= 232448, "a block must fit the opt-in shared memory");
};

// pᵀ = exp(sᵀ·scale − lse) and dsᵀ = pᵀ·(dpᵀ − δ)·scale on the Sᵀ and dPᵀ
// accumulator fragments of one query tile (rows are keys, key the thread's
// first; columns are queries from q0).  nl (−lse·log2 e) and dl (δ·scale)
// are the tile's staged rows, by column; c = scale·log2 e, and ds = p·(dp·
// scale − dl), as in the dq pass.  Where asked (causal tiles that cross the
// diagonal), keys after the query get p = 0.  Leaves pᵀ in s and dsᵀ in dp.
template <int BN>
__device__ __forceinline__ void ds_tile_t(float (&s)[BN / 2],
                                          float (&dp)[BN / 2],
                                          const float* nl, const float* dl,
                                          float c, float scale, bool mask,
                                          int key, int q0, int t4) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 l = *reinterpret_cast<const float2*>(nl + col);
    const float2 e = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = 4 * j + 2 * h + x;
        float p = ex2(fmaf(s[i], c, x ? l.y : l.x));
        if (mask && key + 8 * h > q0 + col + x) p = 0.f;
        s[i] = p;
        dp[i] = p * fmaf(dp[i], scale, -(x ? e.y : e.x));
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dmap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, int d, int causal,
                     float scale) {
  using C = Cfg<T, DP>;
  constexpr int BN = C::BN, SW = C::SW, NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + C::K_BYTES;
  uint8_t* sQ = sV + C::K_BYTES;                 // [NS][Q_BYTES]
  uint8_t* sD = sQ + NS * C::Q_BYTES;            // [NS][Q_BYTES], dO
  uint8_t* sKlo = sD + NS * C::Q_BYTES;          // f32 only
  uint8_t* sVlo = sKlo + C::K_BYTES;
  uint8_t* sQlo = sVlo + C::K_BYTES;
  uint8_t* sDlo = sQlo + C::Q_BYTES;
  uint8_t* sQth = sDlo + C::Q_BYTES;
  uint8_t* sQtl = sQth + C::QT_BYTES;
  uint8_t* sDth = sQtl + C::QT_BYTES;
  uint8_t* sDtl = sDth + C::QT_BYTES;
  float* sRows = reinterpret_cast<float*>(sD + NS * C::Q_BYTES + C::EXTRA);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sRows) + C::ROWS_BYTES);
  uint64_t* empty = full + NS;
  uint64_t* kvbar = empty + NS;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  // Causal: query tiles before the one holding query k0 see no key here.
  const int first = causal ? k0 / BN : 0;
  const int ntiles = max((tq + BN - 1) / BN - first, 0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // Producer warp: one thread issues every copy.
    if (threadIdx.x == NCONS && ntiles > 0) {
      prefetch_tensor_map(&kmap);
      prefetch_tensor_map(&vmap);
      prefetch_tensor_map(&qmap);
      prefetch_tensor_map(&dmap);
      mbar_arrive_expect_tx(kvbar, 2 * C::K_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p) {
        tma_load_3d(sK + p * BK * SW, &kmap, kvbar, p * C::PCOLS, k0, bh);
        tma_load_3d(sV + p * BK * SW, &vmap, kvbar, p * C::PCOLS, k0, bh);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(&empty[s], ((it / NS) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::Q_BYTES);
        uint8_t* qt = sQ + s * C::Q_BYTES;
        uint8_t* dt = sD + s * C::Q_BYTES;
        const int r0 = (first + it) * BN;
#pragma unroll
        for (int p = 0; p < C::NP; ++p) {
          tma_load_3d(qt + p * BN * SW, &qmap, &full[s], p * C::PCOLS, r0,
                      bh);
          tma_load_3d(dt + p * BN * SW, &dmap, &full[s], p * C::PCOLS, r0,
                      bh);
        }
      }
    }
    return;
  }

  // Consumer warpgroup.  Thread (warp w, lane = 4g + t) holds keys
  // key = k0 + 16w + g and key + 8 of every accumulator (rows), queries
  // 8j + 2t and 8j + 2t + 1 of the tile (columns) or columns of d.
  const int tid = threadIdx.x;
  const int t4 = tid % 4;
  const int key = k0 + (tid / 32) * 16 + (tid % 32) / 4;
  const float c = scale * LOG2E;

  float dkacc[DP / 2], dvacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

  if (ntiles > 0) {
    // Thread tid < BN stages −lse·log2 e of the tile's query tid, thread
    // BN + i its δ·scale; a query past tq gets p = 0.
    const size_t rbase = (size_t)bh * tq;
    const auto row_value = [&](int it) {
      const int qi = (first + it) * BN + tid % BN;
      if (tid < BN) return qi < tq ? -lse[rbase + qi] * LOG2E : -INFINITY;
      return qi < tq ? delta[rbase + qi] * scale : 0.f;
    };
    const bool stager = tid < 2 * BN;
    float next = stager ? row_value(0) : 0.f;
    // Stages tile it's rows (after the barrier of tile it − 1, every thread
    // is done with the buffer's last use, tile it − 2) and loads the next.
    const auto stage = [&](int it) {
      if (stager) {
        sRows[(it & 1) * 2 * BN + tid] = next;
        if (it + 1 < ntiles) next = row_value(it + 1);
      }
    };
    const auto rows_of = [&](int it) { return sRows + (it & 1) * 2 * BN; };
    const auto masked = [&](int q0) {
      return causal && q0 < k0 + BK - 1;
    };
    float sacc[BN / 2], pacc[BN / 2];

    mbar_wait(kvbar, 0);
    if constexpr (C::BF16) {
      uint32_t pa[BN / 16][4], da[BN / 16][4];
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % NS;
        const int q0 = (first + it) * BN;
        const float* rows = rows_of(it);
        stage(it);
        mbar_wait(&full[s], (it / NS) & 1);
        wgmma_fence();
        mma_ss_bf16<BN, DP, SW>(sacc, sK, sQ + s * C::Q_BYTES, false);
        mma_ss_bf16<BN, DP, SW>(pacc, sV, sD + s * C::Q_BYTES, false);
        wgmma_commit();
        named_bar_sync(1, NCONS);   // the staged rows
        wgmma_wait<0>();
        fence_regs<BN / 2>(sacc);
        fence_regs<BN / 2>(pacc);
        ds_tile_t<BN>(sacc, pacc, rows, rows + BN, c, scale, masked(q0),
                      key, q0, t4);
        pack_frags_bf16<BN>(pa, sacc);
        pack_frags_bf16<BN>(da, pacc);
        wgmma_fence();
        mma_rs_bf16_tb<BN, DP, SW>(dvacc, pa, sD + s * C::Q_BYTES);
        mma_rs_bf16_tb<BN, DP, SW>(dkacc, da, sQ + s * C::Q_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<DP / 2>(dvacc);
        fence_regs<DP / 2>(dkacc);
        fence_regs<BN / 4>(&pa[0][0]);
        fence_regs<BN / 4>(&da[0][0]);
        mbar_arrive(&empty[s]);
      }
    } else {
      split_tf32<NCONS>(sK, sKlo, C::K_BYTES, tid);
      split_tf32<NCONS>(sV, sVlo, C::K_BYTES, tid);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % NS;
        const int q0 = (first + it) * BN;
        const float* rows = rows_of(it);
        uint8_t* qt = sQ + s * C::Q_BYTES;
        uint8_t* dt = sD + s * C::Q_BYTES;
        stage(it);
        mbar_wait(&full[s], (it / NS) & 1);
        // Every warp is past the last tile's products before the lo and
        // transposed buffers are overwritten.
        if (it > 0) named_bar_sync(1, NCONS);
        transpose_split<DP, BN, SW, NCONS>(qt, sQth, sQtl, tid);
        transpose_split<DP, BN, SW, NCONS>(dt, sDth, sDtl, tid);
        named_bar_sync(1, NCONS);   // all of Q and dO read before the split
        split_tf32<NCONS>(qt, sQlo, C::Q_BYTES, tid);
        split_tf32<NCONS>(dt, sDlo, C::Q_BYTES, tid);
        fence_proxy_async();
        named_bar_sync(1, NCONS);
        wgmma_fence();
        mma_ss_tf32x3<BN, DP, SW>(sacc, sK, sKlo, qt, sQlo, false);
        mma_ss_tf32x3<BN, DP, SW>(pacc, sV, sVlo, dt, sDlo, false);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BN / 2>(sacc);
        fence_regs<BN / 2>(pacc);
        mbar_arrive(&empty[s]);   // Q and dO read; their transposes are copies
        ds_tile_t<BN>(sacc, pacc, rows, rows + BN, c, scale, masked(q0), key,
                      q0, t4);
        uint32_t ah[BN / 8][4], al[BN / 8][4];
        split_frags_tf32<BN>(ah, al, sacc);
        wgmma_fence();
        mma_rs_tf32x3<BN, DP>(dvacc, ah, al, sDth, sDtl);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<DP / 2>(dvacc);
        fence_regs<BN / 2>(&ah[0][0]);
        fence_regs<BN / 2>(&al[0][0]);
        split_frags_tf32<BN>(ah, al, pacc);
        wgmma_fence();
        mma_rs_tf32x3<BN, DP>(dkacc, ah, al, sQth, sQtl);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<DP / 2>(dkacc);
        fence_regs<BN / 2>(&ah[0][0]);
        fence_regs<BN / 2>(&al[0][0]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = key + 8 * h;
    if (r >= tk) continue;
    T* krow = dk + ((size_t)bh * tk + r) * d;
    T* vrow = dv + ((size_t)bh * tk + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < d) {
        store2(krow + col, dkacc[4 * j + 2 * h], dkacc[4 * j + 2 * h + 1]);
        store2(vrow + col, dvacc[4 * j + 2 * h], dvacc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int bh, int tq, int tk, int d,
                   int causal, float scale, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  CUtensorMap qm, km, vm, dm;
  cudaError_t err;
  if ((err = tensor_map_3d(&km, k, C::ELEM, d, tk, bh, C::PCOLS, BK, C::SW)) ||
      (err = tensor_map_3d(&vm, v, C::ELEM, d, tk, bh, C::PCOLS, BK, C::SW)) ||
      (err = tensor_map_3d(&qm, q, C::ELEM, d, tq, bh, C::PCOLS, C::BN, C::SW)) ||
      (err = tensor_map_3d(&dm, dout, C::ELEM, d, tq, bh, C::PCOLS, C::BN, C::SW)))
    return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((tk + BK - 1) / BK, bh);
  flash_bwd_dkv_kernel<T, DP><<<grid, NTHREADS, C::SMEM, stream>>>(
      qm, km, vm, dm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), tq, tk, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int bh, int tq, int tk, int d,
                     int causal, float scale, cudaStream_t s) {
  if (d <= 16) return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s);
  if (d <= 32) return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s);
  if (d <= 64) return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s);
  return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale, s);
}

}  // namespace

// q, dout: contiguous (bh, tq, d); k, v, dk, dv: contiguous (bh, tk, d), all
// of one dtype (is_bf16 ? bfloat16 : float32), 16-byte aligned, d · elem a
// multiple of 16 bytes; lse, delta: contiguous (bh, tq) float32; scale: the
// softmax scale.  Returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int tq, int tk, int d, int causal,
                                  int is_bf16, float scale, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 ||
      (d * elem) % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) &
       15) != 0)
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
