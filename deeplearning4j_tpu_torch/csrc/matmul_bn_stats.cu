// Matrix product with the BatchNorm batch statistics in its epilogue, for
// Hopper (sm_90a) on the tensor cores: TMA loads through an mbarrier ring,
// wgmma products, the statistics from the f32 accumulators, y stored by TMA.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_fused.py:
// _mm_bn_kernel (launched by matmul_bn_stats, wrapped by conv1x1_bn_stats).
// Same function: for x (M, K) and w (K, N) of one dtype,
//   y    = x @ w, products accumulated in f32, written once in x's dtype
//          (bf16 products are exact in f32; f32 inputs run as split TF32,
//          below, with float32 accuracy);
//   s_n  = Σ_m y_mn and ss_n = Σ_m y_mn² over the UNROUNDED f32 products,
//          so that BN's mean = s/M and biased variance = ss/M − mean² never
//          read y again.
// The TPU kernel keeps each column tile's sums resident in VMEM across a
// sequential sweep over row tiles.  On the card blocks run in parallel, so
// the sweep becomes two passes:
//   1. persistent blocks, each owning one column tile and every rb-th row
//      tile (tiles of BM = 128 rows by BN columns): a block computes and
//      stores its tiles of y, keeps running column sums of them in
//      registers, and at the end writes one partial row per warpgroup to an
//      (N, 2·rb) f32 scratch;
//   2. one warp per column sums that column's 2·rb partial rows in a fixed
//      order (column_sum_kernel).
// Each output has one writer and nothing uses atomics, so two calls on the
// same inputs give the same bits.
//
// What bounds it on the H100: bytes for the wide, shallow products of
// ResNet-50's stages 0-2 at batch 64 (M 200,704 to 12,544 rows of K, N 64 to
// 1024: x is read and y written once, 13-128 MB), operations for the deep
// ones of stage 3 (K, N 512-2048, M 3,136).  So the design streams x and y
// at the memory's rate and keeps the products on the tensor cores:
//   * One block an SM (the ring fills shared memory).  The rb blocks of a
//     column tile take row tiles rb apart, and the nct blocks that share a
//     row tile run side by side, so the second read of an x tile comes from
//     the 50 MB L2.
//   * A producer thread keeps an NS-stage ring of K-chunks in flight with
//     TMA (one 128-byte panel of x's K a stage: 64 bf16 or 32 f32, x's tile
//     K-major with the 128-byte swizzle, and w's chunk), across tile
//     boundaries, so loads go on while the consumers run an epilogue.  TMA
//     reads zeros past M, K and N: the main loop has no masks.  The
//     producer's warpgroup hands its registers to the consumers
//     (setmaxnreg).
//   * Two consumer warpgroups own 64 rows each of the 128-row tile.
//     bf16: wgmma SS, x K-major, w read MN-major where TMA left it (the
//     transpose bit), one chunk's products in flight while the last one's
//     are added.  float32: split TF32, x = hi + lo, hi·hi + hi·lo + lo·hi,
//     float32 accuracy at 495/3 TFLOP/s instead of FP32 FMA's 67.  TF32
//     wgmma takes no transpose, so B must be K-major: a prep kernel
//     (split_transpose_kernel) writes wᵀ split into hi and lo once per call
//     (w is at most 1 M elements at ResNet's shapes, 8 MB of scratch), and
//     TMA loads its tiles ready to use.  x is split in registers: each
//     consumer thread reads its A fragments from the swizzled tile and
//     rounds them (wgmma_rs_tf32), so no split is written back to shared
//     memory and no barrier waits for one: the per-tile splits in shared
//     memory are what hold the f32 flash kernels at 3-6× their bound.
//     Each K-chunk's product goes to a fresh accumulator fragment and is
//     added to the tile's sum with round-to-nearest adds: the tensor cores'
//     own accumulation truncates, and over K 2048 that drifts past the
//     float32 tolerances.
//   * The tile width follows N (BN 64 or 128), so that N = 64 does not fill
//     half of every tile with zeros.
//   * Epilogue, from the f32 accumulator fragment before rounding.  y is
//     rounded to x's dtype, staged in swizzled shared memory and written
//     by a TMA store per warpgroup, which clips
//     at M and N: coalesced, and it drains while the statistics are taken.
//     Each thread adds its two rows per column; a butterfly of __shfl_xor
//     over the warp's 8 row groups halves the values at each of its 3
//     steps (7/8 of a shuffle per value instead of 3) and adds them to the
//     thread's running sums.  Only after its last tile does a block add
//     its warps' sums through shared memory and write them: a partial row
//     per tile, scattered over the scratch, measured markedly slower at
//     the shapes with many tiles.  Rows past M are zero rows of x and add
//     nothing; columns past N are not written.
// Shared with B1-B3 through hopper.cuh: the mbarrier, TMA-load and
// tensor-map pieces, the wgmma wrappers and descriptors, swizzle,
// align1024, named barriers, tf32_rna and store2.  Added there for this
// kernel: tma_store_3d with bulk_commit / bulk_wait_read / bulk_wait, and
// the transposed-B SS product mma_ss_bf16_tb.
//
// Any M, N > 0; K > 0 with K · elem and N · elem multiples of 16 bytes and
// 16-byte aligned x, w and y (the wrapper pads with zeros otherwise);
// float32 or bfloat16.  The wrapper allocates y, s, ss and the scratch and
// passes the stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;               // rows of a tile: two warpgroups of 64
constexpr int NCONS = 256;            // consumer threads: two warpgroups
constexpr int NTHREADS = NCONS + 128; // and a producer warpgroup
constexpr int PRODUCER_REGS = 40;     // registers a thread, after setmaxnreg
constexpr int CONSUMER_REGS = 232;
constexpr int SW = 128;               // every TMA box row is 128 bytes
constexpr int NWARPS = NCONS / 32;
constexpr int COLS_PER_BLOCK = 8;     // columns of a column-sum block
constexpr int SMEM_MAX = 232448;      // opt-in shared memory of a block

template <typename T, int BN>
struct Cfg {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int ELEM = sizeof(T);
  static constexpr int PC = SW / ELEM;             // columns of a panel
  static constexpr int BK = PC;                    // K of one stage
  static constexpr int X_BYTES = BM * SW;          // x's chunk, 16 KB
  // bf16: w's chunk, BK rows of BN in BN/PC panels; f32: wᵀ hi (and as
  // much again for lo), BN rows of BK.
  static constexpr int W_BYTES = BK * BN * ELEM;
  static constexpr int STAGE = X_BYTES + (BF16 ? 1 : 2) * W_BYTES;
  static constexpr int Y_BYTES = 64 * BN * ELEM;   // a warpgroup's y tile
  // The warps' running column sums after the block's last tile, f32
  // [Σy, Σy²][warp][BN].
  static constexpr int RED_BYTES = 2 * NWARPS * BN * 4;
  static constexpr int FIXED = 2 * Y_BYTES + RED_BYTES;
  static constexpr int NS_FIT = (SMEM_MAX - 1024 - 16 * 8 - FIXED) / STAGE;
  static constexpr int NS = NS_FIT < 8 ? NS_FIT : 8;
  static constexpr int SMEM = NS * STAGE + FIXED + 16 * NS + 1024;
  static_assert(NS >= 3, "the ring needs three stages");
  static_assert(SMEM <= SMEM_MAX, "a block must fit the opt-in shared memory");
  static_assert(BN % PC == 0 && BN % 32 == 0, "whole panels, 8-way butterfly");
};

// The A fragments of the K-chunk (32 f32 columns: 4 k8 steps) of a 64-row
// f32 TMA tile, K-major with the 128-byte swizzle, split into tf32 hi and
// lo as wgmma_rs_tf32 takes them: register e of step j is row r + 8·(e&1),
// column 8j + t + 4·(e>>1) (r = 16·warp + lane/4, t = lane%4).  Conflict
// free: the 8 rows a warp reads sit in 8 different 16-byte slots.
__device__ __forceinline__ void load_split_frags(uint32_t (&hi)[4][4],
                                                 uint32_t (&lo)[4][4],
                                                 const uint8_t* a, int r,
                                                 int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e & 1), col = 8 * j + t + 4 * (e >> 1);
      const float v = *reinterpret_cast<const float*>(
          a + swizzle<SW>(row * SW + col * 4));
      hi[j][e] = tf32_rna(v);
      lo[j][e] = tf32_rna(v - __uint_as_float(hi[j][e]));
    }
}

// D (64 x N) = A·B (+ D if `acc`) in split tf32, lo·hi + hi·lo + hi·hi (the
// small terms first): A as load_split_frags left it, B an N-row TMA tile of
// 32 f32 columns, K-major, hi and lo.
template <int N>
__device__ __forceinline__ void mma_rs_tf32x3_k(float (&d)[N / 2],
                                                const uint32_t (&ah)[4][4],
                                                const uint32_t (&al)[4][4],
                                                const uint8_t* bh,
                                                const uint8_t* bl, bool acc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t h = gmma_desc<SW>(bh + 32 * j, 16, 8 * SW);
    wgmma_rs_tf32<N>(d, al[j], h, acc || j > 0);
    wgmma_rs_tf32<N>(d, ah[j], gmma_desc<SW>(bl + 32 * j, 16, 8 * SW), 1);
    wgmma_rs_tf32<N>(d, ah[j], h, 1);
  }
}

// One butterfly step over lanes M apart: of v[0, 2H) a lane keeps the half
// its lane bit M names (moved to v[0, H)) plus the partner's copy of it.
template <int M, int H, int V>
__device__ __forceinline__ void butterfly(float (&v)[V], int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Sums V values over the warp's 8 row groups (lane/4), 7V/8 shuffles in
// all: afterwards v[i], i < V/8, holds the warp's sum of value
// (lane/4)·V/8 + i.  Fixed order, so the same bits every run.
template <int V>
__device__ __forceinline__ void reduce_row_groups(float (&v)[V], int lane) {
  butterfly<16, V / 2>(v, lane);
  butterfly<8, V / 4>(v, lane);
  butterfly<4, V / 8>(v, lane);
}

template <typename T, int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
mm_bn_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap wlmap,
                  const __grid_constant__ CUtensorMap ymap,
                  float* __restrict__ part_s, float* __restrict__ part_ss,
                  int M, int N, int R, int nct, int nk) {
  // Block b owns column tile b % nct and every (gridDim.x / nct)-th row
  // tile from b / nct: the blocks that share a row tile run side by side.
  using C = Cfg<T, BN>;
  constexpr int NS = C::NS, BK = C::BK, PC = C::PC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);                 // [NS][STAGE]
  uint8_t* ystage = ring + NS * C::STAGE;              // [2][Y_BYTES]
  float* red = reinterpret_cast<float*>(ystage + 2 * C::Y_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(red) + C::RED_BYTES);
  uint64_t* empty = full + NS;
  const int ct = blockIdx.x % nct, rb = gridDim.x / nct;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // Producer warpgroup: one thread issues every load, across tile
    // boundaries; the group gives its registers to the consumers.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NCONS) {
      prefetch_tensor_map(&xmap);
      prefetch_tensor_map(&wmap);
      if constexpr (!C::BF16) prefetch_tensor_map(&wlmap);
      int it = 0;
      for (int rt = blockIdx.x / nct; rt < R; rt += rb) {
        const int m0 = rt * BM, n0 = ct * BN;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % NS;
          if (it >= NS) mbar_wait(&empty[s], ((it / NS) - 1) & 1);
          mbar_arrive_expect_tx(&full[s], C::STAGE);
          uint8_t* st = ring + s * C::STAGE;
          tma_load_3d(st, &xmap, &full[s], kc * BK, m0, 0);
          if constexpr (C::BF16) {
#pragma unroll
            for (int p = 0; p < BN / PC; ++p)
              tma_load_3d(st + C::X_BYTES + p * BK * SW, &wmap, &full[s],
                          n0 + p * PC, kc * BK, 0);
          } else {
            tma_load_3d(st + C::X_BYTES, &wmap, &full[s], kc * BK, n0, 0);
            tma_load_3d(st + C::X_BYTES + C::W_BYTES, &wlmap, &full[s],
                        kc * BK, n0, 0);
          }
        }
      }
    }
    return;
  }

  // Consumers.  Thread (warpgroup wg, warp w of 8, lane = 4g + t) holds
  // rows r and r + 8 of its warpgroup's 64, r = 16·(w%4) + g, columns
  // 8j + 2t and 8j + 2t + 1 of the accumulator.
  setmaxnreg_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = 16 * (warp % 4) + g;
  // The tensor cores add each step's products into their f32 accumulator
  // with truncation, an error that grows with the steps it runs over: at K
  // 1024 and 2048 it broke the float32 tolerances of y and Σy².  So each
  // K-chunk's product (4 or 12 wgmma steps) goes to a fresh fragment, and
  // acc sums the chunks with round-to-nearest adds.
  float acc[BN / 2];
  const auto add_chunk = [&](const float (&p)[BN / 2], int kc) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = kc == 0 ? p[i] : acc[i] + p[i];
  };
  int it = 0;
  // Running column sums of the block's tiles (Σy, Σy²), as the butterfly
  // leaves them: value i of a thread is column slot g·BN/32 + i.
  float cs[BN / 32], css[BN / 32];
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) cs[i] = css[i] = 0.f;
  uint8_t* ys = ystage + wg * C::Y_BYTES;
  for (int rt = blockIdx.x / nct; rt < R; rt += rb) {

    if constexpr (C::BF16) {
      // Two chunk fragments: chunk kc + 1's products are issued before
      // chunk kc's are added.  Every path through the loop leaves pa in
      // flight, and the tail waits for all, so that ptxas can follow the
      // groups and does not serialise them.
      float pa[BN / 2], pb[BN / 2];
      const auto issue = [&](float (&p)[BN / 2], int kc) {
        const int s = (it + kc) % NS;
        mbar_wait(&full[s], ((it + kc) / NS) & 1);
        const uint8_t* st = ring + s * C::STAGE;
        wgmma_fence();
        mma_ss_bf16_tb<BN, BK, SW>(p, st + wg * 64 * SW, st + C::X_BYTES,
                                   false);
        wgmma_commit();
      };
      const auto retire = [&](float (&p)[BN / 2], int kc) {
        fence_regs<BN / 2>(p);
        mbar_arrive(&empty[(it + kc) % NS]);
        add_chunk(p, kc);
      };
      issue(pa, 0);
      int kc = 0;
      for (; kc + 2 < nk; kc += 2) {
        issue(pb, kc + 1);
        wgmma_wait<1>();
        retire(pa, kc);
        issue(pa, kc + 2);
        wgmma_wait<1>();
        retire(pb, kc + 1);
      }
      if (kc + 1 < nk) {
        issue(pb, kc + 1);
        wgmma_wait<1>();
        retire(pa, kc);
        wgmma_wait<0>();
        retire(pb, kc + 1);
      } else {
        wgmma_wait<0>();
        retire(pa, kc);
      }
      it += nk;
    } else {
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % NS;
        mbar_wait(&full[s], (it / NS) & 1);
        const uint8_t* st = ring + s * C::STAGE;
        float part[BN / 2];
        uint32_t ah[4][4], al[4][4];
        load_split_frags(ah, al, st + wg * 64 * SW, r, t);
        wgmma_fence();
        mma_rs_tf32x3_k<BN>(part, ah, al, st + C::X_BYTES,
                            st + C::X_BYTES + C::W_BYTES, false);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<16>(&ah[0][0]);
        fence_regs<16>(&al[0][0]);
        fence_regs<BN / 2>(part);
        mbar_arrive(&empty[s]);
        add_chunk(part, kc);
      }
    }

    // y in x's dtype first, so that its store drains while the statistics
    // are computed: staged as the TMA store's boxes (64 rows by PC
    // columns, 128-byte swizzle) once the last tile's store has read them.
    if (tid % 128 == 0) bulk_wait_read<0>();
    named_bar_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * j + 2 * t, row = r + 8 * h;
        T* dst = reinterpret_cast<T*>(
            ys + (col / PC) * 64 * SW +
            swizzle<SW>(row * SW + (col % PC) * C::ELEM));
        store2(dst, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (tid % 128 == 0) {
      const int m0 = rt * BM + wg * 64;
      if (m0 < M) {
#pragma unroll
        for (int p = 0; p < BN / PC; ++p)
          if (ct * BN + p * PC < N)
            tma_store_3d(&ymap, ys + p * 64 * SW, ct * BN + p * PC, m0, 0);
      }
      bulk_commit();
    }

    // Statistics of the unrounded products: each thread's two rows, then
    // the warp's 8 row groups, added to the running sums.
    {
      float v[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[2 * j + e] = acc[4 * j + e] + acc[4 * j + 2 + e];
      reduce_row_groups<BN / 4>(v, lane);
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) cs[i] += v[i];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[2 * j + e] = fmaf(acc[4 * j + e], acc[4 * j + e],
                              acc[4 * j + 2 + e] * acc[4 * j + 2 + e]);
      reduce_row_groups<BN / 4>(v, lane);
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) css[i] += v[i];
    }
  }

  // The block's partial sums, one row per warpgroup: its 4 warps' running
  // sums in order.
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const int c = g * (BN / 32) + i;
    const int col = 8 * (c / 2) + 2 * t + (c % 2);
    red[warp * BN + col] = cs[i];
    red[(NWARPS + warp) * BN + col] = css[i];
  }
  named_bar_sync(1 + wg, 128);
  for (int i = tid % 128; i < 2 * BN; i += 128) {
    const int stat = i / BN, col = i % BN, nc = ct * BN + col;
    if (nc < N) {
      const float* src = red + (stat * NWARPS + 4 * wg) * BN + col;
      const float a = ((src[0] + src[BN]) + src[2 * BN]) + src[3 * BN];
      (stat ? part_ss : part_s)[(long long)nc * 2 * rb +
                                2 * (blockIdx.x / nct) + wg] = a;
    }
  }
  if (tid % 128 == 0) bulk_wait<0>();
}

// f32 only, once per call: wᵀ split into tf32 hi and lo, (N, K) each, the
// K-major B operand that TF32 wgmma needs.  32 x 32 tiles through shared
// memory, read and written coalesced.
__global__ void __launch_bounds__(256)
split_transpose_kernel(const float* __restrict__ w, uint32_t* __restrict__ hi,
                       uint32_t* __restrict__ lo, int K, int N) {
  __shared__ float tile[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = (k < K && n < N) ? w[(long long)k * N + n] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n < N && k < K) {
      const float v = tile[tx][i];
      const uint32_t h = tf32_rna(v);
      hi[(long long)n * K + k] = h;
      lo[(long long)n * K + k] = tf32_rna(v - __uint_as_float(h));
    }
  }
}

// Pass 2: one warp per column sums its P partial rows in a fixed order
// (strided per lane, then a butterfly whose every step adds the same two
// values on both lanes).
__global__ void __launch_bounds__(COLS_PER_BLOCK * 32)
column_sum_kernel(const float* __restrict__ part_s,
                  const float* __restrict__ part_ss, float* __restrict__ s,
                  float* __restrict__ ss, int N, int P) {
  const int n = blockIdx.x * COLS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const float* ps = part_s + (long long)n * P;
  const float* pss = part_ss + (long long)n * P;
  float a = 0.f, b = 0.f;
  for (int r = lane; r < P; r += 32) {
    a += ps[r];
    b += pss[r];
  }
#pragma unroll
  for (int m = 16; m > 0; m /= 2) {
    a += __shfl_xor_sync(0xffffffffu, a, m);
    b += __shfl_xor_sync(0xffffffffu, b, m);
  }
  if (lane == 0) {
    s[n] = a;
    ss[n] = b;
  }
}

int row_tiles(int M) { return (M + BM - 1) / BM; }

// Blocks that share a column tile, each taking every rb-th row tile: as
// many as fill the SMs, at most one per row tile, at most MAX_RB.
constexpr int MAX_RB = 256;
int row_blocks(int R, int nct, int nsm) {
  int rb = nsm / nct;
  if (rb > R) rb = R;
  if (rb > MAX_RB) rb = MAX_RB;
  return rb > 0 ? rb : 1;
}

// Rows of partial sums a column can have: one per warpgroup of a block.
int partial_rows(int M) {
  const int R = row_tiles(M);
  return 2 * (R < MAX_RB ? R : MAX_RB);
}

// Floats of the partial sums, rounded up so that wᵀ's split after them
// starts 128-byte aligned.
long long partial_floats(int M, int N) {
  return (2LL * partial_rows(M) * N + 31) / 32 * 32;
}

template <typename T, int BN>
cudaError_t launch(const void* x, const void* w, void* y, void* s, void* ss,
                   void* scratch, int M, int K, int N, cudaStream_t stream) {
  using C = Cfg<T, BN>;
  const int R = row_tiles(M), nct = (N + BN - 1) / BN;
  float* part_s = static_cast<float*>(scratch);
  cudaError_t err;
  CUtensorMap xm, wm, wlm, ym;
  if ((err = tensor_map_3d(&xm, x, C::ELEM, K, M, 1, C::BK, BM, SW)) ||
      (err = tensor_map_3d(&ym, y, C::ELEM, N, M, 1, C::PC, 64, SW)))
    return err;
  if constexpr (C::BF16) {
    if ((err = tensor_map_3d(&wm, w, C::ELEM, N, K, 1, C::PC, C::BK, SW)))
      return err;
    wlm = wm;
  } else {
    if ((K + 31) / 32 > 65535) return cudaErrorInvalidValue;
    uint32_t* hi = reinterpret_cast<uint32_t*>(part_s + partial_floats(M, N));
    uint32_t* lo = hi + (long long)N * K;
    split_transpose_kernel<<<dim3((N + 31) / 32, (K + 31) / 32), 256, 0,
                             stream>>>(static_cast<const float*>(w), hi, lo,
                                       K, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = tensor_map_3d(&wm, hi, 4, K, N, 1, C::BK, BN, SW)) ||
        (err = tensor_map_3d(&wlm, lo, 4, K, N, 1, C::BK, BN, SW)))
      return err;
  }
  int dev, nsm;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaFuncSetAttribute(mm_bn_tile_kernel<T, BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  C::SMEM)))
    return err;
  const int rb = row_blocks(R, nct, nsm);
  if ((long long)rb * nct > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* part_ss = part_s + 2LL * rb * N;
  const int grid = rb * nct;
  mm_bn_tile_kernel<T, BN><<<grid, NTHREADS, C::SMEM, stream>>>(
      xm, wm, wlm, ym, part_s, part_ss, M, N, R, nct, (K + C::BK - 1) / C::BK);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  column_sum_kernel<<<(N + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK,
                      COLS_PER_BLOCK * 32, 0, stream>>>(
      part_s, part_ss, static_cast<float*>(s), static_cast<float*>(ss), N,
      2 * rb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* y, void* s, void* ss,
                     void* scratch, int M, int K, int N, cudaStream_t st) {
  return N <= 64 ? launch<T, 64>(x, w, y, s, ss, scratch, M, K, N, st)
                 : launch<T, 128>(x, w, y, s, ss, scratch, M, K, N, st);
}

}  // namespace

// f32 elements of the scratch of the partial sums for (M, N): Σy and Σy²
// per 64-row half tile, each (N, 2·ceil(M/128)), rounded up to 32.
extern "C" long long matmul_bn_stats_scratch_floats(int M, int N) {
  return partial_floats(M, N);
}

// f32 elements that a float32 call needs after the partial sums: wᵀ split
// into tf32 hi and lo, (N, K) each.  A bfloat16 call needs none.
extern "C" long long matmul_bn_stats_split_floats(int K, int N, int is_bf16) {
  return is_bf16 ? 0 : 2LL * N * K;
}

// x: contiguous (M, K); w: contiguous (K, N); y: contiguous (M, N), all of
// one dtype (is_bf16 ? bfloat16 : float32), 16-byte aligned, K · elem and
// N · elem multiples of 16 bytes; s, ss: (N,) float32; scratch:
// matmul_bn_stats_scratch_floats(M, N) + matmul_bn_stats_split_floats(K,
// N, is_bf16) float32, 16-byte aligned.  Returns the launches' cudaError_t
// (0 on success); does not synchronise.
extern "C" int matmul_bn_stats(const void* x, const void* w, void* y, void* s,
                               void* ss, void* scratch, int M, int K, int N,
                               int is_bf16, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (M <= 0 || K <= 0 || N <= 0 || (K * (long long)elem) % 16 != 0 ||
      (N * (long long)elem) % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(scratch)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, w, y, s, ss, scratch, M, K, N, st)
              : dispatch<float>(x, w, y, s, ss, scratch, M, K, N, st);
  return (int)err;
}

extern "C" const char* matmul_bn_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
