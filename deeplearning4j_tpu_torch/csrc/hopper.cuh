// Hopper (sm_90a) building blocks shared by the port's kernels: shared-memory
// addresses and swizzles, mbarriers, TMA tensor maps, loads and stores, and
// warpgroup matrix multiplies (wgmma) with their shared-memory descriptors.
// Plain device functions over inline PTX; no CUTLASS.  Host code builds the tensor
// maps through the driver entry point that the runtime hands out, so a
// library built from a source that includes this header needs no -lcuda.
//
// TMA stores go the other way, from a staged tile in shared memory, and
// complete through bulk groups rather than mbarriers.
//
// Layout conventions (CUTLASS's canonical GMMA layouts, in bytes):
//   * A TMA box whose rows are SW bytes (SW = 32, 64 or 128) lands in shared
//     memory as rows of SW bytes, each 16-byte chunk of a row XOR-ed with
//     bits of the row index (Swizzle<log2(SW/16), 4, 3>).  A tile wider
//     than 128 bytes is loaded as several column panels of 128 bytes.
//   * K-major operand (the contracted dimension contiguous): 8-row atoms of
//     SW bytes, one after the other, so SBO = 8·SW; LBO is unused.  One
//     wgmma step reads 32 bytes of K: the descriptor's start moves by 32
//     bytes inside a panel.
//   * MN-major operand (16-bit types only, the transpose bit): rows are K,
//     SW bytes of M or N each; SBO = 8·SW is the step between groups of 8
//     K-rows, LBO the step between panels along M or N.  One k16 step moves
//     the start by 16 rows.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the 128-byte swizzle repeats
// every 1024 bytes, and the hardware applies it to absolute addresses).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Byte offset of `off` (from a 1024-aligned base) under the SW-byte swizzle.
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t mask = SW / 16 - 1;
  return off ^ (((off >> 7) & mask) << 4);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Hands registers between warpgroups: every thread of the warpgroup
// executes it, and the warpgroup's threads then hold N registers each
// (dec before inc, so the register file is never over-committed).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// bar.sync on a named barrier shared by `n` threads (id 0 is __syncthreads).
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes initialised barriers visible to the other threads and to TMA; follow
// with __syncthreads().
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Copies the box at element coordinates (c0, c1, c2) of `map` into `dst` and
// reports its bytes to `bar`.  Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// Copies `src` to the box at element coordinates (c0, c1, c2) of `map`:
// `src` holds the box as a TMA load of it would leave it, swizzle included.
// Elements outside the tensor are not written.  Issue after
// fence_proxy_async() and a barrier have made the threads' writes to `src`
// visible; the store joins this thread's open bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// Closes this thread's open bulk group (the TMA stores issued since the
// last commit).
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared memory (which may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are incomplete (their
// writes to global memory done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor layout code of an SW-byte swizzle.
template <int SW>
__device__ __forceinline__ constexpr uint64_t gmma_layout() {
  return SW == 128 ? 1 : SW == 64 ? 2 : 3;
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (multiples of 16), swizzle layout.
template <int SW>
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (gmma_layout<SW>() << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes, so that the
// compiler moves no access to them across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Round to TF32 (nearest, ties away): the low 13 mantissa bits become 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// 2^x on the special-function unit.
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// D (64 x N, f32, N/2 registers a thread) = A·B + (scale_d ? D : 0).
//   wgmma_ss_bf16<N>:    A, B bf16 in shared memory, both K-major (k16).
//   wgmma_ss_bf16_tb<N>: A bf16 K-major, B bf16 MN-major (the transpose
//                        bit), both in shared memory (k16).
//   wgmma_rs_bf16_tb<N>: A bf16 in registers (4 x bf16x2: the f32
//                        accumulator layout of a 64 x 16 tile, packed), B
//                        bf16 MN-major in shared memory (k16).
//   wgmma_ss_tf32<N>:    A, B tf32 in shared memory, both K-major (k8).
//   wgmma_rs_tf32<N>:    A tf32 in registers (4 a thread: rows g, g+8 of
//                        the thread's warp slice by columns t, t+4, with g =
//                        lane/4, t = lane%4), B tf32 K-major in shared
//                        memory (k8).  TF32 takes no transpose.
template <int N> __device__ void wgmma_ss_bf16(float*, uint64_t, uint64_t, int);
template <int N> __device__ void wgmma_ss_bf16_tb(float*, uint64_t, uint64_t, int);
template <int N> __device__ void wgmma_rs_bf16_tb(float*, const uint32_t*, uint64_t, int);
template <int N> __device__ void wgmma_ss_tf32(float*, uint64_t, uint64_t, int);
template <int N> __device__ void wgmma_rs_tf32(float*, const uint32_t*, uint64_t, int);

#define HOPPER_RL8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HOPPER_RL16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
    "%14, %15}"
#define HOPPER_RL32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
    "%26, %27, %28, %29, %30, %31}"
#define HOPPER_RL64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
    "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
    "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
    "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
    "%62, %63}"
#define HOPPER_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])
#define HOPPER_ACC16(i) HOPPER_ACC8(i), HOPPER_ACC8(i + 8)
#define HOPPER_ACC32(i) HOPPER_ACC16(i), HOPPER_ACC16(i + 16)
#define HOPPER_ACC64(i) HOPPER_ACC32(i), HOPPER_ACC32(i + 32)

// Operands after the N/2 accumulators: A's descriptor %IA, B's %IB, scale-d
// %IS (shared-memory A); A's four registers %A0..%A3 (register A).
#define HOPPER_WGMMA_SS(NAME, N, SHAPE, IMM, RL, ACC, IA, IB, IS)             \
  template <> __device__ __forceinline__ void NAME<N>(                        \
      float* d, uint64_t da, uint64_t db, int scale_d) {                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"            \
                 "wgmma.mma_async.sync.aligned." SHAPE " " RL ", %" #IA       \
                 ", %" #IB ", p, " IMM ";\n}\n"                               \
                 : ACC : "l"(da), "l"(db), "r"(scale_d));                     \
  }
#define HOPPER_WGMMA_RS(NAME, N, SHAPE, IMM, RL, ACC, A0, A1, A2, A3, IB, IS) \
  template <> __device__ __forceinline__ void NAME<N>(                        \
      float* d, const uint32_t* a, uint64_t db, int scale_d) {                \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"            \
                 "wgmma.mma_async.sync.aligned." SHAPE " " RL ", {%" #A0      \
                 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #IB ", p, " IMM         \
                 ";\n}\n"                                                     \
                 : ACC : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),          \
                   "l"(db), "r"(scale_d));                                    \
  }

// scale-a, scale-b (then transpose-a, transpose-b where the type has them)
HOPPER_WGMMA_SS(wgmma_ss_bf16, 16, "m64n16k16.f32.bf16.bf16", "1, 1, 0, 0", HOPPER_RL8, HOPPER_ACC8(0), 8, 9, 10)
HOPPER_WGMMA_SS(wgmma_ss_bf16, 32, "m64n32k16.f32.bf16.bf16", "1, 1, 0, 0", HOPPER_RL16, HOPPER_ACC16(0), 16, 17, 18)
HOPPER_WGMMA_SS(wgmma_ss_bf16, 64, "m64n64k16.f32.bf16.bf16", "1, 1, 0, 0", HOPPER_RL32, HOPPER_ACC32(0), 32, 33, 34)
HOPPER_WGMMA_SS(wgmma_ss_bf16, 128, "m64n128k16.f32.bf16.bf16", "1, 1, 0, 0", HOPPER_RL64, HOPPER_ACC64(0), 64, 65, 66)
HOPPER_WGMMA_SS(wgmma_ss_bf16_tb, 64, "m64n64k16.f32.bf16.bf16", "1, 1, 0, 1", HOPPER_RL32, HOPPER_ACC32(0), 32, 33, 34)
HOPPER_WGMMA_SS(wgmma_ss_bf16_tb, 128, "m64n128k16.f32.bf16.bf16", "1, 1, 0, 1", HOPPER_RL64, HOPPER_ACC64(0), 64, 65, 66)
HOPPER_WGMMA_RS(wgmma_rs_bf16_tb, 16, "m64n16k16.f32.bf16.bf16", "1, 1, 1", HOPPER_RL8, HOPPER_ACC8(0), 8, 9, 10, 11, 12, 13)
HOPPER_WGMMA_RS(wgmma_rs_bf16_tb, 32, "m64n32k16.f32.bf16.bf16", "1, 1, 1", HOPPER_RL16, HOPPER_ACC16(0), 16, 17, 18, 19, 20, 21)
HOPPER_WGMMA_RS(wgmma_rs_bf16_tb, 64, "m64n64k16.f32.bf16.bf16", "1, 1, 1", HOPPER_RL32, HOPPER_ACC32(0), 32, 33, 34, 35, 36, 37)
HOPPER_WGMMA_RS(wgmma_rs_bf16_tb, 128, "m64n128k16.f32.bf16.bf16", "1, 1, 1", HOPPER_RL64, HOPPER_ACC64(0), 64, 65, 66, 67, 68, 69)
HOPPER_WGMMA_SS(wgmma_ss_tf32, 16, "m64n16k8.f32.tf32.tf32", "1, 1", HOPPER_RL8, HOPPER_ACC8(0), 8, 9, 10)
HOPPER_WGMMA_SS(wgmma_ss_tf32, 32, "m64n32k8.f32.tf32.tf32", "1, 1", HOPPER_RL16, HOPPER_ACC16(0), 16, 17, 18)
HOPPER_WGMMA_SS(wgmma_ss_tf32, 64, "m64n64k8.f32.tf32.tf32", "1, 1", HOPPER_RL32, HOPPER_ACC32(0), 32, 33, 34)
HOPPER_WGMMA_SS(wgmma_ss_tf32, 128, "m64n128k8.f32.tf32.tf32", "1, 1", HOPPER_RL64, HOPPER_ACC64(0), 64, 65, 66)
HOPPER_WGMMA_RS(wgmma_rs_tf32, 16, "m64n16k8.f32.tf32.tf32", "1, 1", HOPPER_RL8, HOPPER_ACC8(0), 8, 9, 10, 11, 12, 13)
HOPPER_WGMMA_RS(wgmma_rs_tf32, 32, "m64n32k8.f32.tf32.tf32", "1, 1", HOPPER_RL16, HOPPER_ACC16(0), 16, 17, 18, 19, 20, 21)
HOPPER_WGMMA_RS(wgmma_rs_tf32, 64, "m64n64k8.f32.tf32.tf32", "1, 1", HOPPER_RL32, HOPPER_ACC32(0), 32, 33, 34, 35, 36, 37)
HOPPER_WGMMA_RS(wgmma_rs_tf32, 128, "m64n128k8.f32.tf32.tf32", "1, 1", HOPPER_RL64, HOPPER_ACC64(0), 64, 65, 66, 67, 68, 69)

#undef HOPPER_WGMMA_SS
#undef HOPPER_WGMMA_RS
#undef HOPPER_ACC64
#undef HOPPER_ACC32
#undef HOPPER_ACC16
#undef HOPPER_ACC8
#undef HOPPER_RL64
#undef HOPPER_RL32
#undef HOPPER_RL16
#undef HOPPER_RL8

// ---------------------------------------------------------------------------
// tile products: whole-tile wgmma sequences over the layouts above
// ---------------------------------------------------------------------------
//
// "A TMA tile" below is R rows of DP elements as a 3-D map with an SW-byte
// swizzle leaves it: DP·elem/SW column panels of R rows of SW bytes each.
// Accumulator fragments are wgmma's: thread (warp w, lane 4g + t) holds
// rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1, at
// registers 4j + 2h + e (h the row half, e the column parity).

// bf16x2 of (lo, hi), lo in the low half: the register A operand's order.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Two adjacent output elements from f32, in the output's type.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// D (64 x N) = A·Bᵀ (+ D if `acc`), bf16: A a 64-row and B an N-row TMA
// tile of DP columns, both K-major; 32 bytes of DP a step.
template <int N, int DP, int SW>
__device__ __forceinline__ void mma_ss_bf16(float (&d)[N / 2],
                                            const uint8_t* a,
                                            const uint8_t* b, bool acc) {
  constexpr int KPP = SW / 32;
#pragma unroll
  for (int kk = 0; kk < DP * 2 / 32; ++kk) {
    const int p = kk / KPP, w = (kk % KPP) * 32;
    wgmma_ss_bf16<N>(d, gmma_desc<SW>(a + p * 64 * SW + w, 16, 8 * SW),
                     gmma_desc<SW>(b + p * N * SW + w, 16, 8 * SW),
                     acc || kk > 0);
  }
}

// D (64 x N) = A·B (+ D if `acc`), bf16: A a 64-row TMA tile of K columns
// (K-major), B a K-row TMA tile of N columns read MN-major (the transpose
// bit); 16 of K a step.
template <int N, int K, int SW>
__device__ __forceinline__ void mma_ss_bf16_tb(float (&d)[N / 2],
                                               const uint8_t* a,
                                               const uint8_t* b, bool acc) {
  constexpr int KPP = SW / 32;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_ss_bf16_tb<N>(
        d, gmma_desc<SW>(a + (kk / KPP) * 64 * SW + (kk % KPP) * 32, 16,
                         8 * SW),
        gmma_desc<SW>(b + kk * 16 * SW, K * SW, 8 * SW), acc || kk > 0);
}

// The bf16 accumulator fragment of a 64 x K tile, packed pair by pair: the
// register A fragments of its K/16 k16 steps.
template <int K>
__device__ __forceinline__ void pack_frags_bf16(uint32_t (&a)[K / 16][4],
                                                const float (&s)[K / 2]) {
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
}

// D (64 x DP) += A·B, bf16: A (64 x K) in registers (pack_frags_bf16), B a
// K-row TMA tile of DP columns read MN-major (the transpose bit), 16 rows a
// step.
template <int K, int DP, int SW>
__device__ __forceinline__ void mma_rs_bf16_tb(float (&d)[DP / 2],
                                               const uint32_t (&a)[K / 16][4],
                                               const uint8_t* b) {
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
    wgmma_rs_bf16_tb<DP>(d, a[j],
                         gmma_desc<SW>(b + j * 16 * SW, K * SW, 8 * SW), 1);
}

// f32 -> (tf32 hi in place, tf32 lo into `lo`) over `bytes`, elementwise
// (the layout, swizzle included, is kept), by NT threads.
template <int NT>
__device__ __forceinline__ void split_tf32(uint8_t* x, uint8_t* lo, int bytes,
                                           int tid) {
  const float4* xs = reinterpret_cast<const float4*>(x);
  uint4* ls = reinterpret_cast<uint4*>(lo);
  for (int i = tid; i < bytes / 16; i += NT) {
    const float4 v = xs[i];
    uint4 h, l;
    h.x = tf32_rna(v.x); l.x = tf32_rna(v.x - __uint_as_float(h.x));
    h.y = tf32_rna(v.y); l.y = tf32_rna(v.y - __uint_as_float(h.y));
    h.z = tf32_rna(v.z); l.z = tf32_rna(v.z - __uint_as_float(h.z));
    h.w = tf32_rna(v.w); l.w = tf32_rna(v.w - __uint_as_float(h.w));
    reinterpret_cast<uint4*>(x)[i] = h;
    ls[i] = l;
  }
}

// The swizzle of a transposed f32 tile of R rows: R·4 bytes, at most 128.
template <int R>
__host__ __device__ constexpr int tsw() {
  return R * 4 < 128 ? R * 4 : 128;
}

// f32: an R-row TMA tile of DP columns -> its transpose, split into tf32 hi
// and lo: DP rows of R, K-major, in panels of tsw<R>()/4 of the R rows with
// that swizzle.  Within each group of 8 the R rows are stored in the order
// (0, 2, 4, 6, 1, 3, 5, 7): the order in which an f32 accumulator fragment
// of a 64 x R tile, taken as tf32 A fragments (split_frags_tf32), holds
// them.  By NT threads.
template <int DP, int R, int SW, int NT>
__device__ __forceinline__ void transpose_split(const uint8_t* x, uint8_t* hi,
                                                uint8_t* lo, int tid) {
  constexpr int PCOLS = SW / 4, TSW = tsw<R>(), PR = TSW / 4;
  for (int gi = tid; gi < DP * R / 4; gi += NT) {
    const int n = gi % DP;                // column of x = row of xᵀ
    const int kl = (gi / DP) * 4;         // first of 4 logical rows
    const int kp = (kl & ~7) + ((kl >> 2) & 1);   // its physical row
    const uint8_t* col = x + (n / PCOLS) * R * SW;
    const uint32_t cb = (n % PCOLS) * 4;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const float*>(
          col + swizzle<SW>((kp + 2 * i) * SW + cb));
    uint4 h, l;
    h.x = tf32_rna(v[0]); l.x = tf32_rna(v[0] - __uint_as_float(h.x));
    h.y = tf32_rna(v[1]); l.y = tf32_rna(v[1] - __uint_as_float(h.y));
    h.z = tf32_rna(v[2]); l.z = tf32_rna(v[2] - __uint_as_float(h.z));
    h.w = tf32_rna(v[3]); l.w = tf32_rna(v[3] - __uint_as_float(h.w));
    const uint32_t off = (kl / PR) * DP * TSW +
                         swizzle<TSW>(n * TSW + (kl % PR) * 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// D (64 x N) = A·Bᵀ (+ D if `acc`) in split tf32, hi·hi + hi·lo + lo·hi:
// A a 64-row and B an N-row TMA tile of DP columns, K-major, each split
// in place (hi) with its lo beside it in the same layout; 8 of DP a step.
template <int N, int DP, int SW>
__device__ __forceinline__ void mma_ss_tf32x3(float (&d)[N / 2],
                                              const uint8_t* a,
                                              const uint8_t* alo,
                                              const uint8_t* b,
                                              const uint8_t* blo, bool acc) {
  constexpr int KPP = SW / 32;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int ao = (kk / KPP) * 64 * SW + (kk % KPP) * 32;
    const int bo = (kk / KPP) * N * SW + (kk % KPP) * 32;
    const uint64_t ah = gmma_desc<SW>(a + ao, 16, 8 * SW);
    const uint64_t bh = gmma_desc<SW>(b + bo, 16, 8 * SW);
    wgmma_ss_tf32<N>(d, gmma_desc<SW>(alo + ao, 16, 8 * SW), bh,
                     acc || kk > 0);
    wgmma_ss_tf32<N>(d, ah, gmma_desc<SW>(blo + bo, 16, 8 * SW), 1);
    wgmma_ss_tf32<N>(d, ah, bh, 1);
  }
}

// The f32 accumulator fragment of a 64 x K tile -> tf32 hi and lo A
// fragments of its K/8 k8 steps.  Registers (2t, 2t + 1) of each 8-column
// group become the fragment's logical columns (t, t + 4): the B operand
// stores its rows in that order (transpose_split).
template <int K>
__device__ __forceinline__ void split_frags_tf32(uint32_t (&hi)[K / 8][4],
                                                 uint32_t (&lo)[K / 8][4],
                                                 const float (&s)[K / 2]) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const float x[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[j][e] = tf32_rna(x[e]);
      lo[j][e] = tf32_rna(x[e] - __uint_as_float(hi[j][e]));
    }
  }
}

// D (64 x DP) += A·B in split tf32: A (64 x K) as split_frags_tf32 left it,
// B the transpose_split of a K-row tile (hi and lo); 8 of K a step.
template <int K, int DP>
__device__ __forceinline__ void mma_rs_tf32x3(float (&d)[DP / 2],
                                              const uint32_t (&ah)[K / 8][4],
                                              const uint32_t (&al)[K / 8][4],
                                              const uint8_t* bh,
                                              const uint8_t* bl) {
  constexpr int TSW = tsw<K>(), KPP = TSW / 32;
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const int off = (j / KPP) * DP * TSW + (j % KPP) * 32;
    const uint64_t h = gmma_desc<TSW>(bh + off, 16, 8 * TSW);
    wgmma_rs_tf32<DP>(d, al[j], h, 1);
    wgmma_rs_tf32<DP>(d, ah[j], gmma_desc<TSW>(bl + off, 16, 8 * TSW), 1);
    wgmma_rs_tf32<DP>(d, ah[j], h, 1);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous (mats, rows, cols) tensor of 2- or 4-byte
// elements, innermost first, whose boxes are (box_cols, box_rows, 1) with an
// SW-byte swizzle (box_cols · elem == SW).  The row stride cols · elem and
// the base must be multiples of 16 bytes.  Boxes past any edge read zeros,
// so a ragged tile never reads the next matrix's rows.
inline cudaError_t tensor_map_3d(CUtensorMap* map, const void* base,
                                 int elem, uint64_t cols, uint64_t rows,
                                 uint64_t mats, uint32_t box_cols,
                                 uint32_t box_rows, int sw) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {cols, rows, mats};
  const cuuint64_t strides[2] = {cols * elem, rows * cols * elem};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
