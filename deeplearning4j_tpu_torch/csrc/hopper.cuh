// Hopper (sm_90a) building blocks shared by the port's kernels: shared-memory
// addresses and swizzles, mbarriers, TMA tensor maps and loads, and warpgroup
// matrix multiplies (wgmma) with their shared-memory descriptors.  Plain
// device functions over inline PTX; no CUTLASS.  Host code builds the tensor
// maps through the driver entry point that the runtime hands out, so a
// library built from a source that includes this header needs no -lcuda.
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
//   wgmma_rs_bf16_tb<N>: A bf16 in registers (4 x bf16x2: the f32
//                        accumulator layout of a 64 x 16 tile, packed), B
//                        bf16 MN-major in shared memory (k16).
//   wgmma_ss_tf32<N>:    A, B tf32 in shared memory, both K-major (k8).
//   wgmma_rs_tf32<N>:    A tf32 in registers (4 a thread: rows g, g+8 of
//                        the thread's warp slice by columns t, t+4, with g =
//                        lane/4, t = lane%4), B tf32 K-major in shared
//                        memory (k8).  TF32 takes no transpose.
template <int N> __device__ void wgmma_ss_bf16(float*, uint64_t, uint64_t, int);
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
