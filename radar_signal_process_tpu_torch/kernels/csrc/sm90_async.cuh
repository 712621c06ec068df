// Hopper's asynchronous machinery for B2 (rdm.cu), B3 (pc_rdm.cu) and B1
// (cfar.cu): mbarriers, bulk and tensor copies by the TMA engine and the
// host-side lookup of the tensor-map encoder, warpgroup MMA (wgmma)
// descriptors and the TF32 wgmma with A in registers.  sm_90a only (wgmma
// does not exist on plain sm_90).
//
// wgmma.mma_async.m64nNk8.f32.tf32.tf32, A from registers ("RS"):
//   * a warpgroup (4 consecutive warps, the first with warp % 4 == 0) issues
//     it together; warp w of the group owns rows [16 w, 16 w + 16) of the
//     64-row tile, for A and for the accumulator;
//   * A fragment (64 x 8, row-major; g = lane / 4, t = lane % 4, rows relative
//     to the warp's 16): a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//     (cute/atom/mma_traits_sm90_gmma.hpp, ALayout_64x8; the positions of
//     mma.sync m16n8k8's A fragment);
//   * accumulator (64 x N): d[4 j + e] at row g + 8 (e >> 1), column
//     8 j + 2 t + (e & 1), j < N / 8 (CLayout_64xN);
//   * B (8 x N) is read from shared memory through a descriptor.  TF32 takes
//     only the K-major form: N rows of 8 K-contiguous values.  Without a
//     swizzle its canonical layout is a grid of core matrices, each 8 rows
//     x 16 bytes (4 TF32 values) stored as 128 contiguous bytes; the two
//     core matrices along K lie LBO bytes apart, neighbouring 8-row groups
//     along N lie SBO bytes apart (make_gmma_desc<Major::K>, INTERLEAVE:
//     ((8,m),(T,2)):((1T,SBO),(1,LBO))).
// The instruction runs asynchronously: its accumulator and A registers must
// not be touched by other instructions until a wgmma.wait_group has seen it
// complete, and wgmma.fence must precede a wgmma whose registers other
// instructions wrote.  fence_operand keeps the compiler from moving such
// registers across those points (CUTLASS's warpgroup_fence_operand).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <cstdint>

#include "cgemm_3xtf32.cuh"  // smem_u32

namespace rsp {

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (the TMA unit).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also raises the phase's expected transaction count.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed.  A phase that never
// completes (a copy that was never issued, a wrong byte count) traps after
// ~2^24 polls instead of hanging the card: the launch then fails loudly.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (++polls == (1u << 24)) __trap();
  } while (!done);
}

// ---------------------------------------------------------------- bulk copy
// A 1-D copy by the TMA engine, global -> shared, completing on `bar` as
// `bytes` transaction bytes.  dst, src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// A 2-D tile copy by the TMA engine, global -> shared, of the box that
// `map` (a __grid_constant__ CUtensorMap) describes, whose first element is
// at column c0 and row c1 of the tensor; completes on `bar` as the box's
// bytes.  Coordinates may lie outside the tensor, even wholly: those
// elements are zero-filled (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) and not read.
// dst is 128-byte aligned.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar)) : "memory");
}

// The 3-D form of tma_load_2d: the box at column c0, row c1, plane c2.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar)) : "memory");
}

// One arrival on `bar` once every cp.async this thread has issued so far has
// landed; the arrival is counted in the barrier's initial count (.noinc).
__device__ __forceinline__ void cp_async_mbar_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// ------------------------------------------------------------- tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, as the CUDA runtime finds it, looked up once (so
// the library needs no -lcuda); nullptr where it is missing.
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// --------------------------------------------------------------------- wgmma

// Descriptor of a K-major operand in the no-swizzle core-matrix layout.
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(smem) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;  // layout type 0, base 0
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

// d (64 x 96, 48 floats a thread) = A (64 x 8, TF32 in registers) * B (8 x 96,
// TF32 in shared memory at `desc`) + (kAccumulate ? d : 0).
template <int kAccumulate>
__device__ __forceinline__ void wgmma_m64n96k8_tf32(float (&d)[48], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(kAccumulate));
}

}  // namespace rsp
