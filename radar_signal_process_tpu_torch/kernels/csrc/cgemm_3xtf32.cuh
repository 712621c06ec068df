// Shared core of B2 (rdm.cu) and B3 (pc_rdm.cu): the TF32 hi/lo split of
// their 3xTF32 complex products on the Hopper tensor cores, and the cp.async
// helpers of their shared-memory rings (B1, cfar.cu, takes those too).
//
// It serves the ports of two TPU kernels whose four real matmuls ran on the
// matrix unit in f32:
//   radar_signal_process_tpu/kernels/rdm_pallas.py::doppler_rdm_pallas   (B2)
//   radar_signal_process_tpu/kernels/pc_rdm_pallas.py::fused_pc_rdm_pallas (B3)
//
// Error model (3xTF32).  TF32 keeps 10 explicit mantissa bits, about three
// decimal digits, so one TF32 pass is not allowed (the RDMs are held at f32
// tolerance).  Each operand is split, in registers as its wgmma fragment is
// formed or once into a shared-memory image that wgmma reads:
//   a_hi = rna_tf32(a),   a_lo = rna_tf32(a - a_hi)
// where rna_tf32 rounds to 10 mantissa bits to nearest, ties away from zero:
// the rounding of cvt.rna.tf32.f32, done here as an integer add of half a
// TF32 ulp and a mask of the 13 low bits (the same bits for every finite
// input; on the card it is ~9% faster than cvt, which issues on a slower
// pipe).  a - a_hi is exact in FP32.  A real product is three TF32
// products, a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, summed in FP32.
// a = a_hi + a_lo + e with |e| <= 2^-22 |a|, and the dropped a_lo*b_lo term
// is below 2^-22 |a b|, so a product carries a relative error of about
// 2^-22 (FP32 rounding is 2^-24).  A complex product is four real products
// into separate FP32 re and im accumulators (re = ar br - ai bi, im = ar bi +
// ai br); Gauss's three-multiply form is not used, since it changes the
// error.
// The tensor core adds into its FP32 accumulator with truncation, not
// round-to-nearest, so a chain of products over the whole K axis gathers a
// one-sided error that grows with K: 3e-5 of the peak at K = 1536 with one
// strong target, on the card.  So the products sum into partials that
// start from zero every 16 (B2) or 32 (B3) deep K, and each partial is added
// to the accumulator with an ordinary FP32 add (round to nearest).  The
// truncation then touches only partials.
// tests/test_torch_kernels.py emulates the rounding in numpy and pins the
// bound; the card tests and chip_smoke.py hold the kernels to it.
//
// No --use_fast_math (kernels/_build.py adds none; keep it so): the split
// relies on exact FP32 subtraction, and the magnitude epilogues on IEEE sqrt.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace rsp {

// rna_tf32: round to nearest, ties away from zero, to TF32 (as cvt.rna.tf32.f32).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ------------------------------------------------------------- cp.async ring
// Each copy names how many source bytes are real; the rest of the
// destination is zero-filled, so ragged edges need no branch around a load.
// With zero source bytes the source address is not read: callers pass the
// array's base then, so no address past an edge is ever formed.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace rsp
