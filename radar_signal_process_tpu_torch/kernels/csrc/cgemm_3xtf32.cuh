// Shared core of B2 (rdm.cu) and B3 (pc_rdm.cu): a warp-level complex tile
// product on the Hopper tensor cores at FP32 accuracy, and the cp.async
// helpers of their shared-memory rings.
//
// It serves the ports of two TPU kernels whose four real matmuls ran on the
// matrix unit in f32:
//   radar_signal_process_tpu/kernels/rdm_pallas.py::doppler_rdm_pallas   (B2)
//   radar_signal_process_tpu/kernels/pc_rdm_pallas.py::fused_pc_rdm_pallas (B3)
//
// Tensor-core product: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
// Error model (3xTF32).  TF32 keeps 10 explicit mantissa bits, about three
// decimal digits, so one TF32 pass is not allowed (the RDMs are held at f32
// tolerance).  Each operand is split when its fragment is loaded from shared
// memory (or, for an operand many warps read, once as it enters the ring):
//   a_hi = rna_tf32(a),   a_lo = rna_tf32(a - a_hi)
// where rna_tf32 rounds to 10 mantissa bits to nearest, ties away from zero:
// the rounding of cvt.rna.tf32.f32, done here as an integer add of half a
// TF32 ulp and a mask of the 13 low bits (the same bits for every finite
// input; on the card it is ~9% faster than cvt, which issues on a slower
// pipe).  a - a_hi is exact in FP32.  A real product is three mma's,
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, summed in FP32.  a = a_hi + a_lo + e
// with |e| <= 2^-22 |a|, and the dropped a_lo*b_lo term is below 2^-22 |a b|,
// so a product carries a relative error of about 2^-22 (FP32 rounding is
// 2^-24).  A complex product is four real products into separate FP32 re and
// im accumulators (re = ar br - ai bi, im = ar bi + ai br); Gauss's
// three-multiply form is not used, since it changes the error.
// The tensor core adds into its FP32 accumulator with truncation, not
// round-to-nearest, so a chain of mma's over the whole K axis gathers a
// one-sided error that grows with K: 3e-5 of the peak at K = 1536 with one
// strong target, on the card.  So the mma's sum into partials that start
// from zero every F 8-deep K-steps (F = 1 in B2, 2 in B3), and each partial
// is added to the accumulator with an ordinary FP32 add (round to nearest).
// The truncation then touches only partials: its sum stays near 3F * 2^-23
// of the peak (3.6e-7 of it measured at F = 1).
// tests/test_torch_kernels.py emulates the rounding in numpy and pins the
// bound; the card tests and chip_smoke.py hold the kernels to it.
//
// No --use_fast_math (kernels/_build.py adds none; keep it so): the split
// relies on exact FP32 subtraction, and the magnitude epilogues on IEEE sqrt.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g)  b1 (t + 4, g)                 (k, n)
//   C (16 x 8):       c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace rsp {

// A fragment of a complex 16 x 8 operand, split into TF32 hi and lo parts;
// the negated imaginary part feeds the real accumulator's -ai*bi term.
struct FragA {
  uint32_t re_hi[4], re_lo[4], im_hi[4], im_lo[4], nim_hi[4], nim_lo[4];
};

// A fragment of a complex 8 x 8 operand, split into TF32 hi and lo parts.
struct FragB {
  uint32_t re_hi[2], re_lo[2], im_hi[2], im_lo[2];
};

// rna_tf32: round to nearest, ties away from zero, to TF32 (as cvt.rna.tf32.f32).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = A*B with a zero accumulator: the first mma of a K-step's chain.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// Partial sums of NT complex 16 x 8 x 8 steps that share one A fragment,
// pr/pi[j] += A*B[j]: 12 mma's per tile, the small terms of each real product
// first, issued term by term across the tiles so that 2 NT accumulator chains
// are in flight.  kFirst starts the partials from zero.
template <bool kFirst, int NT>
__device__ __forceinline__ void cmma_n(float (&pr)[NT][4], float (&pi)[NT][4], const FragA& a,
                                       const FragB (&b)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (kFirst) {
      mma_tf32_zero(pr[j], a.re_lo, b[j].re_hi);
      mma_tf32_zero(pi[j], a.re_lo, b[j].im_hi);
    } else {
      mma_tf32(pr[j], a.re_lo, b[j].re_hi);
      mma_tf32(pi[j], a.re_lo, b[j].im_hi);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_tf32(pr[j], a.re_hi, b[j].re_lo);
    mma_tf32(pi[j], a.re_hi, b[j].im_lo);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_tf32(pr[j], a.re_hi, b[j].re_hi);
    mma_tf32(pi[j], a.re_hi, b[j].im_hi);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_tf32(pr[j], a.nim_lo, b[j].im_hi);
    mma_tf32(pi[j], a.im_lo, b[j].re_hi);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_tf32(pr[j], a.nim_hi, b[j].im_lo);
    mma_tf32(pi[j], a.im_hi, b[j].re_lo);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_tf32(pr[j], a.nim_hi, b[j].im_hi);
    mma_tf32(pi[j], a.im_hi, b[j].re_hi);
  }
}

// acc += partial, rounded to nearest.
__device__ __forceinline__ void flush(float (&re)[4], float (&im)[4], const float (&pr)[4],
                                      const float (&pi)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    re[e] += pr[e];
    im[e] += pi[e];
  }
}

__device__ __forceinline__ void set_a(FragA& f, int e, float re, float im) {
  split(re, f.re_hi[e], f.re_lo[e]);
  split(im, f.im_hi[e], f.im_lo[e]);
  f.nim_hi[e] = f.im_hi[e] ^ 0x80000000u;  // split(-x) = -split(x) exactly
  f.nim_lo[e] = f.im_lo[e] ^ 0x80000000u;
}

// A fragment from re/im planes, row-major [m][k] with pitch `ld` floats;
// `re`/`im` point at the tile's (0, 0).
__device__ __forceinline__ void load_a_planes(FragA& f, const float* re, const float* im,
                                              int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int off = (g + 8 * (e & 1)) * ld + t + 4 * (e >> 1);
    set_a(f, e, re[off], im[off]);
  }
}

// A fragment from interleaved complex, row-major [m][k] with pitch `ld`.
__device__ __forceinline__ void load_a_cplx(FragA& f, const float2* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = s[(g + 8 * (e & 1)) * ld + t + 4 * (e >> 1)];
    set_a(f, e, v.x, v.y);
  }
}

// B fragment from interleaved complex, [k][n] with pitch `ld`.
__device__ __forceinline__ void load_b_cplx(FragB& f, const float2* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float2 v = s[(t + 4 * e) * ld + g];
    split(v.x, f.re_hi[e], f.re_lo[e]);
    split(v.y, f.im_hi[e], f.im_lo[e]);
  }
}

// A B operand split once for the many warps that read it, stored so that a
// fragment is two 16-byte loads whose words feed the mma's register pairs
// as they are: for each 8-deep K-step, row t (0..3) and column n hold
//   hi = {re_hi(t, n), re_hi(t + 4, n), im_hi(t, n), im_hi(t + 4, n)}
//   lo = {re_lo(t, n), re_lo(t + 4, n), im_lo(t, n), im_lo(t + 4, n)}
// in two [4][ld] uint4 planes, lo `4 * ld` after hi.  (Quads that pair each
// value with its own hi/lo would cost two register moves per operand pair.)
// b0 and b1 are the complex values at rows t and t + 4 of column n.
__device__ __forceinline__ void put_b_quads(uint4* hi, uint4* lo, float2 b0, float2 b1) {
  uint4 h, l;
  split(b0.x, h.x, l.x);
  split(b1.x, h.y, l.y);
  split(b0.y, h.z, l.z);
  split(b1.y, h.w, l.w);
  *hi = h;
  *lo = l;
}

// B fragment of one 8-deep K-step from put_b_quads planes; `s` points at row
// 0 of the hi plane, at the tile's first column, with pitch `ld` uint4.
__device__ __forceinline__ void load_b_quads(FragB& f, const uint4* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint4 h = s[t * ld + g];
  const uint4 l = s[(4 + t) * ld + g];
  f.re_hi[0] = h.x, f.re_hi[1] = h.y, f.im_hi[0] = h.z, f.im_hi[1] = h.w;
  f.re_lo[0] = l.x, f.re_lo[1] = l.y, f.im_lo[0] = l.z, f.im_lo[1] = l.w;
}

// Row and column inside the 16 x 8 tile of accumulator element e (0..3).
__device__ __forceinline__ int acc_row(int lane, int e) { return (lane >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int lane, int e) { return 2 * (lane & 3) + (e & 1); }

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

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

}  // namespace rsp
