// B2: windowed Doppler DFT + magnitude + zero-velocity notch in one pass.
//
// Replaces radar_signal_process_tpu/kernels/rdm_pallas.py::doppler_rdm_pallas.
// out[b, k, r] = |sum_n W[k, n] * X[b, n, r]|, with rows [notch_lo, notch_hi]
// written as zero.  W is the host-built (n_fft, n) windowed, fftshift-folded
// DFT plane held as float32 re/im planes; X is complex64 (interleaved float2).
//
// What bounds it on an H100: at G2 (52 x 332 x 3404, n_fft = n = 332) the
// contraction is 4 real GEMMs of 332 x 332 x 3404 per item, ~156 GFLOP per
// window against ~0.7 GB of compulsory traffic (X in, RDM out), so it is
// bound by arithmetic.  FP32 on the CUDA cores peaks at 67 TFLOP/s; the
// tensor cores do 495 TFLOP/s of TF32.  The design runs on the tensor cores
// at FP32 accuracy through the 3xTF32 split of cgemm_3xtf32.cuh (three
// TF32 mma's per real product, ~2^-22 relative error per product):
//   * block tile 48 Doppler rows x 128 range columns, 4 warps side by side
//     along the range, each warp 48 x 32 (3 x 4 m16n8 tiles, 96 FP32
//     accumulators per thread).  48 divides 336 = 21 x 16, so the 332 rows
//     waste 1.2% instead of 13.5% for 64-row tiles; a 73,728 B ring and
//     up to 255 registers leave two blocks (8 warps) per SM;
//   * 16-pulse K-steps staged by a 3-stage cp.async ring: W as re/im planes
//     (16-byte copies when n % 4 == 0), X as interleaved float2 rows (16-byte
//     copies of 2 samples when the row stride is even).  Ragged edges read
//     zero through the copies' source size.  Stage pitches are padded (W 20
//     floats, X 132 float2) so the fragment loads are free of bank conflicts;
//     re/im are de-interleaved and split into TF32 hi/lo as the fragments are
//     loaded, and the mma's of a step go out term by term across the warp's
//     four n8 tiles (cmma_n), each partial flushed after its 8-deep step;
//   * the Doppler tile is blockIdx.x, so the 7 blocks that read one X tile run
//     together and X comes from device memory about once (the rest from L2);
//   * the magnitude and the notch are the epilogue, so the complex spectrum
//     never reaches device memory.  Batch is grid.z.
// What bounds it now (an H100 at 700 W): ~56-61 FP32-equivalent TFLOP/s, the
// mma's issuing at ~14.6 cycles each against the card's ~6.7-cycle floor
// for mma.sync m16n8k8 TF32.  Eight warps per SM hide little of each step's
// load -> split -> mma chain, and every warp splits the same W fragments.

#include <cuda_runtime.h>

#include <cstddef>

#include "cgemm_3xtf32.cuh"

namespace {

using namespace rsp;

constexpr int kBM = 48;                // Doppler rows per block
constexpr int kBN = 128;               // range columns per block
constexpr int kBK = 16;                // pulses per stage
constexpr int kStages = 3;
constexpr int kWarps = 4;              // side by side along the range
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = kBM / 16;          // m16 tiles per warp
constexpr int kNT = kBN / kWarps / 8;  // n8 tiles per warp
constexpr int kLdW = kBK + 4;          // W stage pitch (floats)
constexpr int kLdX = kBN + 4;          // X stage pitch (float2)
constexpr int kWPlane = kBM * kLdW;                      // floats
constexpr int kStageFloats = 2 * kWPlane + 2 * kBK * kLdX;
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;

static_assert(kBM % 16 == 0 && kBN % (8 * kWarps) == 0, "warp tiling");
static_assert(kLdW % 32 == 20 && kLdX % 8 == 4, "bank-conflict-free fragment pitches");
static_assert((2 * kWPlane) % 4 == 0 && kStageFloats % 4 == 0, "16-byte aligned stages");

__global__ void __launch_bounds__(kThreads, 2)
doppler_rdm_kernel(const float* __restrict__ w_re, const float* __restrict__ w_im,
                   const float2* __restrict__ x, float* __restrict__ out,
                   int n_fft, int n, int nr, int notch_lo, int notch_hi, int w_vec,
                   int x_vec) {
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.x * kBM;
  const int r0 = blockIdx.y * kBN;
  const float2* xb = x + static_cast<size_t>(blockIdx.z) * n * nr;
  float* ob = out + static_cast<size_t>(blockIdx.z) * n_fft * nr;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_k = (n + kBK - 1) / kBK;

  // Stage kt of W (kBM x kBK) and X (kBK x kBN) into ring slot `slot`.
  auto load = [&](int kt, int slot) {
    float* s_wr = smem + slot * kStageFloats;
    float* s_wi = s_wr + kWPlane;
    float2* s_x = reinterpret_cast<float2*>(s_wr + 2 * kWPlane);
    const int p0 = kt * kBK;
    if (w_vec) {  // 4 pulses per copy
      constexpr int kChunks = kBM * kBK / 4;
      for (int c = tid; c < kChunks; c += kThreads) {
        const int m = c / (kBK / 4);
        const int q = (c % (kBK / 4)) * 4;
        const int gk = k0 + m, gp = p0 + q;
        const int bytes = (gk < n_fft && gp < n) ? 4 * min(4, n - gp) : 0;
        const size_t off = bytes ? static_cast<size_t>(gk) * n + gp : 0;
        cp_async16(s_wr + m * kLdW + q, w_re + off, bytes);
        cp_async16(s_wi + m * kLdW + q, w_im + off, bytes);
      }
    } else {
      constexpr int kElems = kBM * kBK;
      for (int c = tid; c < kElems; c += kThreads) {
        const int m = c / kBK;
        const int q = c % kBK;
        const int gk = k0 + m, gp = p0 + q;
        const int bytes = (gk < n_fft && gp < n) ? 4 : 0;
        const size_t off = bytes ? static_cast<size_t>(gk) * n + gp : 0;
        cp_async4(s_wr + m * kLdW + q, w_re + off, bytes);
        cp_async4(s_wi + m * kLdW + q, w_im + off, bytes);
      }
    }
    if (x_vec) {  // 2 samples per copy
      constexpr int kChunks = kBK * kBN / 2;
#pragma unroll
      for (int e = 0; e < kChunks / kThreads; ++e) {
        const int c = tid + e * kThreads;
        const int kk = c / (kBN / 2);
        const int q = (c % (kBN / 2)) * 2;
        const int gp = p0 + kk, gc = r0 + q;
        const int bytes = (gp < n && gc < nr) ? 8 * min(2, nr - gc) : 0;
        const size_t off = bytes ? static_cast<size_t>(gp) * nr + gc : 0;
        cp_async16(s_x + kk * kLdX + q, xb + off, bytes);
      }
    } else {
      constexpr int kElems = kBK * kBN;
#pragma unroll 4
      for (int e = 0; e < kElems / kThreads; ++e) {
        const int c = tid + e * kThreads;
        const int kk = c / kBN;
        const int q = c % kBN;
        const int gp = p0 + kk, gc = r0 + q;
        const int bytes = (gp < n && gc < nr) ? 8 : 0;
        const size_t off = bytes ? static_cast<size_t>(gp) * nr + gc : 0;
        cp_async8(s_x + kk * kLdX + q, xb + off, bytes);
      }
    }
  };

  float acc_re[kMT][kNT][4];
  float acc_im[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_re[i][j][e] = acc_im[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's, and slot kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < n_k) load(next, next % kStages);
    cp_async_commit();

    const float* s_wr = smem + (kt % kStages) * kStageFloats;
    const float* s_wi = s_wr + kWPlane;
    const float2* s_x = reinterpret_cast<const float2*>(s_wr + 2 * kWPlane) + warp * kNT * 8;
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      FragB b[kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j) load_b_cplx(b[j], s_x + k8 * kLdX + j * 8, kLdX, lane);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        FragA a;
        load_a_planes(a, s_wr + i * 16 * kLdW + k8, s_wi + i * 16 * kLdW + k8, kLdW, lane);
        float pr[kNT][4], pi[kNT][4];
        cmma_n<true>(pr, pi, a, b);
#pragma unroll
        for (int j = 0; j < kNT; ++j) flush(acc_re[i][j], acc_im[i][j], pr[j], pi[j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + i * 16 + acc_row(lane, e);
      if (row >= n_fft) continue;
      const bool notched = row >= notch_lo && row <= notch_hi;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = r0 + (warp * kNT + j) * 8 + acc_col(lane, e);
        if (col >= nr) continue;
        const float re = acc_re[i][j][e];
        const float im = acc_im[i][j][e];
        ob[static_cast<size_t>(row) * nr + col] = notched ? 0.f : sqrtf(re * re + im * im);
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns the first cudaError_t (0 on success).
// w_re/w_im (n_fft, n) and x (batch, n, nr) complex64 contiguous; out
// (batch, n_fft, nr) float32.  `w_vec` = 1 when n % 4 == 0 and both W planes
// are 16-byte aligned; `x_vec` = 1 when nr is even and x is 16-byte aligned.
extern "C" int rsp_doppler_rdm(const void* w_re, const void* w_im, const void* x,
                               void* out, int batch, int n_fft, int n, int nr,
                               int notch_lo, int notch_hi, int w_vec, int x_vec,
                               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      doppler_rdm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_fft + kBM - 1) / kBM, (nr + kBN - 1) / kBN, batch);
  doppler_rdm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_re), static_cast<const float*>(w_im),
      static_cast<const float2*>(x), static_cast<float*>(out), n_fft, n, nr,
      notch_lo, notch_hi, w_vec, x_vec);
  return static_cast<int>(cudaGetLastError());
}
