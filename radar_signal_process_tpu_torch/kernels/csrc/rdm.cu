// B2: windowed Doppler DFT + magnitude + zero-velocity notch in one pass.
//
// Replaces radar_signal_process_tpu/kernels/rdm_pallas.py::doppler_rdm_pallas.
// out[b, k, r] = |sum_n W[k, n] * X[b, n, r]|, with rows [notch_lo, notch_hi]
// written as zero.  W is the host-built (n_fft, n) windowed, fftshift-folded
// DFT plane held as float32 re/im planes; X is complex64 (interleaved float2).
//
// What bounds it on an H100: at G2 (52 x 332 x 3404, n_fft = n = 332) the
// contraction is 4 real GEMMs of 332 x 332 x 3404 per item, ~156 GFLOP per
// window against ~0.47 GB of traffic, so it is bound by FP32 arithmetic on
// the CUDA cores (no TF32, no tensor cores: the reference holds the RDM at
// full f32 precision).  The design is a plain shared-memory tiled complex
// GEMM: a 64 x 64 output tile per block, 16-pulse stages of W and X in shared
// memory, 4 x 4 outputs per thread with one re/im accumulator pair each.  The
// magnitude and the notch are the epilogue, so the complex spectrum never
// reaches device memory.  Ragged edges (332 is no tile multiple) are masked:
// loads past the edge read zero, stores past it are skipped.  Batch is
// grid.z.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBM = 64;  // Doppler rows per block
constexpr int kBN = 64;  // range columns per block
constexpr int kBK = 16;  // pulses per shared-memory stage
constexpr int kTM = 4;   // rows per thread
constexpr int kTN = 4;   // columns per thread
constexpr int kColThreads = kBN / kTN;
constexpr int kThreads = (kBM / kTM) * kColThreads;  // 256

__global__ void __launch_bounds__(kThreads)
doppler_rdm_kernel(const float* __restrict__ w_re, const float* __restrict__ w_im,
                   const float2* __restrict__ x, float* __restrict__ out,
                   int n_fft, int n, int nr, int notch_lo, int notch_hi) {
  // W is staged transposed ([pulse][row]); the +1 pad keeps the transposing
  // stores free of bank conflicts.
  __shared__ float s_wr[kBK][kBM + 1];
  __shared__ float s_wi[kBK][kBM + 1];
  __shared__ float2 s_x[kBK][kBN];

  const int k0 = blockIdx.y * kBM;
  const int r0 = blockIdx.x * kBN;
  const float2* xb = x + static_cast<size_t>(blockIdx.z) * n * nr;
  float* ob = out + static_cast<size_t>(blockIdx.z) * n_fft * nr;
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;

  float acc_re[kTM][kTN];
  float acc_im[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc_re[i][j] = 0.f;
      acc_im[i][j] = 0.f;
    }
  }

  for (int n0 = 0; n0 < n; n0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK;
      const int kk = i % kBK;
      const int gk = k0 + m;
      const int gn = n0 + kk;
      const bool ok = gk < n_fft && gn < n;
      const size_t off = static_cast<size_t>(gk) * n + gn;
      s_wr[kk][m] = ok ? w_re[off] : 0.f;
      s_wi[kk][m] = ok ? w_im[off] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN;
      const int c = i % kBN;
      const int gn = n0 + kk;
      const int gc = r0 + c;
      s_x[kk][c] = (gn < n && gc < nr) ? xb[static_cast<size_t>(gn) * nr + gc]
                                       : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a_re[kTM];
      float a_im[kTM];
      float2 bx[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        a_re[i] = s_wr[kk][ty * kTM + i];
        a_im[i] = s_wi[kk][ty * kTM + i];
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) bx[j] = s_x[kk][tx + j * kColThreads];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc_re[i][j] = fmaf(a_re[i], bx[j].x, acc_re[i][j]);
          acc_re[i][j] = fmaf(-a_im[i], bx[j].y, acc_re[i][j]);
          acc_im[i][j] = fmaf(a_re[i], bx[j].y, acc_im[i][j]);
          acc_im[i][j] = fmaf(a_im[i], bx[j].x, acc_im[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = k0 + ty * kTM + i;
    if (row >= n_fft) continue;
    const bool notched = row >= notch_lo && row <= notch_hi;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = r0 + tx + j * kColThreads;
      if (col >= nr) continue;
      const float re = acc_re[i][j];
      const float im = acc_im[i][j];
      ob[static_cast<size_t>(row) * nr + col] = notched ? 0.f : sqrtf(re * re + im * im);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rsp_doppler_rdm(const void* w_re, const void* w_im, const void* x,
                               void* out, int batch, int n_fft, int n, int nr,
                               int notch_lo, int notch_hi, void* stream) {
  const dim3 grid((nr + kBN - 1) / kBN, (n_fft + kBM - 1) / kBM, batch);
  doppler_rdm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_re), static_cast<const float*>(w_im),
      static_cast<const float2*>(x), static_cast<float*>(out), n_fft, n, nr,
      notch_lo, notch_hi);
  return static_cast<int>(cudaGetLastError());
}
