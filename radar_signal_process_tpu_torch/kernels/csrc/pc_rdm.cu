// B3: fused pulse compression + windowed Doppler DFT + magnitude in one pass.
//
// Replaces radar_signal_process_tpu/kernels/pc_rdm_pallas.py::fused_pc_rdm_pallas.
//
//   P[b, p, j]   = sum_i X[b, p, i] * M[i, j]            (pulse compression)
//   out[b, k, j] = |sum_p W[k, p] * P[b, p, j]|          (Doppler DFT + magnitude)
//
// X is complex64 (interleaved float2), read in place: row stride `ldx` and
// batch stride `sb` in complex elements, so the short/long pulse segments of
// a beam (`beams[..., :62]`, `beams[..., 62:]`) need no copy.  M is the
// per-row PC operator (the 512-point matched filter as a 504 x 512 matrix, or
// the 35-tap raw FIR as a 62 x 62 Toeplitz matrix) and W the windowed,
// zero-padded (n_fft, n_prt) DFT plane, each as float32 re/im planes built on
// the host in float64.
//
// What defines it against B2 after a separate PC: a block owns a 16-column
// range tile and forms its compressed tile P = X M_j in shared memory once;
// every Doppler row of the block reads P from there, so P never reaches
// device memory.
//
// What bounds it on an H100.  At G0 one frame is ~35 GFLOP of FP32 complex
// MAC work (long PC 6.3, long Doppler 25.8, short 3.2) against ~40 MB of
// compulsory traffic: FP32 issue on the CUDA cores bounds it (no TF32, no
// tensor cores: the reference holds the RDM at full f32 precision).  The
// simple design is bounded by shared memory instead:
//   * one P column at n_prt = 1536 is 12 KiB (re + im); a 16-column tile is
//     192 KiB, which with the 32 KiB W stage fills 224 KiB of the 227 KB a
//     block may take, so one block runs per SM;
//   * long segment: 512 / 16 = 32 range tiles x batch 2 = 64 blocks for 132
//     SMs.  The Doppler axis is therefore split over grid.z: the launcher
//     takes floor(SMs / (tiles x batch)) splits, at most the number of
//     256-row Doppler passes: 2 for the long segment (128 blocks), 8 for the
//     short one (64 blocks).  Each split recomputes its P tile, ~20% more
//     FLOP per extra split on the long segment (P is 6.3 of its 32 GFLOP),
//     which buys twice the SMs.  Thread-block clusters sharing P through
//     distributed shared memory, TMA staging of W and wgmma are later work.
//   * W (2048 x 1536 x 2 planes, 25 MB) is read by every block from L2; at
//     16 columns a block does 64 FMA per W element it loads.
// Phase 1 (P): 128 P rows x 16 columns per pass, 16-sample stages of X and M
// in shared memory, 8 complex outputs per thread.  Phase 2 (Doppler): 256
// Doppler rows x 16 columns per pass, 16-pulse stages of W (transposed, so a
// thread reads its 8 rows as two float4s), 8 x 2 complex outputs per thread.
// Both phases prefetch the next stage into registers while computing the
// current one.  Ragged edges (62 and 504 are no tile multiples) are masked:
// loads past an edge read zero, stores past it are skipped.  P rows are
// padded to a multiple of 16 with zeros, and W columns past n_prt read zero.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTJ = 16;                 // range columns per block (P tile width)
// phase 1: P = X M
constexpr int kPR = 128;                // P rows per pass
constexpr int kBI = 16;                 // fast-time samples per X/M stage
constexpr int kXPad = kBI + 1;          // X stage row pitch (float2), conflict-free
constexpr int kXPerThread = kPR * kBI / kThreads;   // 8
constexpr int kPCols = kTJ / 2;         // P columns per thread (two threads per row)
// phase 2: |W P|
constexpr int kBM = 256;                // Doppler rows per pass (one staged W row per thread)
constexpr int kBK = 16;                 // pulses per W stage
constexpr int kTM = 8;                  // Doppler rows per thread
constexpr int kTN = 2;                  // columns per thread
constexpr int kColThreads = kTJ / kTN;  // 8
constexpr int kStageFloats = 2 * kBK * kBM;         // W re + im stage: 32 KiB

static_assert(kBI * kTJ == kThreads, "one M element per thread per stage");
static_assert(kPR * 2 == kThreads, "two threads per P row");
static_assert((kBM / kTM) * kColThreads == kThreads, "phase-2 thread tiling");
static_assert(kBM == kThreads, "one staged W row per thread");
static_assert(2 * (kPR * kXPad + kBI * kTJ) <= kStageFloats, "X/M stage fits the W stage");

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ void cmac(float& re, float& im, float ar, float ai, float br,
                                     float bi) {
  re = fmaf(ar, br, re);
  re = fmaf(-ai, bi, re);
  im = fmaf(ar, bi, im);
  im = fmaf(ai, br, im);
}

__global__ void __launch_bounds__(kThreads, 1)
fused_pc_rdm_kernel(const float2* __restrict__ x, long long sb, int ldx,
                    const float* __restrict__ m_re, const float* __restrict__ m_im,
                    const float* __restrict__ w_re, const float* __restrict__ w_im,
                    float* __restrict__ out, int n_prt, int n_in, int n_out, int n_fft,
                    int n_split, int w_vec) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                                           // shared by both phases
  float2* s_p = reinterpret_cast<float2*>(smem + kStageFloats);  // [n_prt_pad][kTJ]

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kTJ;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_prt_pad = round_up(n_prt, kBK);
  const float2* xb = x + static_cast<size_t>(b) * sb;

  // ------------------------------------------------ phase 1: P = X M_j
  {
    float2* s_x = reinterpret_cast<float2*>(stage);  // [kPR][kXPad]
    float2* s_m = s_x + kPR * kXPad;                 // [kBI][kTJ]
    const int row = tid / 2;
    const int half = tid % 2;
    const int n_i = (n_in + kBI - 1) / kBI;
    const int total = ((n_prt_pad + kPR - 1) / kPR) * n_i;
    float2 xr[kXPerThread];
    float2 mr;

    auto fetch = [&](int s) {
      const int p0 = (s / n_i) * kPR;
      const int i0 = (s % n_i) * kBI;
#pragma unroll
      for (int e = 0; e < kXPerThread; ++e) {
        const int idx = tid + e * kThreads;
        const int gp = p0 + idx / kBI;
        const int gi = i0 + idx % kBI;
        xr[e] = (gp < n_prt && gi < n_in) ? xb[static_cast<size_t>(gp) * ldx + gi]
                                          : make_float2(0.f, 0.f);
      }
      const int gi = i0 + tid / kTJ;
      const int gj = j0 + tid % kTJ;
      const size_t off = static_cast<size_t>(gi) * n_out + gj;
      mr = (gi < n_in && gj < n_out) ? make_float2(m_re[off], m_im[off]) : make_float2(0.f, 0.f);
    };
    auto put = [&]() {
#pragma unroll
      for (int e = 0; e < kXPerThread; ++e) {
        const int idx = tid + e * kThreads;
        s_x[(idx / kBI) * kXPad + idx % kBI] = xr[e];
      }
      s_m[tid] = mr;
    };

    float acc_re[kPCols];
    float acc_im[kPCols];
#pragma unroll
    for (int c = 0; c < kPCols; ++c) acc_re[c] = acc_im[c] = 0.f;

    fetch(0);
    put();
    __syncthreads();
    for (int s = 0; s < total; ++s) {
      if (s + 1 < total) fetch(s + 1);  // in flight while this stage computes
#pragma unroll
      for (int ii = 0; ii < kBI; ++ii) {
        const float2 xv = s_x[row * kXPad + ii];
        const float4* mrow = reinterpret_cast<const float4*>(s_m + ii * kTJ + half * kPCols);
#pragma unroll
        for (int q = 0; q < kPCols / 2; ++q) {
          const float4 mv = mrow[q];
          cmac(acc_re[2 * q], acc_im[2 * q], xv.x, xv.y, mv.x, mv.y);
          cmac(acc_re[2 * q + 1], acc_im[2 * q + 1], xv.x, xv.y, mv.z, mv.w);
        }
      }
      if (s % n_i == n_i - 1) {  // this pass of kPR rows is complete
        const int gp = (s / n_i) * kPR + row;
        if (gp < n_prt_pad) {
#pragma unroll
          for (int c = 0; c < kPCols; ++c)
            s_p[gp * kTJ + half * kPCols + c] = make_float2(acc_re[c], acc_im[c]);
        }
#pragma unroll
        for (int c = 0; c < kPCols; ++c) acc_re[c] = acc_im[c] = 0.f;
      }
      __syncthreads();
      if (s + 1 < total) put();
      __syncthreads();
    }
  }

  // ------------------------------------------ phase 2: |W_k P| per Doppler pass
  {
    float* s_wr = stage;              // [kBK][kBM], W transposed
    float* s_wi = stage + kBK * kBM;
    const int tx = tid % kColThreads;
    const int ty = tid / kColThreads;
    const int n_p = n_prt_pad / kBK;
    const int n_chunks = (n_fft + kBM - 1) / kBM;
    const int my_chunks = split < n_chunks ? (n_chunks - 1 - split) / n_split + 1 : 0;
    const int total = my_chunks * n_p;
    float* ob = out + static_cast<size_t>(b) * n_fft * n_out;
    float4 wr4[kBK / 4];
    float4 wi4[kBK / 4];

    auto fetch = [&](int s) {
      const int gk = (split + (s / n_p) * n_split) * kBM + tid;
      const int p0 = (s % n_p) * kBK;
      const bool row_ok = gk < n_fft;
      const size_t base = static_cast<size_t>(gk) * n_prt;
#pragma unroll
      for (int q = 0; q < kBK / 4; ++q) {
        const int gp = p0 + 4 * q;
        if (w_vec) {  // n_prt % 4 == 0: a float4 is wholly inside or outside
          const bool ok = row_ok && gp < n_prt;
          wr4[q] = ok ? *reinterpret_cast<const float4*>(w_re + base + gp)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
          wi4[q] = ok ? *reinterpret_cast<const float4*>(w_im + base + gp)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          float r[4], i[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = row_ok && gp + e < n_prt;
            r[e] = ok ? w_re[base + gp + e] : 0.f;
            i[e] = ok ? w_im[base + gp + e] : 0.f;
          }
          wr4[q] = make_float4(r[0], r[1], r[2], r[3]);
          wi4[q] = make_float4(i[0], i[1], i[2], i[3]);
        }
      }
    };
    auto put = [&]() {
#pragma unroll
      for (int q = 0; q < kBK / 4; ++q) {
        s_wr[(4 * q + 0) * kBM + tid] = wr4[q].x;
        s_wr[(4 * q + 1) * kBM + tid] = wr4[q].y;
        s_wr[(4 * q + 2) * kBM + tid] = wr4[q].z;
        s_wr[(4 * q + 3) * kBM + tid] = wr4[q].w;
        s_wi[(4 * q + 0) * kBM + tid] = wi4[q].x;
        s_wi[(4 * q + 1) * kBM + tid] = wi4[q].y;
        s_wi[(4 * q + 2) * kBM + tid] = wi4[q].z;
        s_wi[(4 * q + 3) * kBM + tid] = wi4[q].w;
      }
    };

    float acc_re[kTM][kTN];
    float acc_im[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc_re[i][c] = acc_im[i][c] = 0.f;

    if (total > 0) {
      fetch(0);
      put();
    }
    __syncthreads();
    for (int s = 0; s < total; ++s) {
      if (s + 1 < total) fetch(s + 1);
      const int p0 = (s % n_p) * kBK;
#pragma unroll
      for (int pp = 0; pp < kBK; ++pp) {
        const float4 pv = *reinterpret_cast<const float4*>(s_p + (p0 + pp) * kTJ + tx * kTN);
        const float4* wr = reinterpret_cast<const float4*>(s_wr + pp * kBM + ty * kTM);
        const float4* wi = reinterpret_cast<const float4*>(s_wi + pp * kBM + ty * kTM);
        const float4 r0 = wr[0], r1 = wr[1], i0 = wi[0], i1 = wi[1];
        const float a_re[kTM] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
        const float a_im[kTM] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          cmac(acc_re[i][0], acc_im[i][0], a_re[i], a_im[i], pv.x, pv.y);
          cmac(acc_re[i][1], acc_im[i][1], a_re[i], a_im[i], pv.z, pv.w);
        }
      }
      if (s % n_p == n_p - 1) {  // this Doppler pass is complete: magnitude epilogue
        const int k0 = (split + (s / n_p) * n_split) * kBM;
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int row = k0 + ty * kTM + i;
#pragma unroll
          for (int c = 0; c < kTN; ++c) {
            const int col = j0 + tx * kTN + c;
            if (row < n_fft && col < n_out) {
              const float re = acc_re[i][c];
              const float im = acc_im[i][c];
              ob[static_cast<size_t>(row) * n_out + col] = sqrtf(re * re + im * im);
            }
            acc_re[i][c] = acc_im[i][c] = 0.f;
          }
        }
      }
      __syncthreads();
      if (s + 1 < total) put();
      __syncthreads();
    }
  }
}

size_t smem_bytes(int n_prt) {
  return sizeof(float) * (static_cast<size_t>(kStageFloats) +
                          static_cast<size_t>(round_up(n_prt, kBK)) * kTJ * 2);
}

}  // namespace

// Dynamic shared memory one block needs for `n_prt` pulses.
extern "C" int rsp_fused_pc_rdm_smem_bytes(int n_prt) {
  return static_cast<int>(smem_bytes(n_prt));
}

// Launches on `stream`; returns the first cudaError_t (0 on success).
// x: complex64 with unit fast-time stride, row stride `ldx`, batch stride `sb`
// (complex elements); m_re/m_im (n_in, n_out), w_re/w_im (n_fft, n_prt)
// contiguous float32; out (batch, n_fft, n_out) float32.  `n_sms` is the
// card's SM count; `w_vec` = 1 when n_prt % 4 == 0 and the W planes are
// 16-byte aligned.
extern "C" int rsp_fused_pc_rdm(const void* x, long long sb, int ldx, const void* m_re,
                                const void* m_im, const void* w_re, const void* w_im,
                                void* out, int batch, int n_prt, int n_in, int n_out,
                                int n_fft, int n_sms, int w_vec, void* stream) {
  const int tiles = (n_out + kTJ - 1) / kTJ;
  const int passes = (n_fft + kBM - 1) / kBM;
  int n_split = n_sms / (tiles * batch);
  n_split = n_split < 1 ? 1 : (n_split > passes ? passes : n_split);
  const size_t smem = smem_bytes(n_prt);
  cudaError_t err = cudaFuncSetAttribute(
      fused_pc_rdm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, batch, n_split);
  fused_pc_rdm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), sb, ldx, static_cast<const float*>(m_re),
      static_cast<const float*>(m_im), static_cast<const float*>(w_re),
      static_cast<const float*>(w_im), static_cast<float*>(out), n_prt, n_in, n_out, n_fft,
      n_split, w_vec);
  return static_cast<int>(cudaGetLastError());
}
