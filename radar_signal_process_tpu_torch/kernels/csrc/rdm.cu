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
// bound by arithmetic: 0.946 ms as 3xTF32 at the tensor cores' 495 TFLOP/s
// of TF32 (kernels/cost_model.py).  The full TF32 rate is reached only
// through Hopper's warpgroup MMA (wgmma, sm90_async.cuh).
//
// The design computes each block's tile transposed, in real form:
//   D^T (range x 2 Nf) = Xr^T B_r + Xi^T B_i,
//   B_r = [Wr[F, :] ; Wi[F, :]]^T,  B_i = [-Wi[F, :] ; Wr[F, :]]^T   (K = pulses)
// for a Doppler tile F of Nf = 48 rows: columns [0, Nf) are Re(W X)^T and
// [Nf, 2 Nf) Im(W X)^T, so a thread holds a Doppler row's re and im in the
// same accumulator slot of two n8 groups and forms the magnitude alone.
//   * X is the A operand, from registers: its fragment (64 range x 8 pulses)
//     is loaded from the shared-memory stage and split into TF32 hi/lo in
//     registers (cgemm_3xtf32.cuh's rna split).  W^T is the B operand, from
//     shared memory; it is K-major as W is stored (pulses contiguous).
//   * 3xTF32: six wgmma.m64n96k8 per 8-pulse step and warpgroup, the small
//     terms first: Xr_lo B_r_hi, Xr_hi B_r_lo, Xi_lo B_i_hi, Xi_hi B_i_lo,
//     Xr_hi B_r_hi, Xi_hi B_i_hi (lo.lo dropped).
//   * The tensor core adds into its accumulator with truncation, so a chain
//     over all of K drifts one way (cgemm_3xtf32.cuh).  Each 16-pulse stage
//     sums into a fresh partial (scale-d 0 on its first wgmma), and the
//     partial is added into FP32 totals, rounded to nearest, once the
//     stage's wgmmas have completed.  Two partials alternate, so one stage's
//     flush overlaps the next stage's products.
//   * W is split once per call by split_w_kernel into four TF32 planes
//     (B_r hi/lo, B_i hi/lo), Doppler rows padded to Nf, pulses to the
//     16-pulse stage, each stage's 24 KB already laid out as the shared-
//     memory image the wgmma descriptors read (no swizzle, 8 x 16-byte core
//     matrices).  The main loop brings it in with one TMA bulk copy per
//     stage, completing on the stage's mbarrier.  X comes by cp.async with
//     zero-fill on ragged edges (16-byte copies of 2 samples when x_vec) into
//     rows padded to 132 float2, so the fragment loads are free of bank
//     conflicts.  A ring of 5 stages, 3 in flight ahead of the one in use.
//   * Block: two warpgroups side by side along the range (128 range x 48
//     Doppler rows), one block per SM (207 KB of ring).  The Doppler tile is
//     blockIdx.x, so the 7 blocks that read one X tile at G2 run together.
//   * The magnitude and the notch are the epilogue: the tile is staged
//     through shared memory so that each row of out[b, f, :] is stored by
//     whole warps in consecutive addresses.  Batch is grid.z.
// Measured (tools/bench_b2.py, NVIDIA H100 80GB HBM3 at a 700 W power limit):
// G2 1.79-1.83 ms of device time (CUDA graph), 1.94-1.98 ms a call, ~80
// FP32-equivalent TFLOP/s, 48% of the bound; G1 (2 x 1536 x 1536 x 868)
// 0.43-0.44 ms device; the W split 7 us at G2.  What bounds it now is the
// memory side, not the tensor cores: with the wgmmas cut out the kernel
// still takes 1.24-1.29 ms at G2 (with the X copies cut, 1.59-1.60).  Each
// block reads its Doppler tile's W planes and X tile through L2, ~8.4 GB a
// G2 window; sharing them across a cluster (TMA multicast) is the next step.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "cgemm_3xtf32.cuh"
#include "sm90_async.cuh"

namespace {

using namespace rsp;

constexpr int kNf = 48;                      // Doppler rows per block
constexpr int kN = 2 * kNf;                  // wgmma N: re then im columns
constexpr int kBK = 16;                      // pulses per stage (= flush period)
constexpr int kStages = 5;
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBM = 64 * kWarpgroups;        // range columns per block
constexpr int kLdX = kBM + 4;                // X stage pitch (float2)
constexpr int kLdO = kBM + 4;                // epilogue pitch (floats)
constexpr int kPlaneFloats = kN * kBK;       // one TF32 plane of a stage
constexpr int kWStageFloats = 4 * kPlaneFloats;
constexpr uint32_t kWStageBytes = sizeof(float) * kWStageFloats;
constexpr int kStageFloats = kWStageFloats + 2 * kBK * kLdX;
constexpr uint32_t kLbo = 128;               // next 4 pulses: the next core matrix
constexpr uint32_t kSbo = 128 * (kBK / 4);   // next 8 rows: past a row group's K
constexpr size_t kSmemBytes =
    sizeof(float) * kStages * kStageFloats + sizeof(uint64_t) * kStages;

static_assert(kNf % 8 == 0 && kN <= 256, "wgmma N");
static_assert(kBK % 8 == 0, "whole 8-pulse steps");
static_assert(kLdX % 8 == 4 && kLdO % 32 == 4, "bank-conflict-free fragment and staging pitches");
static_assert((sizeof(float) * kStageFloats) % 128 == 0, "16-byte aligned stages and copies");
static_assert(kNf * kLdO <= kStages * kStageFloats, "the epilogue tile fits the ring");

// Four TF32 planes of W, tile by tile and stage by stage:
//   ws[tile][stage][plane][n / 8][p / 4][n % 8][p % 4],  n < 2 Nf, p < kBK
// plane 0/1: B_r hi/lo, 2/3: B_i hi/lo; row n of B_r is Wr[f] for n < Nf and
// Wi[f] above, of B_i -Wi[f] and Wr[f], f = tile Nf + n % Nf; zero past
// n_fft and past n pulses.
__global__ void __launch_bounds__(256)
split_w_kernel(const float* __restrict__ w_re, const float* __restrict__ w_im,
               float* __restrict__ ws, int n_fft, int n) {
  const int kt = blockIdx.x, tile = blockIdx.y;  // one stage image per block
  float* dst = ws + (static_cast<size_t>(tile) * gridDim.x + kt) * kWStageFloats;
  for (int i = threadIdx.x; i < kWStageFloats; i += blockDim.x) {
    const int plane = i / kPlaneFloats;
    const int e = i % kPlaneFloats;
    const int nn = (e / (32 * (kBK / 4))) * 8 + (e / 4) % 8;
    const int p = kt * kBK + ((e / 32) % (kBK / 4)) * 4 + e % 4;
    const int f = tile * kNf + nn % kNf;
    float v = 0.f;
    if (f < n_fft && p < n) {
      const size_t at = static_cast<size_t>(f) * n + p;
      const bool im_half = nn >= kNf;
      v = plane < 2 ? (im_half ? w_im[at] : w_re[at]) : (im_half ? w_re[at] : -w_im[at]);
    }
    uint32_t hi, lo;
    split(v, hi, lo);
    dst[i] = __uint_as_float(plane & 1 ? lo : hi);
  }
}

// X's A fragment of one 8-pulse step, split into TF32 hi/lo.
struct FragX {
  uint32_t rh[4], rl[4], ih[4], il[4];
};

__device__ __forceinline__ void fence_frag(FragX& f) {
  fence_operands(f.rh);
  fence_operands(f.rl);
  fence_operands(f.ih);
  fence_operands(f.il);
}

__device__ __forceinline__ void flush96(float (&acc)[kN / 2], float (&part)[kN / 2]) {
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] += part[i];
}

__global__ void __launch_bounds__(kThreads, 1)
doppler_rdm_kernel(const float* __restrict__ ws, const float2* __restrict__ x,
                   float* __restrict__ out, int n_fft, int n, int nr, int notch_lo,
                   int notch_hi, int x_vec) {
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageFloats);
  const int f0 = blockIdx.x * kNf;
  const int r0 = blockIdx.y * kBM;
  const float2* xb = x + static_cast<size_t>(blockIdx.z) * n * nr;
  float* ob = out + static_cast<size_t>(blockIdx.z) * n_fft * nr;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // range rows [16 warp, 16 warp + 16) of the tile
  const int g = lane >> 2, t = lane & 3;
  const int n_k = (n + kBK - 1) / kBK;
  const float* wt = ws + static_cast<size_t>(blockIdx.x) * n_k * kWStageFloats;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Stage kt into ring slot `slot`: W's planes by one bulk copy, X by cp.async.
  auto load = [&](int kt, int slot) {
    float* st = smem + slot * kStageFloats;
    if (tid == 0) {
      mbar_arrive_expect_tx(&full[slot], kWStageBytes);
      bulk_g2s(st, wt + static_cast<size_t>(kt) * kWStageFloats, kWStageBytes, &full[slot]);
    }
    float2* sx = reinterpret_cast<float2*>(st + kWStageFloats);
    const int p0 = kt * kBK;
    if (x_vec) {  // 2 samples per copy
      constexpr int kChunks = kBK * kBM / 2;
#pragma unroll
      for (int i = 0; i < kChunks / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int kk = c / (kBM / 2);
        const int q = (c % (kBM / 2)) * 2;
        const int gp = p0 + kk, gc = r0 + q;
        const int bytes = (gp < n && gc < nr) ? 8 * min(2, nr - gc) : 0;
        const size_t off = bytes ? static_cast<size_t>(gp) * nr + gc : 0;
        cp_async16(sx + kk * kLdX + q, xb + off, bytes);
      }
    } else {
      constexpr int kElems = kBK * kBM;
#pragma unroll
      for (int i = 0; i < kElems / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int kk = c / kBM;
        const int q = c % kBM;
        const int gp = p0 + kk, gc = r0 + q;
        const int bytes = (gp < n && gc < nr) ? 8 : 0;
        const size_t off = bytes ? static_cast<size_t>(gp) * nr + gc : 0;
        cp_async8(sx + kk * kLdX + q, xb + off, bytes);
      }
    }
  };

  auto load_frag = [&](FragX& f, const float2* sx, int k8) {
    const float2* s = sx + (k8 + t) * kLdX + warp * 16 + g;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = s[4 * (e >> 1) * kLdX + 8 * (e & 1)];
      split(v.x, f.rh[e], f.rl[e]);
      split(v.y, f.ih[e], f.il[e]);
    }
  };

  float acc[kN / 2];
  float part[2][kN / 2];
  FragX fx[2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = part[0][i] = part[1][i] = 0.f;

  // The six products of one 8-pulse step into `p`; a true `first` starts the
  // partial (scale-d 0).
  auto mma_step = [&](float (&p)[kN / 2], FragX& f, const float* sw, int step, auto first) {
    constexpr int kAcc = decltype(first)::value ? 0 : 1;
    const float* b = sw + step * 2 * 32;  // two core matrices along K per step
    const uint64_t br_hi = gmma_desc(b, kLbo, kSbo);
    const uint64_t br_lo = gmma_desc(b + kPlaneFloats, kLbo, kSbo);
    const uint64_t bi_hi = gmma_desc(b + 2 * kPlaneFloats, kLbo, kSbo);
    const uint64_t bi_lo = gmma_desc(b + 3 * kPlaneFloats, kLbo, kSbo);
    fence_operands(p);
    fence_frag(f);
    wgmma_fence();
    wgmma_m64n96k8_tf32<kAcc>(p, f.rl, br_hi);
    wgmma_m64n96k8_tf32<1>(p, f.rh, br_lo);
    wgmma_m64n96k8_tf32<1>(p, f.il, bi_hi);
    wgmma_m64n96k8_tf32<1>(p, f.ih, bi_lo);
    wgmma_m64n96k8_tf32<1>(p, f.rh, br_hi);
    wgmma_m64n96k8_tf32<1>(p, f.ih, bi_hi);
    wgmma_commit();
    fence_operands(p);
    fence_frag(f);
  };

  // Stage kt, summed into partial P.  Its first step's wait completes stage
  // kt - 1, whose partial (the other one) is then flushed into acc; fragment
  // buffer fx[s] is rewritten only after the step that read it two steps back
  // has completed.
  auto stage = [&](auto par, int kt) {
    constexpr int P = decltype(par)::value;
    const int slot = kt % kStages;
    cp_async_wait<kStages - 3>();              // this thread's X copies of stage kt
    mbar_wait(&full[slot], (kt / kStages) & 1);  // the W planes of stage kt
    __syncthreads();  // everyone's X; slot kt - 2 is read by no thread and no wgmma
    if (kt + kStages - 2 < n_k) load(kt + kStages - 2, (kt + kStages - 2) % kStages);
    cp_async_commit();
    const float* sw = smem + slot * kStageFloats;
    const float2* sx = reinterpret_cast<const float2*>(sw + kWStageFloats);
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      load_frag(fx[s % 2], sx, 8 * s);
      if (s == 0)
        mma_step(part[P], fx[0], sw, 0, std::true_type{});
      else
        mma_step(part[P], fx[s % 2], sw, s, std::false_type{});
      wgmma_wait<1>();
      if (s == 0) flush96(acc, part[1 - P]);
    }
  };

  for (int s = 0; s < kStages - 2; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < n_k; kt += 2) {
    stage(std::integral_constant<int, 0>{}, kt);
    if (kt + 1 < n_k) stage(std::integral_constant<int, 1>{}, kt + 1);
  }
  wgmma_wait<0>();
  if (n_k & 1)
    flush96(acc, part[0]);
  else
    flush96(acc, part[1]);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the tile as [Doppler row][range]

  float* so = smem;
#pragma unroll
  for (int j = 0; j < kNf / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float re = acc[4 * j + e];
      const float im = acc[4 * (j + kNf / 8) + e];
      const int f = 8 * j + 2 * t + (e & 1);
      const int r = warp * 16 + g + 8 * (e >> 1);
      so[f * kLdO + r] = sqrtf(re * re + im * im);
    }
  }
  __syncthreads();
  for (int i = tid; i < kNf * kBM; i += kThreads) {
    const int f = i / kBM, c = i % kBM;
    const int row = f0 + f, col = r0 + c;
    if (row < n_fft && col < nr)
      ob[static_cast<size_t>(row) * nr + col] =
          (row >= notch_lo && row <= notch_hi) ? 0.f : so[f * kLdO + c];
  }
}

long long workspace_floats(int n_fft, int n) {
  return static_cast<long long>((n_fft + kNf - 1) / kNf) * ((n + kBK - 1) / kBK) * kWStageFloats;
}

int launch_split_w(const void* w_re, const void* w_im, void* ws, int n_fft, int n,
                   cudaStream_t stream) {
  const dim3 grid((n + kBK - 1) / kBK, (n_fft + kNf - 1) / kNf);
  split_w_kernel<<<grid, 256, 0, stream>>>(static_cast<const float*>(w_re),
                                           static_cast<const float*>(w_im),
                                           static_cast<float*>(ws), n_fft, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of one block of the main kernel (bytes).
extern "C" int rsp_doppler_rdm_smem_bytes() { return static_cast<int>(kSmemBytes); }

// The W planes alone, into `ws` of `ws_floats` floats (the wrapper's
// wgmma_b_planes; doppler_rdm_plain's layout twin is wgmma_b_planes_plain).
extern "C" int rsp_doppler_rdm_split_w(const void* w_re, const void* w_im, void* ws,
                                       long long ws_floats, int n_fft, int n, void* stream) {
  if (ws_floats != workspace_floats(n_fft, n)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_split_w(w_re, w_im, ws, n_fft, n, static_cast<cudaStream_t>(stream));
}

// Launches the W split and the main kernel on `stream`; returns the first
// cudaError_t (0 on success).  w_re/w_im (n_fft, n) float32 and x
// (batch, n, nr) complex64 contiguous; ws a 16-byte aligned float32 scratch
// of `ws_floats` (checked against the tiling: cudaErrorInvalidValue if it
// differs); out (batch, n_fft, nr) float32.  `x_vec` = 1 when nr is even and
// x is 16-byte aligned.
extern "C" int rsp_doppler_rdm(const void* w_re, const void* w_im, void* ws, long long ws_floats,
                               const void* x, void* out, int batch, int n_fft, int n, int nr,
                               int notch_lo, int notch_hi, int x_vec, void* stream) {
  if (ws_floats != workspace_floats(n_fft, n)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  int rc = launch_split_w(w_re, w_im, ws, n_fft, n, st);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      doppler_rdm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_fft + kNf - 1) / kNf, (nr + kBM - 1) / kBM, batch);
  doppler_rdm_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const float*>(ws), static_cast<const float2*>(x), static_cast<float*>(out),
      n_fft, n, nr, notch_lo, notch_hi, x_vec);
  return static_cast<int>(cudaGetLastError());
}
