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
// the host in float64.  P never reaches device memory.
//
// What bounds it on an H100.  At G0 one frame is ~35 GFLOP of complex MAC
// work (long PC 6.3, long Doppler 25.8, short 3.2) against ~40 MB of
// compulsory traffic, so arithmetic bounds it.  Both products run on the
// tensor cores at FP32 accuracy through the 3xTF32 split of cgemm_3xtf32.cuh:
// 12 mma.sync per complex 16 x 8 x 8 step, which the card issues at best one
// per ~6.7 cycles per SM sub-partition.  Two things keep a kernel from that
// rate: where P lives (a P column at n_prt = 1536 is 12 KiB, so a range tile
// of P fills an SM's shared memory and leaves too few warps), and the
// instructions issued beside the mma's (operand splits, ring addressing).
// The design:
//   * P shared across a thread-block cluster of 16.  A cluster owns one range
//     tile of TJ columns of one beam.  Block `rank` forms the P rows
//     [rank * rows_per, (rank + 1) * rows_per) of the tile (phase 1) and keeps
//     them in its own shared memory.  After cluster.sync() each block
//     contracts its Doppler passes (128 rows each: rank, rank + 16, ...)
//     against the whole of P (phase 2), reading the peers' slices through
//     distributed shared memory.  A second cluster barrier keeps every block
//     alive until no peer reads its P.  No P row is formed twice, and P costs
//     each block 1/16 of the tile: 24 KiB at TJ = 32, so two blocks (16
//     warps) share an SM.  A cluster of 16 needs the non-portable size.
//   * Two tile widths, picked by the launcher: TJ = 32 (the long segment:
//     2 beams x 16 tiles x 16 = 512 blocks) and TJ = 16 where 32-column
//     tiles would leave SMs idle (the short segment: 2 x 4 x 16 = 128).
//   * One pipelined main loop serves both phases: 8 warps, each owning 16
//     rows of A, 16-deep K stages in a 3-stage ring.  A (X in phase 1, W in
//     phase 2) comes by cp.async, 16-byte copies where the addresses and
//     strides allow (the G0 segments do: row stride 566, column offset 62),
//     else 8 bytes per X sample or 4 per W value.  B (M in phase 1, the peer's
//     P in phase 2) is fetched into registers a stage ahead, split into TF32
//     hi/lo once and stored beside A, so the 8 warps that read it load ready
//     fragments.  Loader positions advance as counters: no division or
//     modulo by a runtime value runs per stage.  The mma's of a step go out
//     term by term across the warp's tiles (cmma_n), and partial sums are
//     flushed once per 16-deep stage.  The magnitude is the epilogue.
//   * Ragged edges (62 and 504 are no tile multiples) read zero through the
//     copies' source size and the B fetch's bounds; P rows past n_prt are
//     zero and W columns past n_prt read zero.  Stage pitches are padded so
//     fragment loads are free of bank conflicts.
// What bounds it now (an H100 at 700 W): the long segment runs at ~38
// FP32-equivalent TFLOP/s.  The card places at most 14 clusters of 16 at a
// time (112 of 132 SMs), so its 32 clusters take three waves for 2.3 waves
// of work; inside a wave the mma's issue at ~12 cycles each, behind the W
// operand's split (each W value is split once per block) and the flush adds.
// Smaller clusters place better but hold a larger P slice each: clusters of
// 4 with one block per SM fit 30 at a time, so the short segment's 32 took
// two waves and ran slower than clusters of 16.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "cgemm_3xtf32.cuh"

namespace {

using namespace rsp;
namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kWarps * 16;   // A rows per pass: P rows (phase 1), Doppler rows (phase 2)
constexpr int kBK = 16;              // K per stage: samples (phase 1), pulses (phase 2)
constexpr int kStages = 3;
constexpr int kCluster = 16;
constexpr int kLdA = kBK + 4;        // A stage pitch: float2 of X, or floats of each W plane
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a block may use

static_assert(kLdA % 32 == 20, "conflict-free A fragments");

template <int TJ>
struct Tile {
  static constexpr int kNT = TJ / 8;                 // n8 tiles per warp
  static constexpr int kLdB = TJ + 2;                // split B plane pitch (uint4)
  static constexpr int kAFloats = 2 * kRows * kLdA;  // X [kRows][kLdA] float2 | W re, im planes
  // B: per 8-deep K-step, hi and lo planes [4][kLdB] uint4 (put_b_quads)
  static constexpr int kStageFloats = kAFloats + (kBK / 8) * 2 * 4 * kLdB * 4;
  static constexpr int kItems = kBK / 2 * TJ;        // B (row pair, column) items per stage
  static_assert(TJ % 8 == 0 && kItems <= kThreads, "tile width");
  static_assert(kLdB % 8 == 2 && kStageFloats % 4 == 0, "conflict-free, 16-byte aligned B");

  // the ring, then this block's P slice [rows_per][TJ] float2
  static size_t smem_bytes(int rows_per) {
    return sizeof(float) * (static_cast<size_t>(kStages) * kStageFloats +
                            static_cast<size_t>(rows_per) * TJ * 2);
  }
};

// One block's passes of a complex GEMM through the ring: `n_pass` passes of
// `n_k` K-stages; warp w owns A rows [16 w, 16 w + 16) of a pass and all TJ
// columns.  load_a(pass, k, slot) issues the cp.async copies of a stage;
// fetch_b(k) loads this thread's B item of a stage into registers,
// put_b(slot) splits and stores it; frag_a(a, stage, k8) loads this warp's
// A fragment; busy(pass) says whether this warp has rows in the pass
// (warp-uniform); done(pass, re, im) is the epilogue of a pass.
template <int TJ, class LoadA, class FetchB, class PutB, class FragAFn, class Busy, class Done>
__device__ __forceinline__ void run_passes(float* smem, int n_pass, int n_k, LoadA load_a,
                                           FetchB fetch_b, PutB put_b, FragAFn frag_a,
                                           Busy busy, Done done) {
  using T = Tile<TJ>;
  constexpr int kNT = T::kNT;
  const int lane = threadIdx.x & 31;
  const int total = n_pass * n_k;

  int la_pass = 0, la_k = 0, la_slot = 0;  // the next stage to load
  auto load_next = [&]() {
    load_a(la_pass, la_k, la_slot);
    if (++la_k == n_k) la_k = 0, ++la_pass;
    if (++la_slot == kStages) la_slot = 0;
  };
  int fb_k = 0;                            // the next B stage to fetch
  auto fetch_next = [&]() {
    fetch_b(fb_k);
    if (++fb_k == n_k) fb_k = 0;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_next();
    cp_async_commit();
  }
  if (total > 0) {
    fetch_next();
    put_b(0);
  }
  if (total > 1) fetch_next();

  float acc_re[kNT][4], acc_im[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_re[j][e] = acc_im[j][e] = 0.f;

  int pass = 0, k = 0, slot = 0;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();               // stage s is in its slot; slot s - 1 is free
    if (s + kStages - 1 < total) load_next();
    cp_async_commit();
    const int slot1 = slot + 1 == kStages ? 0 : slot + 1;
    if (s + 1 < total) put_b(slot1);  // read at s + 1, after its barrier
    if (s + 2 < total) fetch_next();  // in flight while stage s computes

    if (busy(pass)) {
      const float* stage = smem + slot * T::kStageFloats;
      const uint4* s_b = reinterpret_cast<const uint4*>(stage + T::kAFloats);
      float pr[kNT][4], pi[kNT][4];  // partial sums of the stage
#pragma unroll
      for (int k8 = 0; k8 < kBK; k8 += 8) {
        FragB bf[kNT];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          load_b_quads(bf[j], s_b + k8 * T::kLdB + j * 8, T::kLdB, lane);
        FragA a;
        frag_a(a, stage, k8);
        if (k8 == 0) cmma_n<true>(pr, pi, a, bf);
        else cmma_n<false>(pr, pi, a, bf);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) flush(acc_re[j], acc_im[j], pr[j], pi[j]);
    }
    if (++k == n_k) {              // the pass is complete
      done(pass, acc_re, acc_im);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_re[j][e] = acc_im[j][e] = 0.f;
      k = 0;
      ++pass;
    }
    slot = slot1;
  }
  cp_async_wait<0>();
}

template <int TJ>
__global__ void __launch_bounds__(kThreads, 2)
fused_pc_rdm_kernel(const float2* __restrict__ x, long long sb, int ldx,
                    const float* __restrict__ m_re, const float* __restrict__ m_im,
                    const float* __restrict__ w_re, const float* __restrict__ w_im,
                    float* __restrict__ out, int n_prt, int n_in, int n_out, int n_fft,
                    int rows_per, int x_vec, int w_vec) {
  using T = Tile<TJ>;
  constexpr int kNT = T::kNT;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  float2* s_p = reinterpret_cast<float2*>(smem + kStages * T::kStageFloats);  // [rows_per][TJ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int j0 = (blockIdx.x / kCluster) * TJ;
  const int b = blockIdx.y;
  const int n_prt_pad = round_up(n_prt, kBK);
  const int p_lo = rank * rows_per;                       // this block's P rows
  const int n_rows = min(rows_per, n_prt_pad - p_lo);     // may be <= 0

  // B: this thread's item of a stage, the values at rows b_k and b_k + 4 of
  // column b_n, split and stored as one hi and one lo quad (put_b_quads)
  const int b_n = tid % TJ;
  const int b_q = tid / TJ;                                // 8-deep step * 4 + row t
  const int b_k = (b_q >> 2) * 8 + (b_q & 3);
  const bool b_on = tid < T::kItems;
  float2 b_reg0 = make_float2(0.f, 0.f), b_reg1 = make_float2(0.f, 0.f);
  auto put_b = [&](int slot) {
    uint4* dst = reinterpret_cast<uint4*>(smem + slot * T::kStageFloats + T::kAFloats) +
                 (b_q >> 2) * 8 * T::kLdB + (b_q & 3) * T::kLdB + b_n;
    if (b_on) put_b_quads(dst, dst + 4 * T::kLdB, b_reg0, b_reg1);
  };

  // ------------------------------------------------ phase 1: P slice = X M_j
  {
    const int p_end = min(p_lo + n_rows, n_prt);          // rows read from X
    const float2* xb = x + static_cast<size_t>(b) * sb;
    auto load_a = [&](int pass, int k, int slot) {
      float2* s_x = reinterpret_cast<float2*>(smem + slot * T::kStageFloats);
      const int r0 = p_lo + pass * kRows;
      const int i0 = k * kBK;
      if (x_vec) {  // 2 samples per copy
        const int r = tid >> 3, q = (tid & 7) * 2;
        const int gi = i0 + q;
        const int cols = gi < n_in ? 8 * min(2, n_in - gi) : 0;
#pragma unroll
        for (int e = 0; e < kRows / 32; ++e) {
          const int gp = r0 + r + 32 * e;
          const int bytes = gp < p_end ? cols : 0;
          const float2* src = bytes ? xb + static_cast<size_t>(gp) * ldx + gi : xb;
          cp_async16(s_x + (r + 32 * e) * kLdA + q, src, bytes);
        }
      } else {
        const int r = tid >> 4, q = tid & 15;
        const int gi = i0 + q;
#pragma unroll
        for (int e = 0; e < kRows / 16; ++e) {
          const int gp = r0 + r + 16 * e;
          const int bytes = (gp < p_end && gi < n_in) ? 8 : 0;
          const float2* src = bytes ? xb + static_cast<size_t>(gp) * ldx + gi : xb;
          cp_async8(s_x + (r + 16 * e) * kLdA + q, src, bytes);
        }
      }
    };
    auto fetch_b = [&](int k) {  // M rows [16 k, 16 k + 16), columns j0 + [0, TJ)
      const int gi = k * kBK + b_k, gj = j0 + b_n;
      b_reg0 = b_reg1 = make_float2(0.f, 0.f);
      if (b_on && gj < n_out) {
        const size_t off = static_cast<size_t>(gi) * n_out + gj;
        if (gi < n_in) b_reg0 = make_float2(__ldg(m_re + off), __ldg(m_im + off));
        if (gi + 4 < n_in) {
          const size_t off4 = off + 4 * static_cast<size_t>(n_out);
          b_reg1 = make_float2(__ldg(m_re + off4), __ldg(m_im + off4));
        }
      }
    };
    auto frag_a = [&](FragA& a, const float* stage, int k8) {
      load_a_cplx(a, reinterpret_cast<const float2*>(stage) + warp * 16 * kLdA + k8, kLdA, lane);
    };
    auto busy = [&](int pass) { return pass * kRows + warp * 16 < n_rows; };
    auto done = [&](int pass, float (&re)[kNT][4], float (&im)[kNT][4]) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = pass * kRows + warp * 16 + acc_row(lane, e);
          if (r < n_rows) s_p[r * TJ + j * 8 + acc_col(lane, e)] = make_float2(re[j][e], im[j][e]);
        }
    };
    const int n_pass = n_rows > 0 ? (n_rows + kRows - 1) / kRows : 0;
    run_passes<TJ>(smem, n_pass, (n_in + kBK - 1) / kBK, load_a, fetch_b, put_b, frag_a, busy,
                   done);
  }

  cluster.sync();  // every slice of P is formed and visible to the cluster

  // ------------------------------------- phase 2: |W P| over this block's passes
  {
    const int n_k = n_prt_pad / kBK;
    const int n_all = (n_fft + kRows - 1) / kRows;         // Doppler passes of the tile
    const int n_pass = rank < n_all ? (n_all - 1 - rank) / kCluster + 1 : 0;
    float* ob = out + static_cast<size_t>(b) * n_fft * n_out;
    auto load_a = [&](int pass, int k, int slot) {
      float* s_wr = smem + slot * T::kStageFloats;
      float* s_wi = s_wr + kRows * kLdA;
      const int k0 = (rank + pass * kCluster) * kRows;
      const int p0 = k * kBK;
      if (w_vec) {  // 4 pulses per copy
        const int m = tid >> 2, q = (tid & 3) * 4;
        const int gp = p0 + q;
        const int cols = gp < n_prt ? 4 * min(4, n_prt - gp) : 0;
#pragma unroll
        for (int e = 0; e < kRows / 64; ++e) {
          const int gk = k0 + m + 64 * e;
          const int bytes = gk < n_fft ? cols : 0;
          const size_t off = bytes ? static_cast<size_t>(gk) * n_prt + gp : 0;
          cp_async16(s_wr + (m + 64 * e) * kLdA + q, w_re + off, bytes);
          cp_async16(s_wi + (m + 64 * e) * kLdA + q, w_im + off, bytes);
        }
      } else {
        const int m = tid >> 4, q = tid & 15;
        const int gp = p0 + q;
#pragma unroll
        for (int e = 0; e < kRows / 16; ++e) {
          const int gk = k0 + m + 16 * e;
          const int bytes = (gk < n_fft && gp < n_prt) ? 4 : 0;
          const size_t off = bytes ? static_cast<size_t>(gk) * n_prt + gp : 0;
          cp_async4(s_wr + (m + 16 * e) * kLdA + q, w_re + off, bytes);
          cp_async4(s_wi + (m + 16 * e) * kLdA + q, w_im + off, bytes);
        }
      }
    };
    // P stage k: 16 rows of the owning block's slice, through distributed
    // shared memory.  Stages advance by 16 rows and slices hold a multiple
    // of 16, so a stage never straddles two owners.
    int owner = 0, row = 0;
    auto fetch_b = [&](int k) {
      if (k == 0) owner = 0, row = 0;
      const float2* src = cluster.map_shared_rank(s_p, owner) + (row + b_k) * TJ + b_n;
      if (b_on) {
        b_reg0 = src[0];
        b_reg1 = src[4 * TJ];
      }
      row += kBK;
      if (row == rows_per) row = 0, ++owner;
    };
    auto frag_a = [&](FragA& a, const float* stage, int k8) {
      const float* s_wr = stage + warp * 16 * kLdA + k8;
      load_a_planes(a, s_wr, s_wr + kRows * kLdA, kLdA, lane);
    };
    auto busy = [&](int pass) { return (rank + pass * kCluster) * kRows + warp * 16 < n_fft; };
    auto done = [&](int pass, float (&re)[kNT][4], float (&im)[kNT][4]) {
      const int k0 = (rank + pass * kCluster) * kRows + warp * 16;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = k0 + acc_row(lane, e);
          const int c = j0 + j * 8 + acc_col(lane, e);
          if (r < n_fft && c < n_out)
            ob[static_cast<size_t>(r) * n_out + c] =
                sqrtf(re[j][e] * re[j][e] + im[j][e] * im[j][e]);
        }
    };
    run_passes<TJ>(smem, n_pass, n_k, load_a, fetch_b, put_b, frag_a, busy, done);
  }

  cluster.sync();  // no block leaves while a peer may still read its P slice
}

// The launch shape: tile width, P rows per block and shared memory per block.
struct Shape {
  int tj, rows_per;
  size_t smem;
};

Shape pick_shape(int n_prt, int n_out, int batch, int n_sms) {
  const int rows_per = round_up((round_up(n_prt, kBK) + kCluster - 1) / kCluster, kBK);
  // 32-column tiles where they give two blocks per SM and fit, else 16
  const long long wide_blocks = static_cast<long long>((n_out + 31) / 32) * batch * kCluster;
  const size_t wide = Tile<32>::smem_bytes(rows_per);
  if (wide_blocks >= 2LL * n_sms && wide <= kMaxSmem) return Shape{32, rows_per, wide};
  return Shape{16, rows_per, Tile<16>::smem_bytes(rows_per)};
}

template <int TJ>
int launch(const Shape& shape, const float2* x, long long sb, int ldx, const float* m_re,
           const float* m_im, const float* w_re, const float* w_im, float* out, int batch,
           int n_prt, int n_in, int n_out, int n_fft, int x_vec, int w_vec, cudaStream_t stream) {
  auto kernel = fused_pc_rdm_kernel<TJ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shape.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n_out + TJ - 1) / TJ) * kCluster, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = shape.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, sb, ldx, m_re, m_im, w_re, w_im, out, n_prt, n_in,
                           n_out, n_fft, shape.rows_per, x_vec, w_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one block of the launch shape takes for these
// dimensions (the wrapper rejects what exceeds a block's 227 KB).
extern "C" int rsp_fused_pc_rdm_smem_bytes(int n_prt, int n_out, int batch, int n_sms) {
  return static_cast<int>(pick_shape(n_prt, n_out, batch, n_sms).smem);
}

// Launches on `stream`; returns the first cudaError_t (0 on success).
// x: complex64 with unit fast-time stride, row stride `ldx`, batch stride `sb`
// (complex elements); m_re/m_im (n_in, n_out), w_re/w_im (n_fft, n_prt)
// contiguous float32; out (batch, n_fft, n_out) float32.  `n_sms` is the
// card's SM count.  `x_vec` = 1 when x is 16-byte aligned and ldx and sb are
// even; `w_vec` = 1 when n_prt % 4 == 0 and the W planes are 16-byte aligned.
extern "C" int rsp_fused_pc_rdm(const void* x, long long sb, int ldx, const void* m_re,
                                const void* m_im, const void* w_re, const void* w_im,
                                void* out, int batch, int n_prt, int n_in, int n_out,
                                int n_fft, int n_sms, int x_vec, int w_vec, void* stream) {
  const Shape shape = pick_shape(n_prt, n_out, batch, n_sms);
  const auto* xp = static_cast<const float2*>(x);
  const auto* mr = static_cast<const float*>(m_re);
  const auto* mi = static_cast<const float*>(m_im);
  const auto* wr = static_cast<const float*>(w_re);
  const auto* wi = static_cast<const float*>(w_im);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (shape.tj == 32)
    return launch<32>(shape, xp, sb, ldx, mr, mi, wr, wi, o, batch, n_prt, n_in, n_out, n_fft,
                      x_vec, w_vec, st);
  return launch<16>(shape, xp, sb, ldx, mr, mi, wr, wi, o, batch, n_prt, n_in, n_out, n_fft,
                    x_vec, w_vec, st);
}
