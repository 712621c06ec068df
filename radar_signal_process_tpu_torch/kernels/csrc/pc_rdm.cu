// B3: fused pulse compression + windowed Doppler DFT + magnitude.
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
// What bounds it on an H100.  At G0 one frame is ~35 GFLOP of complex MAC
// work (long PC 6.3, long Doppler 25.8, short 3.2) against ~40 MB of
// compulsory traffic, so arithmetic bounds it: 0.214 ms as 3xTF32 at the
// tensor cores' 495 TFLOP/s (kernels/cost_model.py).  That rate is reached
// only through Hopper's warpgroup MMA (wgmma, sm90_async.cuh), whose TF32
// form reads a shared-memory operand only K-major.
//
// The design: two launches of one pipelined wgmma main loop, with P handed
// between them through L2, already in the form the second product reads.
//   * Both products in B2's real form (rdm.cu), with the complex operand A in
//     registers and the other operand B as a pre-split shared-memory image:
//       D (rows x [re | im] of kTJ columns) = Ar B + Ai B',
//       B = [Br; Bi],  B' = [-Bi; Br]   (rows: output columns, K-major)
//     so a thread holds a cell's re and im in the same slot of two n8 groups.
//     3xTF32: six wgmma.m64n96k8 per 8-deep step, the small terms first
//     (Ar_lo B_hi, Ar_hi B_lo, Ai_lo B'_hi, Ai_hi B'_lo, Ar_hi B_hi,
//     Ai_hi B'_hi; lo.lo dropped).  B and B' overlap in one image of three
//     sub-planes [-Bi; Br; Bi] per TF32 part (hi, lo): B' is its first two
//     thirds, B its last two, so the image holds 24 bytes a complex value.
//   * Phase 1, P = X M (K = fast-time samples): A = X, whose rows are pulses
//     (B3's batch folds into them, a block takes 128 pulses of one beam); B
//     is M's image ([-Mi; Mr; Mi] over output columns), prepared once per
//     operator by split_m_kernel and kept by the wrapper.  The epilogue
//     writes P, rounded to float32 and split, straight into the image that
//     phase 2 reads: [-Pi; Pr; Pi] over the columns c = b * n_out + j of all
//     beams.  P goes through L2 (37.7 MB at G0's long segment; the 12.6 MB of
//     P as complex64 is the least any hand-off could move).
//   * Phase 2, out = |W P| (K = pulses): A = W, B = P's image.  W is shared
//     by the beams, so their columns lie side by side along N: 2 x 62 = 124
//     columns make three 48-column tiles at the short segment.  W needs no
//     preparation: its raw re/im planes are staged and split in registers.
//   * Staging: a ring of 6 stages of 16-deep K, each completing on one
//     mbarrier, 4 stages in flight ahead of the one in use.  B's stage (18 KB)
//     is one TMA bulk copy of the image.  A's stage is a TMA tensor box:
//     X as a 3-D map (2 n_in floats x n_prt rows x batch, the segment's own
//     width, so columns past it read zero, not the next segment's samples;
//     128-byte swizzle), W as two 2-D maps (64-byte swizzle); the swizzles
//     make the threads' fragment loads free of bank conflicts.  Shapes TMA
//     cannot take (a view not on a 16-byte boundary, an odd stride, n_prt
//     not a multiple of 4) take the other path of the same kernel: every
//     thread copies its elements into the same swizzled places by cp.async,
//     zero-filling the edges, and arrives on the same mbarrier.
//   * The tensor core truncates as it accumulates, so the products sum into
//     a partial that starts afresh every two stages (32-deep K), and the
//     partial is added into FP32 totals, rounded to nearest, once its wgmmas
//     have completed; two partials alternate, so a flush overlaps the next
//     partial's products (B2's scheme, with partials of two stages: ptxas
//     waits for every wgmma of the warpgroup before the flush reads a
//     partial, and so drains the tensor pipe once a flush, not once a
//     stage).
//   * Block: two warpgroups (128 rows of A: pulses or Doppler rows) x 48
//     output columns, one block per SM.  Where that grid would not fill the
//     card (the short segment's phase 2: 16 x 3 blocks), phase 2 takes
//     blocks of one warpgroup (64 Doppler rows) and twice as many of them.
//     The magnitude is phase 2's epilogue, staged through shared memory so
//     each output row is stored by whole warps in consecutive addresses.
// Measured (tools/bench_b3.py, NVIDIA H100 80GB HBM3 at a 700 W power
// limit, device time of a CUDA graph of 20 calls): a G0 frame 0.392-0.397
// ms, 54% of the bound (short segment 0.069-0.070, long 0.319), where the
// earlier design (a cluster of 16 sharing P through distributed shared
// memory, mma.sync) took 0.998 and the two cuBLAS CGEMMs of the plain
// version 0.747-0.774.  M's image takes 3-5 us once an operator.  What
// holds it (--cuts, long segment): with the wgmmas cut it still takes 0.207
// ms, so the copies, the fragment splits and the stage barriers cost about
// what the tensor cores do and overlap them only in part; phase 2 alone
// 0.242-0.248 (352 blocks: 2.67 waves of 132), phase 1 alone 0.075-0.078;
// the P hand-off through L2 0.05, the W copies 0.02.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "cgemm_3xtf32.cuh"
#include "sm90_async.cuh"

namespace {

using namespace rsp;

constexpr int kBK = 16;                          // K per stage (= the flush period)
constexpr int kTJ = 48;                          // output columns a tile
constexpr int kN = 2 * kTJ;                      // wgmma N: re then im
constexpr int kAcc = kN / 2;                     // accumulator floats a thread
constexpr int kStages = 6;
constexpr int kSubFloats = kTJ * kBK;            // one sub-plane of an image stage
constexpr int kPartFloats = 3 * kSubFloats;      // [-Bi; Br; Bi] of one TF32 part
constexpr int kImageStageFloats = 2 * kPartFloats;
constexpr uint32_t kBStageBytes = sizeof(float) * kImageStageFloats;
constexpr uint32_t kLbo = 128;                   // next 4 K values: the next core matrix
constexpr uint32_t kSbo = 128 * (kBK / 4);       // next 8 rows: past a row group's K
constexpr uint32_t kARowBytes = 128;             // a row of A's stage: 16 float2, or 16 floats x 2 planes
constexpr int kLdO = kTJ + 4;                    // phase 2 epilogue pitch (floats)
constexpr int kXRows = 128;                      // phase 1: pulses a block

static_assert(kTJ % 8 == 0 && kN <= 256, "wgmma N");
static_assert(kBK == 16, "two 8-deep steps a stage; 128-byte X rows, 64-byte W rows");

template <int kWG>
struct Shape {
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kRows = 64 * kWG;                        // A rows a block
  static constexpr uint32_t kABytes = kARowBytes * kRows;       // A's stage
  static constexpr uint32_t kStageBytes = kABytes + kBStageBytes;
  static_assert(kStageBytes % 1024 == 0, "stages on the 1024-byte swizzle period");
  static constexpr size_t kSmem = size_t(kStages) * kStageBytes + kStages * sizeof(uint64_t) + 1024;
  static_assert(size_t(kRows) * kLdO * sizeof(float) <= size_t(kStages) * kStageBytes,
                "the epilogue tile fits the ring");
};

// The A operand's tensor maps: X (phase 1), or W's re and im planes (phase 2).
struct Maps {
  CUtensorMap a0;
  CUtensorMap a1;
};

struct Args {
  const float2* x;          // phase 1: echo (element (b, p, i) at b sb + p ldx + i)
  long long sb;
  int ldx;
  const float* w_re;        // phase 2: DFT planes (n_fft, n_prt)
  const float* w_im;
  const float* b_img;       // B's image: M's (phase 1) or P's (phase 2)
  float* p_img;             // phase 1 writes P's image
  float* out;               // phase 2 writes |W P| (batch, n_fft, n_out)
  int batch, n_prt, n_in, n_out, n_fft;
  int a_tma;                // A staged by TMA, else by cp.async
};

// Byte offsets in A's stage, as the TMA swizzle places a 16-byte chunk:
// rows of 128 bytes (128-byte swizzle: chunk ^= row % 8) and rows of 64
// bytes (64-byte swizzle: chunk ^= (row / 2) % 4), stages 1024-aligned.
__device__ __forceinline__ uint32_t sw128(uint32_t row, uint32_t chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}
__device__ __forceinline__ uint32_t sw64(uint32_t row, uint32_t chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// A's fragment of one 8-deep step, split into TF32 hi/lo (element e at row
// g + 8 (e & 1), K t + 4 (e >> 1) of the warp's 16 rows).
struct FragA {
  uint32_t rh[4], rl[4], ih[4], il[4];
};

__device__ __forceinline__ void set_frag(FragA& f, int e, float re, float im) {
  split(re, f.rh[e], f.rl[e]);
  split(im, f.ih[e], f.il[e]);
}

__device__ __forceinline__ void fence_frag(FragA& f) {
  fence_operands(f.rh);
  fence_operands(f.rl);
  fence_operands(f.ih);
  fence_operands(f.il);
}

__device__ __forceinline__ void flush(float (&acc)[kAcc], float (&part)[kAcc]) {
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
}

// The six products of one 8-deep step into `p` (a true kFirst starts the
// partial); `b` is the image stage: hi part [-Bi; Br; Bi], then lo.
template <bool kFirst>
__device__ __forceinline__ void mma_step(float (&p)[kAcc], FragA& f, const uint8_t* b, int step) {
  const uint8_t* s = b + step * 2 * 128;  // two core matrices along K a step
  constexpr uint32_t kSub = sizeof(float) * kSubFloats, kPart = sizeof(float) * kPartFloats;
  const uint64_t b_hi = gmma_desc(s + kSub, kLbo, kSbo);
  const uint64_t b_lo = gmma_desc(s + kPart + kSub, kLbo, kSbo);
  const uint64_t bn_hi = gmma_desc(s, kLbo, kSbo);
  const uint64_t bn_lo = gmma_desc(s + kPart, kLbo, kSbo);
  fence_operands(p);
  fence_frag(f);
  wgmma_fence();
  wgmma_m64n96k8_tf32<kFirst ? 0 : 1>(p, f.rl, b_hi);
  wgmma_m64n96k8_tf32<1>(p, f.rh, b_lo);
  wgmma_m64n96k8_tf32<1>(p, f.il, bn_hi);
  wgmma_m64n96k8_tf32<1>(p, f.ih, bn_lo);
  wgmma_m64n96k8_tf32<1>(p, f.rh, b_hi);
  wgmma_m64n96k8_tf32<1>(p, f.ih, bn_hi);
  wgmma_commit();
  fence_operands(p);
  fence_frag(f);
}

// The main loop both phases share: n_kt stages of 16-deep K through the
// ring, summed into acc (FP32 totals).  load_a(kt, stage) stages A (by TMA
// from thread 0, or by every thread's cp.async); a_tx is the bytes its TMA
// brings a stage; frag(f, stage, k8) loads this thread's A fragment.  B's
// stage kt is the image stage at b_img + kt * b_step floats.
template <int kWG, class LoadA, class Frag>
__device__ __forceinline__ void main_loop(uint8_t* smem, uint64_t* full, const float* b_img,
                                          size_t b_step, int n_kt, uint32_t a_tx, LoadA load_a,
                                          Frag frag, float (&acc)[kAcc]) {
  using S = Shape<kWG>;
  const int tid = threadIdx.x;

  auto load = [&](int kt, int slot) {
    uint8_t* st = smem + slot * S::kStageBytes;
    if (tid == 0) {
      mbar_arrive_expect_tx(&full[slot], kBStageBytes + a_tx);
      bulk_g2s(st + S::kABytes, b_img + kt * b_step, kBStageBytes, &full[slot]);
    }
    load_a(kt, st, &full[slot]);
  };

  float part[2][kAcc];
  FragA fa[2];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[0][i] = part[1][i] = 0.f;

  // Stage kt into partial P, which sums two stages (32-deep K).  The first
  // step's wait of a partial's first stage completes the stage before it,
  // whose partial (the other one) is then flushed into acc; fragment buffer
  // fa[s] is rewritten only after the step that read it has completed.
  auto stage = [&](auto par, auto first, int kt) {
    constexpr int P = decltype(par)::value;
    constexpr bool kFirst = decltype(first)::value;
    const int slot = kt % kStages;
    mbar_wait(&full[slot], (kt / kStages) & 1);
    __syncthreads();  // slot kt - 2 is read by no thread and no wgmma
    if (kt + kStages - 2 < n_kt) load(kt + kStages - 2, (kt + kStages - 2) % kStages);
    const uint8_t* st = smem + slot * S::kStageBytes;
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      frag(fa[s], st, 8 * s);
      if (s == 0 && kFirst)
        mma_step<true>(part[P], fa[0], st + S::kABytes, 0);
      else
        mma_step<false>(part[P], fa[s], st + S::kABytes, s);
      wgmma_wait<1>();
      if (s == 0 && kFirst) flush(acc, part[1 - P]);
    }
  };

  for (int s = 0; s < kStages - 2; ++s)
    if (s < n_kt) load(s, s);
  using Yes = std::true_type;
  using No = std::false_type;
  using P0 = std::integral_constant<int, 0>;
  using P1 = std::integral_constant<int, 1>;
#pragma unroll 1
  for (int kt = 0; kt < n_kt; kt += 4) {
    stage(P0{}, Yes{}, kt);
    if (kt + 1 < n_kt) stage(P0{}, No{}, kt + 1);
    if (kt + 2 < n_kt) stage(P1{}, Yes{}, kt + 2);
    if (kt + 3 < n_kt) stage(P1{}, No{}, kt + 3);
  }
  wgmma_wait<0>();
  if ((n_kt - 1) % 4 < 2)  // the last partial: part[0] if it began on a multiple of 4
    flush(acc, part[0]);
  else
    flush(acc, part[1]);
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// ------------------------------------------------------------ phase 1: X M
// Block (j tile, pulse tile, beam): P rows p0 + [0, 128) x columns j0 + [0, 48).
__global__ void __launch_bounds__(256, 1)
pc_kernel(const __grid_constant__ Maps maps, const Args a) {
  using S = Shape<2>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * S::kStageBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int jt = blockIdx.x, p0 = blockIdx.y * kXRows, b = blockIdx.z;
  const int n_kt = (a.n_in + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], a.a_tma ? 1 : 1 + S::kThreads);
    mbar_fence_init();
  }
  __syncthreads();

  const float2* xb = a.x + static_cast<size_t>(b) * a.sb;
  auto load_a = [&](int kt, uint8_t* st, uint64_t* bar) {
    if (a.a_tma) {
      if (tid == 0) tma_load_3d(st, &maps.a0, 2 * kBK * kt, p0, b, bar);
    } else {  // 8 bytes a sample, the edges zero-filled
#pragma unroll 1
      for (int i = 0; i < kXRows * kBK / S::kThreads; ++i) {
        const int e = tid + i * S::kThreads;
        const int r = e / kBK, k = e % kBK;
        const int p = p0 + r, s = kt * kBK + k;
        const bool ok = p < a.n_prt && s < a.n_in;
        cp_async8(st + sw128(r, k >> 1) + (k & 1) * 8,
                  ok ? xb + static_cast<size_t>(p) * a.ldx + s : a.x, ok ? 8 : 0);
      }
      cp_async_mbar_arrive_noinc(bar);
    }
  };
  auto frag = [&](FragA& f, const uint8_t* st, int k8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + g + 8 * (e & 1), k = k8 + t + 4 * (e >> 1);
      const float2 v = *reinterpret_cast<const float2*>(st + sw128(r, k >> 1) + (k & 1) * 8);
      set_frag(f, e, v.x, v.y);
    }
  };

  float acc[kAcc];
  main_loop<2>(smem, full, a.b_img + static_cast<size_t>(jt) * n_kt * kImageStageFloats,
               kImageStageFloats, n_kt, a.a_tma ? S::kABytes : 0, load_a, frag, acc);

  // P, rounded to float32, split into P's image: stage (c / 48, p / 16),
  // parts hi/lo of [-Pi; Pr; Pi], row c % 48, K p % 16.  Pulses past n_prt
  // up to the stage are zero (X's rows there read zero).
  const int n_kt2 = (a.n_prt + kBK - 1) / kBK;
#pragma unroll
  for (int j = 0; j < kTJ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + warp * 16 + g + 8 * (e >> 1);
      const int jo = jt * kTJ + 8 * j + 2 * t + (e & 1);
      if (p >= n_kt2 * kBK || jo >= a.n_out) continue;
      const float re = acc[4 * j + e], im = acc[4 * (j + kTJ / 8) + e];
      const int c = b * a.n_out + jo, cr = c % kTJ;
      float* dst = a.p_img + (static_cast<size_t>(c / kTJ) * n_kt2 + p / kBK) * kImageStageFloats +
                   (cr >> 3) * 128 + ((p & 15) >> 2) * 32 + (cr & 7) * 4 + (p & 3);
      uint32_t hi, lo;
      split(-im, hi, lo);
      dst[0] = __uint_as_float(hi);
      dst[kPartFloats] = __uint_as_float(lo);
      split(re, hi, lo);
      dst[kSubFloats] = __uint_as_float(hi);
      dst[kPartFloats + kSubFloats] = __uint_as_float(lo);
      split(im, hi, lo);
      dst[2 * kSubFloats] = __uint_as_float(hi);
      dst[kPartFloats + 2 * kSubFloats] = __uint_as_float(lo);
    }
}

// ------------------------------------------------------- phase 2: |W P|
// Block (Doppler tile, column tile): rows d0 + [0, 64 kWG) x columns c0 + [0, 48).
template <int kWG>
__global__ void __launch_bounds__(128 * kWG, 1)
rdm_kernel(const __grid_constant__ Maps maps, const Args a) {
  using S = Shape<kWG>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * S::kStageBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = blockIdx.x * S::kRows, c0 = blockIdx.y * kTJ;
  const int n_kt = (a.n_prt + kBK - 1) / kBK;
  constexpr uint32_t kPlane = 64 * S::kRows;  // W's im plane after its re plane

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], a.a_tma ? 1 : 1 + S::kThreads);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_a = [&](int kt, uint8_t* st, uint64_t* bar) {
    if (a.a_tma) {
      if (tid == 0) {
        tma_load_2d(st, &maps.a0, kBK * kt, d0, bar);
        tma_load_2d(st + kPlane, &maps.a1, kBK * kt, d0, bar);
      }
    } else {  // 4 bytes a value, the edges zero-filled
#pragma unroll 1
      for (int i = 0; i < 2 * S::kRows * kBK / S::kThreads; ++i) {
        const int e = tid + i * S::kThreads;
        const int plane = e / (S::kRows * kBK), r = (e / kBK) % S::kRows, k = e % kBK;
        const int d = d0 + r, p = kt * kBK + k;
        const bool ok = d < a.n_fft && p < a.n_prt;
        const float* w = plane ? a.w_im : a.w_re;
        cp_async4(st + plane * kPlane + sw64(r, k >> 2) + (k & 3) * 4,
                  ok ? w + static_cast<size_t>(d) * a.n_prt + p : w, ok ? 4 : 0);
      }
      cp_async_mbar_arrive_noinc(bar);
    }
  };
  auto frag = [&](FragA& f, const uint8_t* st, int k8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + g + 8 * (e & 1);
      const uint32_t off = sw64(r, (k8 >> 2) + (e >> 1)) + t * 4;
      set_frag(f, e, *reinterpret_cast<const float*>(st + off),
               *reinterpret_cast<const float*>(st + kPlane + off));
    }
  };

  float acc[kAcc];
  main_loop<kWG>(smem, full, a.b_img + static_cast<size_t>(blockIdx.y) * n_kt * kImageStageFloats,
                 kImageStageFloats, n_kt, a.a_tma ? 2 * kPlane : 0, load_a, frag, acc);
  __syncthreads();  // every stage has landed and been read: the ring is free

  float* so = reinterpret_cast<float*>(smem);  // [Doppler row][column]
#pragma unroll
  for (int j = 0; j < kTJ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float re = acc[4 * j + e], im = acc[4 * (j + kTJ / 8) + e];
      so[(warp * 16 + g + 8 * (e >> 1)) * kLdO + 8 * j + 2 * t + (e & 1)] =
          sqrtf(re * re + im * im);
    }
  __syncthreads();
  const int n_cols = a.batch * a.n_out;
  for (int i = tid; i < S::kRows * kTJ; i += S::kThreads) {
    const int r = i / kTJ, cc = i % kTJ;
    const int d = d0 + r, c = c0 + cc;
    if (d < a.n_fft && c < n_cols) {
      const int b = c / a.n_out, j = c - b * a.n_out;
      a.out[(static_cast<size_t>(b) * a.n_fft + d) * a.n_out + j] = so[r * kLdO + cc];
    }
  }
}

// ------------------------------------------------- M's image, once an operator
// img[jt][kt][part][sub][n / 8][k / 4][n % 8][k % 4]: parts hi/lo, sub-planes
// -Mi, Mr, Mi at output column j = 48 jt + n and sample i = 16 kt + k; zero
// past n_in and n_out.
__global__ void __launch_bounds__(256)
split_m_kernel(const float* __restrict__ m_re, const float* __restrict__ m_im,
               float* __restrict__ img, int n_in, int n_out) {
  const int kt = blockIdx.x, jt = blockIdx.y;
  float* dst = img + (static_cast<size_t>(jt) * gridDim.x + kt) * kImageStageFloats;
  for (int i = threadIdx.x; i < kPartFloats; i += blockDim.x) {
    const int sub = i / kSubFloats, e = i % kSubFloats;
    const int n = (e / 128) * 8 + (e / 4) % 8, k = ((e / 32) % 4) * 4 + e % 4;
    const int j = jt * kTJ + n, s = kt * kBK + k;
    float v = 0.f;
    if (j < n_out && s < n_in) {
      const size_t at = static_cast<size_t>(s) * n_out + j;
      v = sub == 1 ? m_re[at] : (sub == 0 ? -m_im[at] : m_im[at]);
    }
    uint32_t hi, lo;
    split(v, hi, lo);
    dst[i] = __uint_as_float(hi);
    dst[kPartFloats + i] = __uint_as_float(lo);
  }
}

long long image_floats(int n_rows, int n_k) {
  return static_cast<long long>((n_rows + kTJ - 1) / kTJ) * ((n_k + kBK - 1) / kBK) *
         kImageStageFloats;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;  // once a build (a benign race between threads)
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

cudaError_t encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int kWG>
cudaError_t launch_rdm(const Args& args, int w_tma, cudaStream_t st) {
  using S = Shape<kWG>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(rdm_kernel<kWG>, S::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  Maps maps{};
  if (w_tma) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(args.n_prt),
                                static_cast<cuuint64_t>(args.n_fft)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(args.n_prt) * 4};
    const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(S::kRows)};
    err = encode(&maps.a0, args.w_re, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
    if (err == cudaSuccess)
      err = encode(&maps.a1, args.w_im, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
    if (err != cudaSuccess) return err;
  }
  Args a = args;
  a.a_tma = w_tma;
  const dim3 grid((args.n_fft + S::kRows - 1) / S::kRows,
                  (args.batch * args.n_out + kTJ - 1) / kTJ);
  rdm_kernel<kWG><<<grid, S::kThreads, S::kSmem, st>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one block of either phase (bytes).
extern "C" int rsp_fused_pc_rdm_smem_bytes() { return static_cast<int>(Shape<2>::kSmem); }

// M's image into `img` of `img_floats` floats (the wrapper's
// pc_operator_image; its plain twin is pc_operator_image_plain).
extern "C" int rsp_fused_pc_rdm_split_m(const void* m_re, const void* m_im, void* img,
                                        long long img_floats, int n_in, int n_out,
                                        void* stream) {
  if (img_floats != image_floats(n_out, n_in)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_in + kBK - 1) / kBK, (n_out + kTJ - 1) / kTJ);
  split_m_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m_re), static_cast<const float*>(m_im), static_cast<float*>(img),
      n_in, n_out);
  return static_cast<int>(cudaGetLastError());
}

// Launches both phases on `stream`; returns the first cudaError_t (0 on
// success).  x: complex64 with unit fast-time stride, row stride `ldx`,
// batch stride `sb` (complex elements); m_img M's image (m_floats, checked);
// w_re/w_im (n_fft, n_prt) contiguous float32; p_img a scratch of p_floats
// for P's image; out (batch, n_fft, n_out) float32.  `x_tma` = 1 when x is
// 16-byte aligned and ldx and sb are even (sb >= n_prt ldx); `w_tma` = 1 when
// n_prt % 4 == 0 and the W planes are 16-byte aligned.  `n_sms` is the
// card's SM count.
extern "C" int rsp_fused_pc_rdm(const void* x, long long sb, int ldx, const void* m_img,
                                long long m_floats, const void* w_re, const void* w_im,
                                void* p_img, long long p_floats, void* out, int batch, int n_prt,
                                int n_in, int n_out, int n_fft, int n_sms, int x_tma, int w_tma,
                                void* stream) {
  if (m_floats != image_floats(n_out, n_in) || p_floats != image_floats(batch * n_out, n_prt))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.x = static_cast<const float2*>(x);
  a.sb = sb;
  a.ldx = ldx;
  a.w_re = static_cast<const float*>(w_re);
  a.w_im = static_cast<const float*>(w_im);
  a.p_img = static_cast<float*>(p_img);
  a.out = static_cast<float*>(out);
  a.batch = batch;
  a.n_prt = n_prt;
  a.n_in = n_in;
  a.n_out = n_out;
  a.n_fft = n_fft;

  // phase 1
  static bool pc_smem_set = false;
  cudaError_t err = allow_smem(pc_kernel, Shape<2>::kSmem, pc_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps maps{};
  if (x_tma) {
    const cuuint64_t dims[3] = {2 * static_cast<cuuint64_t>(n_in),
                                static_cast<cuuint64_t>(n_prt), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ldx) * 8,
                                   static_cast<cuuint64_t>(sb) * 8};
    const cuuint32_t box[3] = {2 * kBK, kXRows, 1};
    err = encode(&maps.a0, x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a.b_img = static_cast<const float*>(m_img);
  a.a_tma = x_tma;
  const dim3 grid1((n_out + kTJ - 1) / kTJ, (n_prt + kXRows - 1) / kXRows, batch);
  pc_kernel<<<grid1, Shape<2>::kThreads, Shape<2>::kSmem, st>>>(maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // phase 2: blocks of two warpgroups where they fill the card, else of one
  a.b_img = static_cast<const float*>(p_img);
  const long long blocks2 = static_cast<long long>((n_fft + 127) / 128) *
                            ((static_cast<long long>(batch) * n_out + kTJ - 1) / kTJ);
  return static_cast<int>(blocks2 >= n_sms ? launch_rdm<2>(a, w_tma, st)
                                           : launch_rdm<1>(a, w_tma, st));
}
