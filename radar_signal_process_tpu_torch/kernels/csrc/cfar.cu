// B1: cascaded velocity-then-range CA-CFAR over every pulse segment of an
// RDM stack, in one launch, with the CFAR stage's re-notch fused into its
// load.
//
// Replaces radar_signal_process_tpu/kernels/cfar_pallas.py:136
// (cascaded_cfar2d_pallas) and is bit-identical to ops/cfar.py::
// segmented_cfar on rdm * keep[:, None], keep zero on the rows
// [zero_lo, zero_hi) (the lockstep contract of the five CFAR
// implementations):
//
//  * one window sum per position, acc[k] = d[k] + d[k-1] + ... + d[k-r+1]
//    added one term at a time in that order (the roll form), with indices
//    wrapped inside the cropped rows (velocity) or inside the segment
//    (range), as torch.roll / jnp.roll wrap; left = acc[y-g-1] / r and
//    right = acc[y+g+r] / r, so the left mean of cell y is the right mean of
//    cell y-2g-r-1 and each is formed once;
//  * means are sum / float(r) in IEEE division (__fdiv_rn), not the Pallas
//    kernel's sum * (1/r) (ROADMAP C1);
//  * flag = d >= level * T with the f32 product (__fmul_rn);
//  * a side whose window leaves the axis falls back to the other side;
//  * cascade: every velocity hit takes its strongest range-flagged neighbour
//    at offsets -E..E (in-segment only), strict > so the first maximum wins,
//    and marks that neighbour;
//  * the rows [zero_lo, zero_hi) read as 0.0.  rdm * 0 is -0 where rdm is
//    negative; every sum, comparison and maximum above treats -0 as 0, so
//    the flags are the plain version's on any finite RDM.
//
// The _rn intrinsics are never contracted into FMAs, so the CFAR arithmetic
// stays on the reference's operation sequence whatever -fmad says.
//
// What bounds it on an H100: bytes.  Per G2 window (52 x 332 x 3404) it must
// read the 303 used rows of f32 less the 35 re-notched ones (189.7 MB) and
// write two byte-wide flag maps (117.5 MB): 0.092 ms at 3.35 TB/s.  The
// arithmetic is ~1 GFLOP (0.015 ms at 67 TFLOP/s).  The earlier design (a thread
// a column, a 4-byte cp.async per cell, two barriers every four rows, byte
// stores, an IEEE division per mean) spent ~100 instructions a cell and
// stopped at 0.38 ms; this one spends its instructions on the CFAR
// arithmetic:
//
//  * one launch per call, of one of two bodies: the tile body below, or,
//    for an RDM no wider than kNarrowTx columns, the narrow body
//    (narrow_cfar_kernel, further down);
//  * a block owns a strip of TX output columns of one RDM (blockIdx.y) and
//    walks a band of rows down it.  Strips are cut from the RDM's columns,
//    not from its segments, so every thread's four columns start on a
//    16-byte boundary; a thread finds the segment of each of its columns
//    once, when it starts.  kernels/cfar.py::cfar_plan sizes the tiles and
//    the bands to whole waves of the card's resident blocks;
//  * the staged tile is SW = TX + 2H columns (H = 2e+r+g rounded up to 4,
//    the range halo), kCols = 4 neighbouring columns a thread, SW/4 threads;
//  * staging by TMA (cp.async.bulk.tensor) into a ring of steps of kRows
//    rows, each step completing on one mbarrier, kPrefetch rows ahead of
//    the step in use (a deeper ring costs a block an SM at G2 and gains
//    nothing on G0's or the mesh's shapes): one box of the step's kRows rows where they are
//    neighbours in the RDM, else (the wrap at a band's start or end, the
//    edge of the re-notch band) a box a row, issued by the lanes of warp 0
//    together.  A re-notched row or step is fetched as a box wholly outside
//    the tensor, which the TMA engine zero-fills without reading memory.
//    The tensor maps (cuTensorMapEncodeTiled, from cudaGetDriverEntryPoint,
//    so the library needs no -lcuda) are a __grid_constant__ argument;
//  * shapes TMA cannot take (a row stride that is not a multiple of 16
//    bytes, or an RDM that does not start on a 16-byte boundary;
//    parallel/sharding.py pads a range shard's halo-extended block to
//    whole 16 bytes a row) take the other staging path of the same kernel:
//    each thread copies its four columns by cp.async, zero-filling
//    re-notched rows and columns outside the RDM, and arrives on the same
//    mbarrier (cp.async.mbarrier.arrive.noinc).  kernels/cfar.py::cfar_plan
//    picks the path by shape;
//  * velocity: per row a thread reads its four columns with one 16-byte
//    shared-memory load, slides four windows in registers (r-1 adds and a
//    division by 5 each, div5: three FP32 operations, exact, no branch), and
//    keeps the means in a ring in shared memory of its own columns, from
//    which the cell 2g+r+1 rows later takes its left mean; the right mean is
//    the one just formed.  A step waits on one mbarrier, then runs
//    4 x kRows independent chains;
//  * range means are needed only around velocity hits, so they are formed
//    there, in the cascade, from the staged row.  A window that wraps (a
//    segment narrower than 2(g+r)+1) reads its wrapped cells from the tile
//    or, outside it, from memory.  On a re-notched row every cell, mean and
//    level is 0, so each candidate's flag is 0 >= 0*T and the first
//    in-segment candidate wins: the cascade takes that answer without
//    reading the row;
//  * one block barrier a step: the marks a hit sets on a neighbour's column
//    are in before the stores.  It also frees the ring steps the block has
//    finished with, so the producer needs no second mbarrier per step;
//  * stores: a thread packs its four flags of a row into one 32-bit store
//    per map from registers (a warp writes 128 contiguous bytes);
//  * the shipped windows (r = 5, g = 7, e = 1) are compile-time, so every
//    index and loop bound folds; other windows take a build with them at
//    run time (and the IEEE division).
// Measured (tools/bench_b1.py, NVIDIA H100 80GB HBM3 at a 700 W power
// limit, G2 fused): 0.227-0.229 ms of device time, 40% of the byte floor,
// where the earlier design took 0.375-0.379 on the re-notched RDM, and
// its re-notch product and B1 0.572-0.576.  What its parts cost (--cuts,
// --plans): the IEEE division in place of div5 +0.147 ms; cp.async staging
// in place of TMA +0.109; a box a row in place of a box a step +0.021; 8
// rows ahead in place of 4 +0.048 (a block fewer an SM); the flag stores
// 0.045; the range pass 0.029.

#include <cuda.h>  // CUtensorMap and the driver's enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90_async.cuh"

namespace {

using rsp::cp_async4;
using rsp::mbar_arrive_expect_tx;
using rsp::mbar_fence_init;
using rsp::mbar_init;
using rsp::mbar_wait;

constexpr int kMaxSegments = 32;
constexpr int kRows = 4;         // rows a step
constexpr int kCols = 4;         // neighbouring columns a thread
constexpr int kPrefetch = 4;     // rows staged ahead of a step's first (a multiple of kRows)
constexpr int kBox = 256;        // TMA box width limit (columns)
constexpr int kNoWinner = 255;   // no range-flagged neighbour (offsets are -127..127)

// The RDM as a TMA tensor (columns x batch * rows, f32): boxes of one row
// and boxes of one step's kRows rows, each min(SW, kBox) columns wide.
struct Maps {
  CUtensorMap row;
  CUtensorMap step;
};

struct CfarArgs {
  const float* rdm;
  uint8_t* flags;
  uint8_t* vflags;
  int nv, nr, lo, nvu;        // rows, columns, first cropped row, cropped rows
  int n_bands, band_rows;     // the block map: blockIdx.x = strip * n_bands + band
  int halo, tx;               // H, output columns a strip
  int r, g, e, method;
  float t;
  int range_detect;
  int zero_lo, zero_hi;       // RDM rows read as 0.0
  int tma;                    // staging by TMA (else cp.async)
  int n_seg;
  int col0[kMaxSegments];
  int cend[kMaxSegments];
  int first[kMaxSegments + 1];  // the narrow body's first block of each segment, and the total
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// CA-CFAR flag of v from its left/right window means; lok/rok say whether
// each window stays inside the axis
__device__ __forceinline__ bool cfar_flag(float v, float left, float right, bool lok, bool rok,
                                          int method, float t) {
  const float left_used = lok ? left : right;
  const float right_used = rok ? right : left;
  const float level = method == 0 ? fmaxf(left_used, right_used)
                                  : fminf(left_used, right_used);
  return v >= __fmul_rn(level, t);
}

// x / r for the shipped r = 5 without a division: q = x * RN(1/5), the
// remainder x - 5q exactly by an FMA, then q + rem * RN(1/5) rounded once.
// It is __fdiv_rn(x, 5.0f) bit for bit on all 2^32 inputs (exact quotients,
// +-0, inf and NaN keep q): rsp_check_div5 counts the inputs where the two
// differ, and chip_smoke.py and tests/test_torch_gpu.py require 0.  Unlike
// __fdiv_rn it has no branch to a slow path, so the 4 x kRows means of a
// step schedule as one block of independent chains.
__device__ __forceinline__ float div5(float x) {
  const float c = 0.2f;
  const float q = __fmul_rn(x, c);
  const float rem = __fmaf_rn(-q, 5.0f, x);
  return fabsf(rem) > 0.f ? __fmaf_rn(rem, c, q) : q;
}

template <int R>
__device__ __forceinline__ float div_r(float x, float rf) {
  if constexpr (R == 5) {
    return div5(x);
  } else {
    return __fdiv_rn(x, rf);
  }
}

// One window mean: (x[0] + x[-1]) + ... + x[-(r-1)], divided by r.
template <int R>
__device__ __forceinline__ float window_mean(const float* top, int r, float rf) {
  float acc = top[0];
  if constexpr (R > 0) {
#pragma unroll
    for (int j = 1; j < R; ++j) acc = __fadd_rn(acc, top[-j]);
  } else {
    for (int j = 1; j < r; ++j) acc = __fadd_rn(acc, top[-j]);
  }
  return div_r<R>(acc, rf);
}

// Shared-memory layout of one block: the ring of staged rows (kPrefetch +
// kRows + g + r rounded up to whole steps of kRows rows, SW floats a row),
// the ring of velocity means (SW floats a row, each thread its own columns:
// 2g + r + 1 rows when a step reads its left means before it writes its
// means, which needs 2g + r + 1 >= kRows, else kRows more), two buffers of a
// step's cascade marks (kRows x SW bytes each), one mbarrier a step of rows.
__host__ __device__ constexpr int data_ring(int r, int g) {
  return (kPrefetch + kRows + g + r + kRows - 1) / kRows * kRows;
}
__host__ __device__ constexpr int mean_ring(int r, int g) {
  return 2 * g + r + 1 >= kRows ? 2 * g + r + 1 : 2 * g + r + 1 + kRows;
}

__host__ __device__ constexpr int smem_bytes(int sw, int r, int g) {
  return 4 * (data_ring(r, g) + mean_ring(r, g)) * sw + 2 * kRows * sw +
         8 * (data_ring(r, g) / kRows);
}

// The kCols neighbouring columns of a thread, read or written as one
// 16-byte vector.
struct Cols {
  float v[kCols];
};

__device__ __forceinline__ Cols load_cols(const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ void store_cols(float* p, const Cols& c) {
  *reinterpret_cast<float4*>(p) = make_float4(c.v[0], c.v[1], c.v[2], c.v[3]);
}

// a thread's four flags of a row, bit j -> byte j of one 32-bit word
__device__ __forceinline__ uint32_t flag_bytes(uint32_t bits) {
  return ((bits & 0xFu) * 0x00204081u) & 0x01010101u;
}

// One CFAR configuration (r reference cells, g guard cells, GO/SO method,
// threshold t) serves both axes, as every reference call site passes.  With
// R > 0 the windows (R, G, E) are compile-time; R == 0 takes them from the
// arguments.  A thread owns kCols neighbouring columns of the SW staged.
template <int SW, int R, int G, int E>
__global__ void __launch_bounds__(SW / kCols)
cascaded_cfar_kernel(const __grid_constant__ Maps maps,
                     const __grid_constant__ CfarArgs a) {
  constexpr int kThreads = SW / kCols;
  constexpr int kSlotBox = SW < kBox ? SW : kBox;
  const int r = R > 0 ? R : a.r;
  const int g = R > 0 ? G : a.g;
  const int e = R > 0 ? E : a.e;
  const int lag = g + r;             // steps from a row's staging to its cell
  const int mlag = 2 * g + r + 1;    // steps from a cell's left mean to it
  const int dr = data_ring(r, g);
  const int ng = dr / kRows;         // steps of rows in the ring, one mbarrier each
  const int mr = mean_ring(r, g);
  const bool read_first = mlag >= kRows;
  extern __shared__ __align__(128) float smem[];
  float* s_d = smem;                                                   // [dr][SW]
  float* s_m = s_d + dr * SW;                                          // [mr][SW]
  uint8_t* s_mark = reinterpret_cast<uint8_t*>(s_m + mr * SW);         // [2][kRows][SW]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_mark + 2 * kRows * SW);  // [ng]

  const int band = blockIdx.x % a.n_bands;
  const int xt = (blockIdx.x / a.n_bands) * a.tx - a.halo;  // RDM column of tile column 0
  const int yb = band * a.band_rows;                        // first cropped row of the band
  const int rows = min(a.band_rows, a.nvu - yb);
  const size_t plane = static_cast<size_t>(blockIdx.y) * a.nv * a.nr;
  const int tid = threadIdx.x;
  const int c0 = kCols * tid;        // this thread's tile columns c0 .. c0+3
  const int x0 = xt + c0;            // and their RDM columns
  const bool out_grp = c0 >= a.halo && c0 < a.halo + a.tx && x0 < a.nr;
  const bool vec = a.tma && x0 + kCols <= a.nr;  // one 32-bit store of four flags

  // the segment of each column, [sl, sh); sl == sh outside the RDM
  int sl[kCols], sh[kCols];
  uint32_t src = 0;  // columns whose hits may mark an output column: bit 4k + j
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    sl[j] = sh[j] = 0;
    for (int s = 0; s < a.n_seg; ++s)
      if (x0 + j >= a.col0[s] && x0 + j < a.cend[s]) {
        sl[j] = a.col0[s];
        sh[j] = a.cend[s];
      }
    if (sl[j] < sh[j] && c0 + j >= a.halo - e && c0 + j < a.halo + a.tx + e)
#pragma unroll
      for (int k = 0; k < kRows; ++k) src |= 1u << (4 * k + j);
  }

  if (tid == 0) {
    for (int s = 0; s < ng; ++s) mbar_init(&full[s], a.tma ? 1 : kThreads);
    mbar_fence_init();
  }
#pragma unroll
  for (int k = 0; k < 2 * kRows; ++k) *reinterpret_cast<uint32_t*>(s_mark + k * SW + c0) = 0;
  __syncthreads();

  auto store_flags = [&](uint8_t* base, size_t off, uint32_t bytes) {
    if (vec) {
      *reinterpret_cast<uint32_t*>(base + off) = bytes;
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (x0 + j < a.nr) base[off + j] = static_cast<uint8_t>(bytes >> (8 * j));
    }
  };

  // the clutter rows outside [lo, lo + nvu) carry no flags
  if (band == 0 && out_grp) {
    for (int k = 0; k < a.nv - a.nvu; ++k) {
      const size_t o = plane + static_cast<size_t>(k < a.lo ? k : k + a.nvu) * a.nr + x0;
      store_flags(a.flags, o, 0u);
      store_flags(a.vflags, o, 0u);
    }
  }

  // Step i stages cropped row yb - lag + i (wrapped into [0, nvu)) into ring
  // row i % dr and forms the mean of the window ending there; from step
  // 2 lag on it also decides cell y = yb + i - 2 lag, whose value is lag
  // rows back and whose left mean mlag means back.  Steps run kRows at a
  // time, and the kRows rows of one go in by one mbarrier: by TMA, one row a
  // lane of warp 0, or by every thread's cp.async of its columns.
  const int n_steps = rows + 2 * lag;
  int i_stage = 0, g_stage = 0, y_stage = wrap(yb - lag, a.nvu);
  auto stage = [&]() {  // the next kRows steps' rows
    if (i_stage < n_steps) {
      const int n = min(kRows, n_steps - i_stage);
      float* dst = s_d + g_stage * kRows * SW;
      uint64_t* bar = &full[g_stage];
      if (a.tma) {
        // one box for the step's rows where they are neighbours in the RDM
        // and all or none re-notched (and a row is one box wide), else a
        // box a row, one a lane
        const int row0 = a.lo + y_stage;
        const bool none = row0 + n <= a.zero_lo || row0 >= a.zero_hi;
        const bool all = row0 >= a.zero_lo && row0 + n <= a.zero_hi;
        const bool whole = SW <= kBox && n == kRows && y_stage + kRows <= a.nvu && (none || all);
        if (tid < 32) {
          if (tid == 0) mbar_arrive_expect_tx(bar, n * SW * 4);
          __syncwarp();
          if (whole) {
            if (tid == 0)
              rsp::tma_load_2d(dst, &maps.step, xt,
                               all ? -kRows : static_cast<int>(blockIdx.y) * a.nv + row0, bar);
          } else if (tid < n) {
            const int row = a.lo + wrap(y_stage + tid, a.nvu);
            // a re-notched row: row -1, a box wholly outside the tensor
            const int grow = row >= a.zero_lo && row < a.zero_hi
                                 ? -1 : static_cast<int>(blockIdx.y) * a.nv + row;
#pragma unroll
            for (int b = 0; b < SW / kSlotBox; ++b)
              rsp::tma_load_2d(dst + tid * SW + b * kSlotBox, &maps.row, xt + b * kSlotBox,
                               grow, bar);
          }
        }
      } else {
        for (int k = 0; k < n; ++k) {
          const int row = a.lo + wrap(y_stage + k, a.nvu);
          const bool zero = row >= a.zero_lo && row < a.zero_hi;
          const float* src_row = a.rdm + plane + static_cast<size_t>(row) * a.nr;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const bool ok = !zero && x0 + j >= 0 && x0 + j < a.nr;
            cp_async4(dst + k * SW + c0 + j, ok ? src_row + x0 + j : a.rdm, ok ? 4 : 0);
          }
        }
        rsp::cp_async_mbar_arrive_noinc(bar);
      }
    }
    i_stage += kRows;
    if (++g_stage == ng) g_stage = 0;
    y_stage = wrap(y_stage + kRows, a.nvu);
  };
  for (int k = 0; k < kPrefetch; k += kRows) stage();

  auto next = [](int slot, int n, int ring) {
    slot += n;
    return slot >= ring ? slot - ring : slot;
  };
  // the ring step of step i0 (and the parity of its mbarrier's phase); the
  // ring rows of its cell, of its mean, of its cell's left mean
  int sg = 0, ph = 0, sc = (dr - lag % dr) % dr, sm = 0, sml = (mr - mlag % mr) % mr;
  const float rf = static_cast<float>(r);
  const bool rz = 0.f >= __fmul_rn(0.f, a.t);  // a re-notched cell's range flag
  float w[kCols][R > 0 ? R - 1 + kRows : 1];       // the sliding windows, R > 0
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int q = 0; q < (R > 0 ? R - 1 + kRows : 1); ++q) w[j][q] = 0.f;
  int buf = 0;
  for (int i0 = 0; i0 < n_steps; i0 += kRows) {
    stage();  // into the ring step the last step's barrier freed
    const int n_here = min(kRows, n_steps - i0);
    mbar_wait(&full[sg], ph);
    const float* rows_here = s_d + sg * kRows * SW + c0;
    Cols left[kRows];
    if (read_first) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) left[k] = load_cols(s_m + next(sml, k, mr) * SW + c0);
    }
    Cols mean[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if constexpr (R > 0) {
        const Cols v = load_cols(rows_here + k * SW);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          w[j][R - 1 + k] = v.v[j];
          float acc = w[j][R - 1 + k];
#pragma unroll
          for (int q = R - 2; q >= 0; --q) acc = __fadd_rn(acc, w[j][q + k]);
          mean[k].v[j] = div_r<R>(acc, rf);
        }
      } else {
        int sq = sg * kRows + k;
        Cols acc = load_cols(s_d + sq * SW + c0);
        for (int q = 1; q < r; ++q) {
          sq = sq == 0 ? dr - 1 : sq - 1;
          const Cols v = load_cols(s_d + sq * SW + c0);
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc.v[j] = __fadd_rn(acc.v[j], v.v[j]);
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) mean[k].v[j] = __fdiv_rn(acc.v[j], rf);
      }
      store_cols(s_m + next(sm, k, mr) * SW + c0, mean[k]);
    }
    if constexpr (R > 0) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int q = 0; q < R - 1; ++q) w[j][q] = w[j][q + kRows];
    }
    if (!read_first) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) left[k] = load_cols(s_m + next(sml, k, mr) * SW + c0);
    }

    // the cells of the step's rows: bit 4k + j
    uint32_t vf = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = i0 + k;
      if (i >= 2 * lag && k < n_here) {
        const int y = yb + i - 2 * lag;
        const bool lok = y - lag >= 0, rok = y + lag <= a.nvu - 1;
        const Cols d = load_cols(s_d + next(sc, k, dr) * SW + c0);
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (cfar_flag(d.v[j], left[k].v[j], mean[k].v[j], lok, rok, a.method, a.t))
            vf |= 1u << (4 * k + j);
      }
    }
    uint8_t* marks = s_mark + buf * kRows * SW;

    // every velocity hit marks its strongest range-flagged neighbour
    if (a.range_detect) {
      uint32_t hits = vf & src;
      while (hits) {
        const int bit = __ffs(hits) - 1;
        hits &= hits - 1;
        const int k = bit >> 2, j = bit & 3;
        const int x = x0 + j, c = c0 + j;
        int lo_s = sl[0], hi_s = sh[0];
#pragma unroll
        for (int q = 1; q < kCols; ++q)
          if (j == q) lo_s = sl[q], hi_s = sh[q];
        const int rrow = a.lo + yb + i0 + k - 2 * lag;
        int best_off = kNoWinner;
        if (rrow >= a.zero_lo && rrow < a.zero_hi) {
          if (rz) best_off = max(-e, lo_s - x);   // every candidate ties at 0
        } else {
          const float* row = s_d + next(sc, k, dr) * SW;  // the staged row of the cell
          const float* grow = a.rdm + plane + static_cast<size_t>(rrow) * a.nr;
          const int ns = hi_s - lo_s;
          float best = 0.f;
          for (int dd = -e; dd <= e; ++dd) {
            const int xc = x + dd;
            if (xc < lo_s || xc >= hi_s) continue;
            const int cc = c + dd;
            const int xs = xc - lo_s;
            const bool lok = xs - lag >= 0, rok = xs + lag <= ns - 1;
            float lm = 0.f, rm = 0.f;
            if (lok) lm = window_mean<R>(row + cc - g - 1, r, rf);
            if (rok) rm = window_mean<R>(row + cc + g + r, r, rf);
            if (!lok && !rok) {
              // a segment narrower than 2 lag + 1: both windows wrap in it
              auto cell = [&](int xi) {
                const int xw = lo_s + wrap(xi - lo_s, ns);
                const int tc = xw - xt;
                return tc >= 0 && tc < SW ? row[tc] : grow[xw];
              };
              float la = cell(xc - g - 1), ra = cell(xc + g + r);
              for (int q = 1; q < r; ++q) {
                la = __fadd_rn(la, cell(xc - g - 1 - q));
                ra = __fadd_rn(ra, cell(xc + g + r - q));
              }
              lm = div_r<R>(la, rf);
              rm = div_r<R>(ra, rf);
            }
            const float val = row[cc];
            if (!cfar_flag(val, lm, rm, lok, rok, a.method, a.t)) continue;
            if (best_off == kNoWinner || val > best) {
              best = val;
              best_off = dd;
            }
          }
        }
        const int target = c + best_off;  // the marked cell
        if (best_off != kNoWinner && target >= a.halo && target < a.halo + a.tx)
          marks[k * SW + target] = 1;
      }
    }
    __syncthreads();  // the marks are in; the step's finished rows may be restaged

    if (out_grp) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k;
        if (i < 2 * lag || k >= n_here) continue;
        const size_t o = plane + static_cast<size_t>(a.lo + yb + i - 2 * lag) * a.nr + x0;
        const uint32_t vb = flag_bytes(vf >> (4 * k));
        uint32_t fb = vb;
        if (a.range_detect) {
          auto* mk = reinterpret_cast<uint32_t*>(marks + k * SW + c0);
          fb = *mk;
          *mk = 0;
        }
        store_flags(a.flags, o, fb);
        store_flags(a.vflags, o, vb);
      }
    }
    buf ^= 1;
    if (++sg == ng) {
      sg = 0;
      ph ^= 1;
    }
    sc = next(sc, kRows, dr);
    sm = next(sm, kRows, mr);
    sml = next(sml, kRows, mr);
  }
}

// ------------------------------------------------------------- narrow RDMs
// An RDM no wider than kNarrowTx columns (G0's 62-column short segment, one
// RDM of 2035 cropped rows a call) gives the tile body one warp a block and
// a few blocks an SM, and the launch lasts a band's steps at their latency:
// on that segment the tile body takes twice the narrow body's time
// (tools/bench_b1.py --plans, NVIDIA H100 80GB HBM3 at 700 W: 0.015-0.016
// ms with bands of 4 against 0.0073).
// Such an RDM takes the earlier design's block map: a block walks a band of
// rows down one segment's strip of up to kNarrowTx output columns and its
// range halo (2e+r+g a side, wrapped inside the segment as it is staged), a
// thread a staged column.  Each thread copies its column's rows by cp.async
// kNarrowPrefetch rows ahead (a re-notched row zero-filled, not read), and
// a step of kRows rows has two block barriers: the rows staged (before the
// cascade reads neighbouring columns), the cascade's marks in (before the
// stores).  The arithmetic is the tile body's: the roll-form sums, div5,
// cfar_flag, the strict > first-maximum cascade; on a re-notched row the
// staged zeros give the plain version's answer.
constexpr int kNarrowTx = 64;        // output columns a strip
constexpr int kNarrowPrefetch = 8;   // rows in flight ahead of a step's first

__host__ __device__ constexpr int narrow_threads(int r, int g, int e) {
  return (kNarrowTx + 2 * (2 * e + r + g) + 31) / 32 * 32;
}

// Shared memory of a narrow block: the ring of staged rows (kNarrowPrefetch
// + kRows + g + r rows of the staged columns), the ring of velocity means
// (2g + r + 1 + kRows rows of the kNarrowTx + 2e source columns), a step's
// cascade marks (kRows rows of kNarrowTx bytes).
__host__ __device__ constexpr int narrow_smem_bytes(int r, int g, int e) {
  return 4 * ((kNarrowPrefetch + kRows + g + r) * (kNarrowTx + 2 * (2 * e + r + g)) +
              (2 * g + r + 1 + kRows) * (kNarrowTx + 2 * e)) +
         kRows * kNarrowTx;
}

template <int R, int G, int E>
__global__ void __launch_bounds__(R > 0 ? narrow_threads(R, G, E) : 1024)
narrow_cfar_kernel(const __grid_constant__ CfarArgs a) {
  const int r = R > 0 ? R : a.r;
  const int g = R > 0 ? G : a.g;
  const int e = R > 0 ? E : a.e;
  const int hr = 2 * e + r + g;      // range halo
  const int sw = kNarrowTx + 2 * hr; // staged columns, one thread each
  const int vw = kNarrowTx + 2 * e;  // source columns x0-e .. x0+kNarrowTx+e-1
  const int dr = kNarrowPrefetch + kRows + g + r;
  const int mr = 2 * g + r + 1 + kRows;
  const int lag = g + r, mlag = 2 * g + r + 1;
  extern __shared__ __align__(128) float smem[];
  float* s_d = smem;                                             // [dr][sw]
  float* s_mv = s_d + dr * sw;                                   // [mr][vw]
  uint8_t* s_fo = reinterpret_cast<uint8_t*>(s_mv + mr * vw);    // [kRows][kNarrowTx]

  // block -> (segment, strip, band); a segment's blocks run strip by strip,
  // band fastest
  int s = 0;
  while (s + 1 < a.n_seg && static_cast<int>(blockIdx.x) >= a.first[s + 1]) ++s;
  const int local = blockIdx.x - a.first[s];
  const int strip = local / a.n_bands, band = local - strip * a.n_bands;
  const int col0 = a.col0[s], ns = a.cend[s] - a.col0[s];
  const int x0 = strip * kNarrowTx;  // first segment column of the strip
  const int width = min(kNarrowTx, ns - x0);
  const int yb = band * a.band_rows;
  const int rows = min(a.band_rows, a.nvu - yb);
  const size_t plane = static_cast<size_t>(blockIdx.y) * a.nv * a.nr;

  // this thread's staged column c: segment column x, wrapped into the segment
  const int c = threadIdx.x;
  const bool staged = c < sw;
  const int x = x0 - hr + c;
  const int xs = x < 0 || x >= ns ? wrap(x, ns) : x;
  const float* src = a.rdm + plane + static_cast<size_t>(a.lo) * a.nr + col0 + xs;
  const int cx = c - (hr - e);       // source index, if 0 <= cx < vw
  const bool source = cx >= 0 && cx < vw;
  const int tx = c - hr;             // output index, if 0 <= tx < width
  const bool output = tx >= 0 && tx < width;

  // the clutter rows outside [lo, lo + nvu) carry no flags
  if (band == 0 && output) {
    const size_t o = plane + col0 + x0 + tx;
    for (int k = 0; k < a.nv - a.nvu; ++k) {
      const size_t ok = o + static_cast<size_t>(k < a.lo ? k : k + a.nvu) * a.nr;
      a.flags[ok] = 0;
      a.vflags[ok] = 0;
    }
  }

  // Step i copies cropped row yb - lag + i (wrapped into [0, nvu)) into ring
  // slot i % dr and forms the mean of the window ending there; from step
  // 2 lag on it also decides cell y = yb + i - 2 lag, whose value is lag
  // slots back and whose left mean mlag means back, as in the tile body.
  const int n_steps = rows + 2 * lag;
  int i_load = 0, slot_load = 0, y_load = wrap(yb - lag, a.nvu);
  auto issue = [&]() {  // one row's copy, one cp.async group
    if (staged && i_load < n_steps) {
      const int row = a.lo + y_load;
      const bool zero = row >= a.zero_lo && row < a.zero_hi;
      cp_async4(s_d + slot_load * sw + c, zero ? a.rdm : src + static_cast<size_t>(y_load) * a.nr,
                zero ? 0 : 4);
    }
    rsp::cp_async_commit();
    ++i_load;
    if (++slot_load == dr) slot_load = 0;
    if (++y_load == a.nvu) y_load = 0;
  };
#pragma unroll
  for (int k = 0; k < kNarrowPrefetch; ++k) issue();

  auto next = [](int slot, int n, int ring) {
    slot += n;
    return slot >= ring ? slot - ring : slot;
  };
  // ring slots of step i0 (data, mean), of its cell's row and left mean
  int sd = 0, sm = 0, sd_cell = (dr - lag % dr) % dr, sm_left = (mr - mlag % mr) % mr;
  size_t o_next = plane + static_cast<size_t>(a.lo + yb) * a.nr + col0 + x0 + tx;
  const float rf = static_cast<float>(r);
  float w[R > 0 ? R - 1 + kRows : 1] = {};  // the sliding window, R > 0
  for (int i0 = 0; i0 < n_steps; i0 += kRows) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) issue();
    rsp::cp_async_wait<kNarrowPrefetch>();  // this thread's rows i0 .. i0+kRows-1 landed
    float mean[kRows];
    if (source) {
      if constexpr (R > 0) {
#pragma unroll
        for (int j = 0; j < R - 1; ++j) w[j] = w[j + kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) w[R - 1 + k] = s_d[next(sd, k, dr) * sw + c];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          float acc = w[R - 1 + k];
#pragma unroll
          for (int j = R - 2; j >= 0; --j) acc = __fadd_rn(acc, w[j + k]);
          mean[k] = div_r<R>(acc, rf);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          int sl = next(sd, k, dr);
          float acc = s_d[sl * sw + c];
          for (int j = 1; j < r; ++j) {
            sl = sl == 0 ? dr - 1 : sl - 1;
            acc = __fadd_rn(acc, s_d[sl * sw + c]);
          }
          mean[k] = __fdiv_rn(acc, rf);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) s_mv[next(sm, k, mr) * vw + cx] = mean[k];
    }
    const int sd_c = sd_cell, sm_l = sm_left;
    sd = next(sd, kRows, dr);
    sm = next(sm, kRows, mr);
    sd_cell = next(sd_cell, kRows, dr);
    sm_left = next(sm_left, kRows, mr);
    if (i0 + kRows <= 2 * lag) continue;  // still filling the pipeline (own column only)

    bool vf[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = i0 + k;
      const int y = yb + i - 2 * lag;
      vf[k] = false;
      if (source && i >= 2 * lag && i < n_steps)
        vf[k] = cfar_flag(s_d[next(sd_c, k, dr) * sw + c], s_mv[next(sm_l, k, mr) * vw + cx],
                          mean[k], y - lag >= 0, y + lag <= a.nvu - 1, a.method, a.t);
      if (output) s_fo[k * kNarrowTx + tx] = 0;
    }
    __syncthreads();  // every column of the rows staged, the marks clear

    // every velocity hit marks its strongest range-flagged neighbour within
    // the segment; candidate xc (staged column c + dd) from its windows
    // ending at xc-g-1 and xc+g+r, read from the staged (wrapped) row
    if (a.range_detect && x >= 0 && x < ns) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!vf[k]) continue;
        const float* row = s_d + next(sd_c, k, dr) * sw;
        int best_off = kNoWinner;
        float best = 0.f;
        for (int dd = -e; dd <= e; ++dd) {
          const int xc = x + dd;
          if (xc < 0 || xc >= ns) continue;
          const int sc = c + dd;
          const float val = row[sc];
          if (!cfar_flag(val, window_mean<R>(row + sc - g - 1, r, rf),
                         window_mean<R>(row + sc + g + r, r, rf), xc - lag >= 0,
                         xc + lag <= ns - 1, a.method, a.t))
            continue;
          if (best_off == kNoWinner || val > best) {
            best = val;
            best_off = dd;
          }
        }
        const int target = tx + best_off;  // the marked cell
        if (best_off != kNoWinner && target >= 0 && target < kNarrowTx)
          s_fo[k * kNarrowTx + target] = 1;
      }
    }
    __syncthreads();  // the marks are in; the rows' slots may be refilled after this

#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = i0 + k;
      if (i < 2 * lag || i >= n_steps) continue;
      if (output) {
        a.flags[o_next] = a.range_detect ? s_fo[k * kNarrowTx + tx] : vf[k];
        a.vflags[o_next] = vf[k];
      }
      o_next += a.nr;
    }
  }
  rsp::cp_async_wait<0>();
}

// Counts the float32 bit patterns x where div5(x) and __fdiv_rn(x, 5.0f)
// differ in any bit, over all 2^32 of them, into *bad.
__global__ void check_div5_kernel(unsigned long long* bad) {
  unsigned long long n = 0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(i));
    n += __float_as_uint(div5(x)) != __float_as_uint(__fdiv_rn(x, 5.0f));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(bad, n);
}

template <int SW, int R, int G, int E>
cudaError_t launch(const Maps& maps, const CfarArgs& args, int n_blocks, int batch,
                   cudaStream_t stream) {
  const int smem = smem_bytes(SW, args.r, args.g);
  // all of the SM's 228 KB to shared memory, and room for this call's
  // block; set once per build and size (a benign race between threads)
  static int smem_set = -1;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(cascaded_cfar_kernel<SW, R, G, E>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cascaded_cfar_kernel<SW, R, G, E>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cascaded_cfar_kernel<SW, R, G, E><<<dim3(n_blocks, batch), SW / kCols, smem, stream>>>(
      maps, args);
  return cudaGetLastError();
}

template <int R, int G, int E>
cudaError_t launch_narrow(const CfarArgs& args, int batch, cudaStream_t stream) {
  const int smem = narrow_smem_bytes(args.r, args.g, args.e);
  static int smem_set = -1;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        narrow_cfar_kernel<R, G, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  narrow_cfar_kernel<R, G, E><<<dim3(args.first[args.n_seg], batch),
                                narrow_threads(args.r, args.g, args.e), smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// The number of float32 bit patterns where B1's division by 5 differs from
// __fdiv_rn(x, 5.0f), all 2^32 counted, into *bad (an unsigned 64-bit
// integer on the card, zeroed by the caller).  Returns a cudaError_t.
extern "C" int rsp_check_div5(void* bad, void* stream) {
  check_div5_kernel<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// Shared-memory bytes of one block staging sw columns a row, or of one
// block of the narrow body (sw = 0).
extern "C" int rsp_cascaded_cfar_smem_bytes(int sw, int r, int g, int e) {
  return sw == 0 ? narrow_smem_bytes(r, g, e) : smem_bytes(sw, r, g);
}

// One launch over all n_seg segments of a (batch, nv, nr) f32 RDM; flags and
// vflags are (batch, nv, nr) bytes.  segments holds col0[n_seg] and
// end[n_seg] (half-open, tiling [0, nr)).  The block map is
// kernels/cfar.py::cfar_plan's: strips of sw - 2 halo output columns
// (halo = 2e+r+g rounded up to 4), bands of band_rows cropped rows.  Rows
// [zero_lo, zero_hi) read as 0.0.  tma: stage by TMA (nr a multiple of 4,
// rdm 16-byte aligned), else by cp.async.  Returns a cudaError_t.
extern "C" int rsp_cascaded_cfar(const void* rdm, void* flags, void* vflags, int batch, int nv,
                                 int nr, int lo, int nvu, int n_seg, const int* segments,
                                 int sw, int band_rows, int r, int g, int method, float t,
                                 int e, int range_detect, int zero_lo, int zero_hi, int tma,
                                 void* stream) {
  const bool narrow = sw == 0;
  const int halo = narrow ? 2 * e + r + g : (2 * e + r + g + 3) / 4 * 4;
  const int tx = narrow ? kNarrowTx : sw - 2 * halo;
  if (n_seg < 1 || n_seg > kMaxSegments || band_rows < 1 || tx < 4 || batch < 1 || nvu < 1 ||
      (narrow && (tma || narrow_threads(r, g, e) > 1024)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tma && (nr % 4 != 0 || reinterpret_cast<uintptr_t>(rdm) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  CfarArgs args{};
  args.rdm = static_cast<const float*>(rdm);
  args.flags = static_cast<uint8_t*>(flags);
  args.vflags = static_cast<uint8_t*>(vflags);
  args.nv = nv;
  args.nr = nr;
  args.lo = lo;
  args.nvu = nvu;
  args.n_bands = (nvu + band_rows - 1) / band_rows;
  args.band_rows = band_rows;
  args.halo = halo;
  args.tx = tx;
  args.r = r;
  args.g = g;
  args.e = e;
  args.method = method;
  args.t = t;
  args.range_detect = range_detect;
  args.zero_lo = zero_lo;
  args.zero_hi = zero_hi;
  args.tma = tma;
  args.n_seg = n_seg;
  for (int i = 0; i < n_seg; ++i) {
    args.col0[i] = segments[i];
    args.cend[i] = segments[n_seg + i];
    args.first[i + 1] = args.first[i] + (args.cend[i] - args.col0[i] + kNarrowTx - 1) /
                                            kNarrowTx * args.n_bands;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  // r = 5, g = 7, e = 1 (every shipped profile) is compiled for those
  // windows; any other configuration takes them at run time
  const bool shipped = r == 5 && g == 7 && e == 1;
  if (narrow)
    return static_cast<int>(shipped ? launch_narrow<5, 7, 1>(args, batch, st)
                                    : launch_narrow<0, 0, 0>(args, batch, st));
  Maps maps{};
  if (tma) {
    const rsp::EncodeTiled encode = rsp::tensor_map_encoder();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(nr),
                                static_cast<cuuint64_t>(batch) * static_cast<cuuint64_t>(nv)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(nr) * 4};
    const cuuint32_t elem[2] = {1, 1};
    for (int rows = 1; rows <= kRows; rows += kRows - 1) {
      const cuuint32_t box[2] = {static_cast<cuuint32_t>(sw < kBox ? sw : kBox),
                                 static_cast<cuuint32_t>(rows)};
      if (encode(rows == 1 ? &maps.row : &maps.step, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                 const_cast<void*>(rdm), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS)
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int n_blocks = (nr + tx - 1) / tx * args.n_bands;
#define RSP_CFAR_TILE(SW_)                                                                \
  if (sw == SW_)                                                                          \
    return static_cast<int>(shipped ? launch<SW_, 5, 7, 1>(maps, args, n_blocks, batch, st) \
                                    : launch<SW_, 0, 0, 0>(maps, args, n_blocks, batch, st));
  RSP_CFAR_TILE(128)
  RSP_CFAR_TILE(256)
  RSP_CFAR_TILE(512)
  RSP_CFAR_TILE(1024)
#undef RSP_CFAR_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
