// B1: cascaded velocity-then-range CA-CFAR over every pulse segment of an
// RDM stack, in one launch.
//
// Replaces radar_signal_process_tpu/kernels/cfar_pallas.py:136
// (cascaded_cfar2d_pallas) and is bit-identical to ops/cfar.py::
// segmented_cfar (the lockstep contract of the five CFAR implementations):
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
//    and marks that neighbour.
//
// The _rn intrinsics are never contracted into FMAs, so the CFAR arithmetic
// stays on the reference's operation sequence whatever -fmad says.
//
// What bounds it on an H100: bytes.  Per G2 window (52 x 332 x 3404) it must
// read the 303 used rows of f32 (214.5 MB) and write two byte-wide flag maps
// (117.5 MB): ~0.10 ms at 3.35 TB/s.  The arithmetic is ~1 GFLOP (0.015 ms
// at 67 TFLOP/s).  What costs in practice is issue and latency per cell, so
// the design streams each column through a pipeline and keeps the work per
// cell near the arithmetic itself:
//
//  * one launch per call: the segment table (col0, ns, first block) is a
//    kernel argument and a block finds its segment, column strip and band of
//    rows from blockIdx.x; blocks of the first band also zero the clutter
//    rows;
//  * a block owns a strip of TX output columns (256, 128 or 64) plus the
//    range halo (hr = 2e+r+g columns each side), one thread per column, and
//    walks a band of rows down it.  Each thread copies its column's rows by
//    cp.async kPrefetch rows ahead into a ring in shared memory (neighbouring
//    lanes on neighbouring addresses), the column wrapped once, when the
//    thread starts, the row index as it goes;
//  * a column's velocity window slides in registers: per row one new value,
//    r-1 adds, one division, and the mean goes into a per-column ring, from
//    which the cell 2g+r+1 rows later takes its left mean; the right mean is
//    the one just formed.  No mean is formed twice and no row is read twice,
//    except 2(g+r) rows to fill the pipeline at a band's start
//    (kernels/cfar.py::cfar_plan sizes the bands);
//  * range means are needed only around velocity hits (a few percent of the
//    cells), so they are formed there, in the cascade, from the staged row;
//  * a thread takes kRows rows per step, kRows independent chains, and a
//    step has two barriers: the rows' staged values and flags are in before
//    the cascade reads neighbours, the cascade's marks before the stores.
//    Each warp stores 32 neighbouring flag bytes of both maps per row;
//  * the shipped windows (r = 5, g = 7, e = 1) are compile-time, so every
//    index and loop bound folds; other windows take a build with them at
//    run time.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxSegments = 32;
constexpr int kRows = 4;         // rows a thread takes per step
constexpr int kPrefetch = 8;     // rows in flight ahead of a step's first
constexpr int kNoWinner = 255;   // no range-flagged neighbour (offsets are -127..127)

struct SegmentTable {
  int n;
  int col0[kMaxSegments];
  int ns[kMaxSegments];
  int first_block[kMaxSegments + 1];
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// CA-CFAR flag of v from its left/right window means; lok/rok say whether
// each window stays inside the axis
__device__ __forceinline__ uint8_t cfar_flag(float v, float left, float right, bool lok,
                                             bool rok, int method, float t) {
  const float left_used = lok ? left : right;
  const float right_used = rok ? right : left;
  const float level = method == 0 ? fmaxf(left_used, right_used)
                                  : fminf(left_used, right_used);
  return v >= __fmul_rn(level, t) ? 1 : 0;
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
  return __fdiv_rn(acc, rf);
}

// Shared-memory layout of one block (the kernel below): the ring of
// kPrefetch + kRows + g + r staged rows of sw = TX + 2hr columns, the ring
// of 2g + r + 1 + kRows velocity means of the vw = TX + 2e source columns,
// the TX cascade flags of each of a step's kRows rows.
__host__ __device__ constexpr int data_ring(int r, int g) { return kPrefetch + kRows + g + r; }
__host__ __device__ constexpr int mean_ring(int r, int g) { return 2 * g + r + 1 + kRows; }

__host__ __device__ constexpr int smem_bytes(int tx, int r, int g, int e) {
  const int sw = tx + 2 * (2 * e + r + g);
  return 4 * (data_ring(r, g) * sw + mean_ring(r, g) * (tx + 2 * e)) + kRows * tx;
}

// Threads of a block: one per staged column, TX + 2hr, in whole warps.
__host__ __device__ constexpr int block_threads(int tx, int r, int g, int e) {
  return (tx + 2 * (2 * e + r + g) + 31) / 32 * 32;
}

// Launch bounds: with the windows compile-time, as many blocks per SM as
// its threads and 228 KB of shared memory allow, registers capped to fit
// them; else up to 1024 threads.
template <int TX, int R, int G, int E>
constexpr int kMaxThreads = R > 0 ? block_threads(TX, R, G, E) : 1024;
template <int TX, int R, int G, int E>
constexpr int kMinBlocks =
    R > 0 ? (2048 / kMaxThreads<TX, R, G, E> < 233472 / (smem_bytes(TX, R, G, E) + 1024)
                 ? 2048 / kMaxThreads<TX, R, G, E>
                 : 233472 / (smem_bytes(TX, R, G, E) + 1024))
          : 1;

// One CFAR configuration (r reference cells, g guard cells, GO/SO method,
// threshold t) serves both axes, as every reference call site passes.  With
// R > 0 the windows (R, G, E) are compile-time, so every index and loop
// bound folds; R == 0 takes them from the arguments.
template <int TX, int R, int G, int E>
__global__ void __launch_bounds__(kMaxThreads<TX, R, G, E>, kMinBlocks<TX, R, G, E>)
cascaded_cfar_kernel(const float* __restrict__ rdm, uint8_t* __restrict__ flags,
                                     uint8_t* __restrict__ vflags, const SegmentTable tab,
                                     int nv, int nr, int lo, int nvu, int n_bands,
                                     int band_rows, int r_arg, int g_arg, int method, float t,
                                     int e_arg, int range_detect) {
  const int r = R > 0 ? R : r_arg;
  const int g = R > 0 ? G : g_arg;
  const int e = R > 0 ? E : e_arg;
  extern __shared__ __align__(16) float smem[];
  const int hr = 2 * e + r + g;      // range halo (columns)
  const int sw = TX + 2 * hr;        // staged columns, one thread each
  const int vw = TX + 2 * e;         // source columns x0-e .. x0+TX+e-1
  const int dr = data_ring(r, g);
  const int mr = mean_ring(r, g);
  float* s_d = smem;                 // [dr][sw]
  float* s_mv = s_d + dr * sw;       // [mr][vw]
  uint8_t* s_fo = reinterpret_cast<uint8_t*>(s_mv + mr * vw);  // [kRows][TX]

  // block -> (segment, column strip, band of rows); blocks of a segment run
  // strip by strip, band fastest
  const int bid = blockIdx.x;
  int s = 0;
  while (s + 1 < tab.n && bid >= tab.first_block[s + 1]) ++s;
  const int local = bid - tab.first_block[s];
  const int ct = local / n_bands;
  const int band = local - ct * n_bands;
  const int col0 = tab.col0[s];
  const int ns = tab.ns[s];
  const int x0 = ct * TX;                      // first segment column of the strip
  const int width = min(TX, ns - x0);
  const int yb = band * band_rows;             // first cropped row of the band
  const int rows = min(band_rows, nvu - yb);
  const size_t plane = static_cast<size_t>(blockIdx.y) * nv * nr;

  // this thread's column: staged column c, segment column x (wrapped once)
  const int c = threadIdx.x;
  const bool staged = c < sw;
  const int x = x0 - hr + c;
  const int xs = x < 0 || x >= ns ? wrap(x, ns) : x;
  const float* src = rdm + plane + static_cast<size_t>(lo) * nr + col0 + xs;
  const int cx = c - (hr - e);                 // source index, if 0 <= cx < vw
  const bool source = cx >= 0 && cx < vw;
  const int tx = c - hr;                       // output index, if 0 <= tx < width
  const bool output = tx >= 0 && tx < width;

  // the clutter rows outside [lo, lo + nvu) carry no flags
  if (band == 0 && output) {
    const size_t o = plane + col0 + x0 + tx;
    for (int k = 0; k < nv - nvu; ++k) {
      const size_t ok = o + static_cast<size_t>(k < lo ? k : k + nvu) * nr;
      flags[ok] = 0;
      vflags[ok] = 0;
    }
  }

  // Step i loads cropped row yb - g - r + i (wrapped into [0, nvu)) into
  // ring slot i % dr and forms the mean of the window ending there; from
  // step 2(g+r) on it also decides cell y = yb + i - 2(g+r), whose value is
  // g+r slots back and whose left mean 2g+r+1 means back.  The steps run
  // kRows at a time: kRows independent chains per thread, one pair of
  // barriers per group.
  const int n_steps = rows + 2 * (g + r);
  const int lag = g + r;                       // steps from a row's copy to its cell
  const int mlag = 2 * g + r + 1;              // steps from a cell's left mean to it
  // the copies: step, ring slot and source row advance together
  int i_load = 0;
  int slot_load = 0;
  const float* p_load = src + static_cast<size_t>(wrap(yb - g - r, nvu)) * nr;
  const float* const p_end = src + static_cast<size_t>(nvu) * nr;
  auto issue = [&]() {
    if (staged && i_load < n_steps) cp_async4(s_d + slot_load * sw + c, p_load);
    cp_async_commit();
    ++i_load;
    if (++slot_load == dr) slot_load = 0;
    p_load += nr;
    if (p_load == p_end) p_load = src;
  };
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) issue();

  // ring slots of step i0 (data, mean), of its cell's row and left mean
  int sd = 0, sm = 0, sd_cell = dr - lag % dr, sm_left = mr - mlag % mr;
  auto next = [](int slot, int n, int ring) { slot += n; return slot >= ring ? slot - ring : slot; };
  size_t o_next = plane + static_cast<size_t>(lo + yb) * nr + col0 + x0 + tx;  // next cell out
  const float rf = static_cast<float>(r);
  float w[R > 0 ? R + kRows - 1 : 1] = {};     // the sliding window, R > 0
  for (int i0 = 0; i0 < n_steps; i0 += kRows) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) issue();
    cp_async_wait<kPrefetch>();                // this thread's rows i0 .. i0+kRows-1 landed
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
          mean[k] = __fdiv_rn(acc, rf);
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
    if (i0 + kRows <= 2 * lag) continue;       // still filling the pipeline

    uint8_t vf[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = i0 + k;
      const int y = yb + i - 2 * lag;
      vf[k] = 0;
      if (source && y >= yb && i < n_steps) {
        const float left = s_mv[next(sm_l, k, mr) * vw + cx];
        vf[k] = cfar_flag(s_d[next(sd_c, k, dr) * sw + c], left, mean[k], y - lag >= 0,
                          y + lag <= nvu - 1, method, t);
      }
      if (output) s_fo[k * TX + tx] = 0;
    }
    __syncthreads();  // every column of the rows staged (the copies of others too), fo clear

    // every velocity hit marks its strongest range-flagged neighbour; the
    // range flag of candidate xc (staged column sc) from its left window,
    // ending at xc-g-1, and its right one, ending at xc+g+r
    if (range_detect && x >= 0 && x < ns) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!vf[k]) continue;
        const float* row = s_d + next(sd_c, k, dr) * sw;  // the staged row of the cell
        int best_off = kNoWinner;
        float best = 0.f;
        for (int dd = -e; dd <= e; ++dd) {
          const int xc = x + dd;
          if (xc < 0 || xc >= ns) continue;
          const int sc = c + dd;
          const float val = row[sc];
          if (!cfar_flag(val, window_mean<R>(row + sc - g - 1, r, rf),
                         window_mean<R>(row + sc + g + r, r, rf), xc - lag >= 0,
                         xc + lag <= ns - 1, method, t))
            continue;
          if (best_off == kNoWinner || val > best) {
            best = val;
            best_off = dd;
          }
        }
        const int target = tx + best_off;  // the marked cell
        if (best_off != kNoWinner && target >= 0 && target < TX) s_fo[k * TX + target] = 1;
      }
    }
    __syncthreads();  // the marks are in; the rows' staged slots may be refilled after this

    // a warp stores 32 neighbouring bytes of both maps per row
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = i0 + k;
      if (i < 2 * lag || i >= n_steps) continue;
      if (output) {
        flags[o_next] = range_detect ? s_fo[k * TX + tx] : vf[k];
        vflags[o_next] = vf[k];
      }
      o_next += nr;
    }
  }
  cp_async_wait<0>();
}

template <int TX, int R, int G, int E>
cudaError_t launch(const float* rdm, uint8_t* flags, uint8_t* vflags, const SegmentTable& tab,
                   int n_blocks, int batch, int nv, int nr, int lo, int nvu, int n_bands,
                   int band_rows, int r, int g, int method, float t, int e, int range_detect,
                   cudaStream_t stream) {
  const int smem = smem_bytes(TX, r, g, e);
  // all of the SM's 228 KB to shared memory, and room for this call's
  // block; set once per build and size (a benign race between threads)
  static int smem_set = -1;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(cascaded_cfar_kernel<TX, R, G, E>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cascaded_cfar_kernel<TX, R, G, E>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int threads = block_threads(TX, r, g, e);
  cascaded_cfar_kernel<TX, R, G, E><<<dim3(n_blocks, batch), threads, smem, stream>>>(
      rdm, flags, vflags, tab, nv, nr, lo, nvu, n_bands, band_rows, r, g, method, t, e,
      range_detect);
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one block of tx output columns.
extern "C" int rsp_cascaded_cfar_smem_bytes(int tx, int r, int g, int e) {
  return smem_bytes(tx, r, g, e);
}

// One launch over all n_seg segments of a (batch, nv, nr) f32 RDM; flags and
// vflags are (batch, nv, nr) bytes.  segments holds col0[n_seg], ns[n_seg],
// first_block[n_seg + 1] (the block map of kernels/cfar.py::cfar_plan: strips
// of tx columns, bands of band_rows rows).  Returns a cudaError_t.
extern "C" int rsp_cascaded_cfar(const void* rdm, void* flags, void* vflags, int batch, int nv,
                                 int nr, int lo, int nvu, int n_seg, const int* segments,
                                 int tx, int band_rows, int r, int g, int method, float t,
                                 int e, int range_detect, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments || band_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  SegmentTable tab{};
  tab.n = n_seg;
  for (int i = 0; i < n_seg; ++i) {
    tab.col0[i] = segments[i];
    tab.ns[i] = segments[n_seg + i];
  }
  for (int i = 0; i <= n_seg; ++i) tab.first_block[i] = segments[2 * n_seg + i];
  const int n_blocks = tab.first_block[n_seg];
  const int n_bands = (nvu + band_rows - 1) / band_rows;
  const auto* x = static_cast<const float*>(rdm);
  auto* f = static_cast<uint8_t*>(flags);
  auto* v = static_cast<uint8_t*>(vflags);
  const auto st = static_cast<cudaStream_t>(stream);
  // r = 5, g = 7, e = 1 (every shipped profile) is compiled for those
  // windows; any other configuration takes them at run time
  const bool shipped = r == 5 && g == 7 && e == 1;
#define RSP_CFAR_STRIP(TX_)                                                                 \
  if (tx == TX_)                                                                            \
    return static_cast<int>(                                                                \
        shipped ? launch<TX_, 5, 7, 1>(x, f, v, tab, n_blocks, batch, nv, nr, lo, nvu,      \
                                       n_bands, band_rows, r, g, method, t, e,              \
                                       range_detect, st)                                    \
                : launch<TX_, 0, 0, 0>(x, f, v, tab, n_blocks, batch, nv, nr, lo, nvu,      \
                                       n_bands, band_rows, r, g, method, t, e,              \
                                       range_detect, st));
  RSP_CFAR_STRIP(256)
  RSP_CFAR_STRIP(128)
  RSP_CFAR_STRIP(64)
#undef RSP_CFAR_STRIP
  return static_cast<int>(cudaErrorInvalidValue);
}
