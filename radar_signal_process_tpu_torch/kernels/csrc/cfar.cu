// B1: cascaded velocity-then-range CA-CFAR over one pulse segment.
//
// Replaces radar_signal_process_tpu/kernels/cfar_pallas.py::
// cascaded_cfar2d_pallas and is bit-identical to ops/cfar.py::
// cascaded_cfar2d (the lockstep contract of the five CFAR implementations):
//
//  * window sums in the roll form's order: left = d[y-g-1] + ... + d[y-g-r],
//    right = d[y+g+r] + ... + d[y+g+1], each added one term at a time, with
//    indices wrapped inside the cropped rows (velocity) or inside the segment
//    (range), as torch.roll / jnp.roll wrap;
//  * means are sum / float(r) in IEEE division (__fdiv_rn), not the Pallas
//    kernel's sum * (1/r);
//  * flag = d >= level * T with the f32 product (__fmul_rn);
//  * a side whose window leaves the axis falls back to the other side;
//  * cascade: every velocity hit takes its strongest range-flagged neighbour
//    at offsets -E..E (in-segment only), strict > so the first maximum wins,
//    and marks that neighbour.
//
// The _rn intrinsics are never contracted into FMAs, so the CFAR arithmetic
// stays on the reference's operation sequence whatever -fmad says.
//
// What bounds it on an H100: bytes.  Per G2 window it reads the 52 x 332 x
// 3404 f32 RDM and writes two byte-wide flag maps (~0.35 GB at minimum); the
// arithmetic is ~30 adds per cell.  One block owns a 32-row x 64-column tile
// of one (item, segment): it stages the tile plus its velocity and range
// halos in shared memory once, forms every running sum from shared memory,
// keeps the velocity flags, range flags and winner offsets of the tile in
// shared memory, and writes each output byte once.  Blocks of the first row
// tile also zero the clutter rows cropped off the CFAR.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTY = 32;  // cropped Doppler rows per block
constexpr int kTX = 64;  // segment columns per block
constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// sum of p[-(g+1)*s], p[-(g+2)*s], ..., p[-(g+r)*s], in that order
__device__ __forceinline__ float left_sum(const float* p, int s, int r, int g) {
  float acc = p[-(g + 1) * s];
  for (int j = 2; j <= r; ++j) acc = __fadd_rn(acc, p[-(g + j) * s]);
  return acc;
}

// sum of p[(g+r)*s], p[(g+r-1)*s], ..., p[(g+1)*s], in that order
__device__ __forceinline__ float right_sum(const float* p, int s, int r, int g) {
  float acc = p[(g + r) * s];
  for (int j = 1; j < r; ++j) acc = __fadd_rn(acc, p[(g + r - j) * s]);
  return acc;
}

// CA-CFAR flag of *p at index idx of an axis of length n (stride s in smem)
__device__ __forceinline__ uint8_t cfar_flag(const float* p, int s, int idx, int n,
                                             int r, int g, int method, float t) {
  const float rf = static_cast<float>(r);
  const float left = __fdiv_rn(left_sum(p, s, r, g), rf);
  const float right = __fdiv_rn(right_sum(p, s, r, g), rf);
  const float left_used = idx - (g + r) >= 0 ? left : right;
  const float right_used = idx + (g + r) <= n - 1 ? right : left;
  const float level = method == 0 ? fmaxf(left_used, right_used)
                                  : fminf(left_used, right_used);
  return *p >= __fmul_rn(level, t) ? 1 : 0;
}

// One CFAR configuration (r reference cells, g guard cells, GO/SO method,
// threshold t) serves both axes, as every reference call site passes.
__global__ void __launch_bounds__(kThreads)
cascaded_cfar_kernel(const float* __restrict__ rdm, uint8_t* __restrict__ flags,
                     uint8_t* __restrict__ vflags, int nv, int nr, int lo, int nvu,
                     int col0, int ns, int r, int g, int method, float t, int e,
                     int range_detect) {
  extern __shared__ float smem[];
  const int hv = r + g;            // velocity halo (rows)
  const int hr = 2 * e + r + g;    // range halo (columns)
  const int sw = kTX + 2 * hr;     // staged tile pitch
  const int sh = kTY + 2 * hv;     // staged tile rows
  const int vw = kTX + 2 * e;      // source columns x0-e .. x0+TX+e-1
  const int rw = kTX + 4 * e;      // candidate columns x0-2e .. x0+TX+2e-1
  float* s_d = smem;
  int* s_best = reinterpret_cast<int*>(s_d + sh * sw);
  uint8_t* s_vf = reinterpret_cast<uint8_t*>(s_best + kTY * vw);
  uint8_t* s_rf = s_vf + kTY * vw;

  const size_t plane = static_cast<size_t>(nv) * nr;
  const float* d = rdm + blockIdx.z * plane;
  uint8_t* fl = flags + blockIdx.z * plane;
  uint8_t* vfl = vflags + blockIdx.z * plane;
  const int y0 = blockIdx.y * kTY;  // first cropped row of the tile
  const int x0 = blockIdx.x * kTX;  // first segment column of the tile
  const int tid = threadIdx.x;

  // 1. stage the tile and its halos, wrapped as the roll form wraps
  for (int i = tid; i < sh * sw; i += kThreads) {
    const int y = wrap(y0 - hv + i / sw, nvu);
    const int x = wrap(x0 - hr + i % sw, ns);
    s_d[i] = d[static_cast<size_t>(lo + y) * nr + col0 + x];
  }
  __syncthreads();

  // 2. velocity flags at the source columns, range flags at the candidates
  for (int i = tid; i < kTY * vw; i += kThreads) {
    const int ty = i / vw;
    const int cx = i % vw;
    const float* p = s_d + (hv + ty) * sw + (hr - e + cx);
    s_vf[i] = cfar_flag(p, sw, y0 + ty, nvu, r, g, method, t);
  }
  if (range_detect) {
    for (int i = tid; i < kTY * rw; i += kThreads) {
      const int ty = i / rw;
      const int cx = i % rw;
      const float* p = s_d + (hv + ty) * sw + (hr - 2 * e + cx);
      s_rf[i] = cfar_flag(p, 1, x0 - 2 * e + cx, ns, r, g, method, t);
    }
  }
  __syncthreads();

  // 3. winner offset of every velocity hit (e + 1 = no confirmed neighbour)
  if (range_detect) {
    for (int i = tid; i < kTY * vw; i += kThreads) {
      const int ty = i / vw;
      const int cx = i % vw;
      const int x = x0 - e + cx;
      int best_off = e + 1;
      if (s_vf[i] && x >= 0 && x < ns) {
        const float* row = s_d + (hv + ty) * sw + (hr - e + cx);
        float best = 0.f;
        for (int dd = -e; dd <= e; ++dd) {
          const int c = x + dd;
          if (c < 0 || c >= ns || !s_rf[ty * rw + cx + e + dd]) continue;
          const float v = row[dd];
          if (best_off > e || v > best) {
            best = v;
            best_off = dd;
          }
        }
      }
      s_best[i] = best_off;
    }
    __syncthreads();
  }

  // 4. a cell is flagged when the winner of the source dd cells to its left
  //    chose offset dd
  for (int i = tid; i < kTY * kTX; i += kThreads) {
    const int ty = i / kTX;
    const int tx = i % kTX;
    const int y = y0 + ty;
    const int x = x0 + tx;
    if (y >= nvu || x >= ns) continue;
    const uint8_t vf = s_vf[ty * vw + tx + e];
    uint8_t f = vf;
    if (range_detect) {
      f = 0;
      for (int dd = -e; dd <= e; ++dd) {
        const int src = x - dd;
        if (src >= 0 && src < ns && s_best[ty * vw + tx + e - dd] == dd) f = 1;
      }
    }
    const size_t o = static_cast<size_t>(lo + y) * nr + col0 + x;
    fl[o] = f;
    vfl[o] = vf;
  }

  // 5. the clutter rows outside [lo, lo + nvu) carry no flags
  if (blockIdx.y == 0) {
    const int n_crop = nv - nvu;
    for (int i = tid; i < n_crop * kTX; i += kThreads) {
      const int k = i / kTX;
      const int x = x0 + i % kTX;
      if (x >= ns) continue;
      const int row = k < lo ? k : k + nvu;
      const size_t o = static_cast<size_t>(row) * nr + col0 + x;
      fl[o] = 0;
      vfl[o] = 0;
    }
  }
}

}  // namespace

// Shared-memory bytes one block needs for this configuration.
extern "C" int rsp_cascaded_cfar_smem_bytes(int r, int g, int e) {
  const int sw = kTX + 2 * (2 * e + r + g);
  const int sh = kTY + 2 * (r + g);
  const int vw = kTX + 2 * e;
  const int rw = kTX + 4 * e;
  return static_cast<int>(sizeof(float)) * sh * sw + static_cast<int>(sizeof(int)) * kTY * vw +
         kTY * vw + kTY * rw;
}

// One launch per segment [col0, col0 + ns) of a (batch, nv, nr) f32 RDM;
// flags/vflags are (batch, nv, nr) bytes.  Returns cudaGetLastError().
extern "C" int rsp_cascaded_cfar(const void* rdm, void* flags, void* vflags, int batch,
                                 int nv, int nr, int lo, int nvu, int col0, int ns,
                                 int r, int g, int method, float t, int e,
                                 int range_detect, void* stream) {
  const int smem = rsp_cascaded_cfar_smem_bytes(r, g, e);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cascaded_cfar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((ns + kTX - 1) / kTX, (nvu + kTY - 1) / kTY, batch);
  cascaded_cfar_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rdm), static_cast<uint8_t*>(flags),
      static_cast<uint8_t*>(vflags), nv, nr, lo, nvu, col0, ns, r, g, method, t, e,
      range_detect);
  return static_cast<int>(cudaGetLastError());
}
