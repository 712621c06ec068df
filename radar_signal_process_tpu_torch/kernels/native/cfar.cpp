// Native single-pass cascaded 2-D CFAR for CPU hosts (transposed layout).
//
// CPU counterpart of kernels/cfar_pallas.py: XLA CPU streams ~9.6 GB of
// HBM traffic per G2 frame through the split-executable cascade because
// every roll/compare pass re-touches memory; this kernel computes the same
// flags in one pass over a ~4 MB working set per RDM (renotched crop +
// flag planes), BIT-IDENTICAL to ops/cfar.py's split form
// (segmented_cfar_flags + segmented_cfar_select, transposed=True).
//
// Parity contract (CLAUDE.md "the CFAR implementations share the exact
// summation order" — this is the fourth implementation in lockstep):
//  * reference sums accumulate j = 0..r-1 AWAY from the cell, exactly as
//    ops/cfar.py::_ref_level_padded: left = u[y-(g+1)] + u[y-(g+2)] + ...,
//    right = u[y+(g+r)] + u[y+(g+r-1)] + ...; means divide by float(r);
//  * out-of-range loads read 0.0f (the padded-buffer semantics); window
//    validity falls back to the opposite side's mean;
//  * the zero-velocity re-notch multiplies by a 0/1 mask (fun_0v_pressing
//    semantics via Python-built column mask), and the cascade selection
//    consumes the RENOTCHED amplitudes, as the jitted split does;
//  * ext==1 uses the branch-free flag-gated comparison form; general ext
//    uses the strict-> running-argmax (first maximum wins).
// Compiled with -ffp-contract=off: the float ops are adds/divides/compares
// with no fusable mul+add, but contraction is disabled anyway so the
// binary can never drift from the XLA scalar sequence.
//
// Reference semantics: CFAR_WangCai/Function_CFAR1D_sub.m:17-68 (1-D
// CA-CFAR with edge fallback), executeCFAR.m:21-92 (velocity-then-range
// cascade, strongest confirmed neighbor), main_cfar.m:142-161 (per-pulse-
// segment split).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>

namespace {

// 1-D CA-CFAR flags along the CONTIGUOUS axis (velocity in the transposed
// layout): one row of nvu cells, local-index validity.  The window sums
// accumulate k = 0..r-1 in the lockstep order via shifted contiguous adds
// over a zero-padded copy of the row (SIMD-friendly: the inner j loops are
// plain vector adds with constant offsets; skipping a zero term would be
// exact too, but the padded adds mirror _ref_level_padded literally).
// scratch: pad (n + 2*(g+r)) floats, lacc/racc n floats each.
void cfar_row_contig(const float* u, int n, int r, int g, int method,
                     float t, uint8_t* out, float* pad, float* lacc,
                     float* racc) {
    const int P = g + r;
    const float fr = (float)r;
    for (int i = 0; i < P; ++i) pad[i] = 0.0f;
    memcpy(pad + P, u, (size_t)n * sizeof(float));
    for (int i = 0; i < P; ++i) pad[P + n + i] = 0.0f;
    const float* c = pad + P;                 // c[i] valid for i in [-P, n+P)
    // left: u[j-(g+1)] first, then j-(g+2) ... j-(g+r)
    {
        const float* s = c - (g + 1);
        for (int j = 0; j < n; ++j) lacc[j] = s[j];
        for (int k = 1; k < r; ++k) {
            const float* sk = c - (g + 1) - k;
            for (int j = 0; j < n; ++j) lacc[j] += sk[j];
        }
    }
    // right: u[j+(g+r)] first, then descending to j+(g+1)
    {
        const float* s = c + g + r;
        for (int j = 0; j < n; ++j) racc[j] = s[j];
        for (int k = 1; k < r; ++k) {
            const float* sk = c + g + r - k;
            for (int j = 0; j < n; ++j) racc[j] += sk[j];
        }
    }
    for (int j = 0; j < n; ++j) {
        const float left_mean = lacc[j] / fr;
        const float right_mean = racc[j] / fr;
        const bool left_valid = j - (g + r) >= 0;
        const bool right_valid = j + (g + r) <= n - 1;
        const float left_used = left_valid ? left_mean : right_mean;
        const float right_used = right_valid ? right_mean : left_mean;
        const float ref = method == 0
            ? (left_used >= right_used ? left_used : right_used)
            : (left_used <= right_used ? left_used : right_used);
        out[j] = u[j] >= ref * t ? 1 : 0;
    }
}

}  // namespace

extern "C" int rsp_cfar_cascade_t(
    const float* rdm,               // (n_r, n_v) row-major magnitudes
    int n_r, int n_v, int n_clutter,
    const uint8_t* notch_mask,      // per-velocity-column, 1 = zero; or NULL
    int rv, int gv, int mv, float tv,
    int rr, int gr, int mr, float tr,
    int range_detect, int ext,
    const int* segs, int n_segs,    // (start, stop) pairs over the row axis
    uint8_t* flags, uint8_t* vflags  // (n_r, n_v) outputs, fully written
) {
    const int lo = n_clutter + 1, hi = n_v - n_clutter;
    const int nvu = hi - lo;
    if (nvu <= 0 || n_r <= 0 || rv < 1 || rr < 1 || ext < 0 || n_segs < 1)
        return 1;

    const size_t plane = (size_t)n_r * (size_t)nvu;
    float* u = (float*)malloc(plane * sizeof(float));
    uint8_t* vf = (uint8_t*)malloc(plane);
    uint8_t* rf = range_detect ? (uint8_t*)malloc(plane) : nullptr;
    // cascade scratch: ext==1 uses three scatter planes; general ext uses
    // winner + best-offset planes
    uint8_t* s0 = (uint8_t*)malloc(plane);
    uint8_t* s1 = (uint8_t*)malloc(plane);
    uint8_t* s2 = (uint8_t*)malloc(plane);
    int8_t* boff = (int8_t*)malloc(plane);
    // row-pass scratch: padded row + two accumulator rows
    float* rowpad = (float*)malloc(
        ((size_t)nvu + 2 * (size_t)(gv + rv)) * sizeof(float));
    float* lacc = (float*)malloc((size_t)nvu * sizeof(float));
    float* racc = (float*)malloc((size_t)nvu * sizeof(float));
    float* zrow = (float*)calloc((size_t)nvu, sizeof(float));
    uint8_t* zrow8 = (uint8_t*)calloc((size_t)nvu, 1);
    if (!u || !vf || (range_detect && !rf) || !s0 || !s1 || !s2 || !boff ||
        !rowpad || !lacc || !racc || !zrow || !zrow8) {
        free(u); free(vf); free(rf); free(s0); free(s1); free(s2); free(boff);
        free(rowpad); free(lacc); free(racc); free(zrow); free(zrow8);
        return 2;
    }

    // renotched used crop (multiply by the 0/1 mask, as rdm * mask does)
    for (int y = 0; y < n_r; ++y) {
        const float* src = rdm + (size_t)y * n_v + lo;
        float* dst = u + (size_t)y * nvu;
        if (notch_mask) {
            const uint8_t* m = notch_mask + lo;
            for (int j = 0; j < nvu; ++j)
                dst[j] = src[j] * (m[j] ? 0.0f : 1.0f);
        } else {
            memcpy(dst, src, (size_t)nvu * sizeof(float));
        }
    }

    // velocity-dim CFAR: contiguous within each row
    for (int y = 0; y < n_r; ++y)
        cfar_row_contig(u + (size_t)y * nvu, nvu, rv, gv, mv, tv,
                        vf + (size_t)y * nvu, rowpad, lacc, racc);

    memset(flags, 0, (size_t)n_r * n_v);
    memset(vflags, 0, (size_t)n_r * n_v);
    for (int y = 0; y < n_r; ++y)
        for (int j = 0; j < nvu; ++j)
            vflags[(size_t)y * n_v + lo + j] = vf[(size_t)y * nvu + j];

    if (!range_detect) {
        for (int y = 0; y < n_r; ++y)
            memcpy(flags + (size_t)y * n_v,
                   vflags + (size_t)y * n_v, (size_t)n_v);
        free(u); free(vf); free(rf); free(s0); free(s1); free(s2); free(boff);
        free(rowpad); free(lacc); free(racc); free(zrow); free(zrow8);
        return 0;
    }

    // range-dim CFAR per segment: sliding window DOWN the rows, local-row
    // validity.  Column-vectorized: each window term is one contiguous
    // row-add (k = 0..r-1 in the lockstep order); out-of-segment terms are
    // zero rows and skipping them is exact (all partial sums of finite
    // terms; a skipped +0.0f can only flip -0 to +0, and -0 == +0 in the
    // compare either way).
    const float frr = (float)rr;
    for (int s = 0; s < n_segs; ++s) {
        const int y0 = segs[2 * s], y1 = segs[2 * s + 1];
        const int nloc = y1 - y0;
        for (int y = y0; y < y1; ++y) {
            const int yy = y - y0;
            const bool left_valid = yy - (gr + rr) >= 0;
            const bool right_valid = yy + (gr + rr) <= nloc - 1;
            uint8_t* out = rf + (size_t)y * nvu;
            const float* uy = u + (size_t)y * nvu;
            bool l_init = false, r_init = false;
            for (int k = 0; k < rr; ++k) {
                const int ya = yy - (gr + 1) - k;         // j=0..r-1 away
                if (ya >= 0 && ya < nloc) {
                    const float* row = u + (size_t)(y0 + ya) * nvu;
                    if (!l_init) {
                        memcpy(lacc, row, (size_t)nvu * sizeof(float));
                        l_init = true;
                    } else {
                        for (int j = 0; j < nvu; ++j) lacc[j] += row[j];
                    }
                }
                const int yb = yy + gr + rr - k;
                if (yb >= 0 && yb < nloc) {
                    const float* row = u + (size_t)(y0 + yb) * nvu;
                    if (!r_init) {
                        memcpy(racc, row, (size_t)nvu * sizeof(float));
                        r_init = true;
                    } else {
                        for (int j = 0; j < nvu; ++j) racc[j] += row[j];
                    }
                }
            }
            if (!l_init) memset(lacc, 0, (size_t)nvu * sizeof(float));
            if (!r_init) memset(racc, 0, (size_t)nvu * sizeof(float));
            for (int j = 0; j < nvu; ++j) {
                const float left_mean = lacc[j] / frr;
                const float right_mean = racc[j] / frr;
                const float left_used = left_valid ? left_mean : right_mean;
                const float right_used = right_valid ? right_mean : left_mean;
                const float ref = mr == 0
                    ? (left_used >= right_used ? left_used : right_used)
                    : (left_used <= right_used ? left_used : right_used);
                out[j] = uy[j] >= ref * tr ? 1 : 0;
            }
        }
    }

    // cascade selection per segment along the rows
    for (int s = 0; s < n_segs; ++s) {
        const int y0 = segs[2 * s], y1 = segs[2 * s + 1];
        const int nloc = y1 - y0;
        if (ext == 1) {
            // branch-free flag-gated form (ops/cfar.py ext==1 fast path):
            // s0/s1/s2 = winner&take_{-1,0,+1}; out[y] = s0[y+1]|s1[y]|s2[y-1]
            for (int y = y0; y < y1; ++y) {
                const int yy = y - y0;
                const float* v0r = u + (size_t)y * nvu;
                const float* vm = yy > 0 ? u + (size_t)(y - 1) * nvu : zrow;
                const float* vp =
                    yy < nloc - 1 ? u + (size_t)(y + 1) * nvu : zrow;
                const uint8_t* f0r = rf + (size_t)y * nvu;
                const uint8_t* fm =
                    yy > 0 ? rf + (size_t)(y - 1) * nvu : zrow8;
                const uint8_t* fp =
                    yy < nloc - 1 ? rf + (size_t)(y + 1) * nvu : zrow8;
                const uint8_t* vfy = vf + (size_t)y * nvu;
                uint8_t* a = s0 + (size_t)y * nvu;
                uint8_t* b = s1 + (size_t)y * nvu;
                uint8_t* c = s2 + (size_t)y * nvu;
                for (int j = 0; j < nvu; ++j) {
                    const uint8_t f_m1 = fm[j];
                    const uint8_t f_0 = f0r[j];
                    const uint8_t f_p1 = fp[j];
                    const float v_m1 = vm[j];
                    const float v_0 = v0r[j];
                    const float v_p1 = vp[j];
                    const uint8_t winner = vfy[j] & (f_m1 | f_0 | f_p1);
                    const uint8_t ge_m1_0 =
                        (uint8_t)(v_m1 >= v_0) | (uint8_t)(!f_0);
                    const uint8_t ge_m1_p1 =
                        (uint8_t)(v_m1 >= v_p1) | (uint8_t)(!f_p1);
                    const uint8_t ge_0_p1 =
                        (uint8_t)(v_0 >= v_p1) | (uint8_t)(!f_p1);
                    const uint8_t take_m1 = f_m1 & ge_m1_0 & ge_m1_p1;
                    const uint8_t take_0 =
                        (uint8_t)(!take_m1) & f_0 & ge_0_p1;
                    const uint8_t take_p1 =
                        (uint8_t)(!take_m1) & (uint8_t)(!take_0) & f_p1;
                    a[j] = winner & take_m1;
                    b[j] = winner & take_0;
                    c[j] = winner & take_p1;
                }
            }
            for (int y = y0; y < y1; ++y) {
                const int yy = y - y0;
                const uint8_t* a_next =
                    yy < nloc - 1 ? s0 + (size_t)(y + 1) * nvu : zrow8;
                const uint8_t* b_here = s1 + (size_t)y * nvu;
                const uint8_t* c_prev =
                    yy > 0 ? s2 + (size_t)(y - 1) * nvu : zrow8;
                uint8_t* out = flags + (size_t)y * n_v + lo;
                for (int j = 0; j < nvu; ++j)
                    out[j] = a_next[j] | b_here[j] | c_prev[j];
            }
        } else {
            // general neighborhood: strict-> running argmax (first max
            // wins), then receive-side scatter.  s0 holds the winner plane.
            const float neg_inf = -std::numeric_limits<float>::infinity();
            for (int y = y0; y < y1; ++y) {
                const int yy = y - y0;
                const uint8_t* vfy = vf + (size_t)y * nvu;
                uint8_t* win = s0 + (size_t)y * nvu;
                int8_t* bo = boff + (size_t)y * nvu;
                for (int j = 0; j < nvu; ++j) {
                    float best = neg_inf;
                    int8_t off = 0;
                    for (int d = -ext; d <= ext; ++d) {
                        const int yd = yy + d;
                        const bool fd =
                            (yd >= 0 && yd < nloc) &&
                            rf[(size_t)(y0 + yd) * nvu + j];
                        const float vd = fd
                            ? u[(size_t)(y0 + yd) * nvu + j] : neg_inf;
                        if (vd > best) { best = vd; off = (int8_t)d; }
                    }
                    win[j] = vfy[j] && best > neg_inf;
                    bo[j] = off;
                }
            }
            for (int y = y0; y < y1; ++y) {
                const int yy = y - y0;
                uint8_t* out = flags + (size_t)y * n_v + lo;
                for (int j = 0; j < nvu; ++j) {
                    uint8_t m = 0;
                    for (int d = -ext; d <= ext && !m; ++d) {
                        const int ys = yy - d;  // winner at y-d chose d
                        if (ys >= 0 && ys < nloc &&
                            s0[(size_t)(y0 + ys) * nvu + j] &&
                            boff[(size_t)(y0 + ys) * nvu + j] == d)
                            m = 1;
                    }
                    out[j] = m;
                }
            }
        }
    }

    free(u); free(vf); free(rf); free(s0); free(s1); free(s2); free(boff);
    free(rowpad); free(lacc); free(racc); free(zrow); free(zrow8);
    return 0;
}
