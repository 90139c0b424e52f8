/* Host-side staging kernels of astro_sph_tools_tpu_torch (plain C, no
 * dependencies), built at first use with `cc -O3 -shared -fPIC` into the
 * package's `_build/` and loaded with ctypes (`native/__init__.py`).
 *
 * Counterpart: astro_sph_tools_tpu/native/hostops.c. This copy's
 * assignment follows the port's own torch formulation
 * (`ops/deposit_tiled.py::_pixel_coords` and `_multi_level_assign`, which
 * stay as its plain version) bit for bit: pixel coordinates by DIVISION by
 * the pixel size, `torch.remainder`'s fmod-then-add wrap, truncating int32
 * casts clamped into the tile grid. The Morton-delta encoder is the JAX
 * package's, bit for bit with the NumPy formulation in `io/packing.py`.
 */

#include <math.h>
#include <stdint.h>

/* torch.remainder for a positive divisor: fmod, then add the divisor to a
 * non-zero negative remainder (the sum may round up to m itself, as it
 * does in torch). */
static inline double torch_remainder(double a, double m) {
    double r = fmod(a, m);
    if (r != 0.0 && r < 0.0) r += m;
    return r;
}

/* Fused multi-level tile assignment, one pass over the particles.
 *
 * Inputs
 *   x, y        : (n,) f64 world coordinates
 *   h           : (n,) f32 smoothing lengths
 *   x0, y0      : extent origin
 *   psx, psy    : pixel sizes; ps_min the smaller of the two
 *   nx, ny      : map shape (pixels)
 *   periodic    : wrap u/v into [0, nx) and [0, ny)
 *   sfac        : kernel support factor (support = sfac * h)
 *   n_levels    : number of footprint levels
 *   bounds      : (n_levels,) max s_pix per level, < 0 for a disabled level
 *   ntx, nty    : (n_levels,) tile counts along x and y
 *   tw, th      : (n_levels,) tile output width and height in pixels
 *   marg        : (n_levels,) margin M per level
 *   stride      : composite key stride (key = level * stride + tile)
 * Outputs
 *   key         : (n,) i32 composite sort key
 *   u_loc, v_loc: (n,) f32 tile-local pixel coordinates (global pixel
 *                 coordinates for oversize particles)
 */
void assign_tiles_f64(
    const double *x, const double *y, const float *h, int64_t n,
    double x0, double y0, double psx, double psy, double ps_min,
    int64_t nx, int64_t ny, int32_t periodic, double sfac,
    int32_t n_levels, const double *bounds,
    const int32_t *ntx, const int32_t *nty,
    const int32_t *tw, const int32_t *th, const int32_t *marg,
    int64_t stride,
    int32_t *key, float *u_loc, float *v_loc)
{
    for (int64_t i = 0; i < n; i++) {
        double u = (x[i] - x0) / psx;
        double v = (y[i] - y0) / psy;
        if (periodic) {
            u = torch_remainder(u, (double)nx);
            v = torch_remainder(v, (double)ny);
        }
        double s_pix = (sfac * (double)h[i]) / ps_min;
        int32_t level = n_levels;
        for (int32_t l = 0; l < n_levels; l++) {
            if (bounds[l] >= 0.0 && s_pix <= bounds[l]) { level = l; break; }
        }
        if (level < n_levels) {
            /* truncate toward zero as torch's .to(int32) does, after
             * clamping the quotient into the tile grid: the same tile for
             * every quotient inside int32's range, and defined beyond it */
            double qu = u / (double)tw[level];
            double qv = v / (double)th[level];
            if (qu < 0.0) qu = 0.0;
            if (qu > (double)(ntx[level] - 1)) qu = (double)(ntx[level] - 1);
            if (qv < 0.0) qv = 0.0;
            if (qv > (double)(nty[level] - 1)) qv = (double)(nty[level] - 1);
            int32_t ti = (int32_t)qu;
            int32_t tj = (int32_t)qv;
            key[i] = (int32_t)((int64_t)level * stride + (int64_t)tj * ntx[level] + ti);
            u_loc[i] = (float)(u - (double)(ti * tw[level] - marg[level]));
            v_loc[i] = (float)(v - (double)(tj * th[level] - marg[level]));
        } else {
            key[i] = (int32_t)((int64_t)n_levels * stride);
            u_loc[i] = (float)u;
            v_loc[i] = (float)v;
        }
    }
}

/* Fused scale-and-cast: out[i] = (float)(src[i] * scale), one pass. */
void scale_cast_f64(const double *src, int64_t n, double scale, float *out) {
    for (int64_t i = 0; i < n; i++) out[i] = (float)(src[i] * scale);
}

void scale_cast_f32(const float *src, int64_t n, double scale, float *out) {
    for (int64_t i = 0; i < n; i++) out[i] = (float)((double)src[i] * scale);
}

/* Morton-delta position encoding (io/packing.py), one streaming pass.
 *
 * Interleaves (x_q, y_q) into u32 Morton codes and emits per-`seg`-record
 * segments: int16 first differences (delta[0] of each segment = 0, the u32
 * base carries the absolute code) and a sparse exception list for jumps
 * outside int16. An exception stores the correction that the decoder's
 * segmented running sum adds from that record on, relative to the
 * segment's earlier exceptions. The tail of the last segment repeats the
 * final record's code (NumPy's edge padding).
 */
static inline uint32_t spread16(uint32_t v) {
    v = (v | (v << 8)) & 0x00FF00FFu;
    v = (v | (v << 4)) & 0x0F0F0F0Fu;
    v = (v | (v << 2)) & 0x33333333u;
    v = (v | (v << 1)) & 0x55555555u;
    return v;
}

void morton_delta_encode_u16(
    const uint16_t *xq, const uint16_t *yq, int64_t n, int64_t seg,
    int16_t *deltas, uint32_t *bases, int64_t *exc_idx, uint32_t *exc_corr,
    int64_t *n_exc_out)
{
    int64_t n_seg = (n + seg - 1) / seg;
    int64_t ne = 0;
    uint32_t m_prev = 0, m0 = 0, m_last = 0;
    for (int64_t s = 0; s < n_seg; s++) {
        int64_t i0 = s * seg;
        uint32_t cum_corr = 0;
        for (int64_t j = 0; j < seg; j++) {
            int64_t i = i0 + j;
            uint32_t m;
            if (i < n) {
                m = spread16(xq[i]) | (spread16(yq[i]) << 1);
                m_last = m;
            } else {
                m = m_last;
            }
            if (j == 0) {
                bases[s] = m;
                deltas[i0] = 0;
                m0 = m;
            } else {
                int64_t d = (int64_t)m - (int64_t)m_prev;
                if (d >= -32768 && d <= 32767) {
                    deltas[i0 + j] = (int16_t)d;
                    m0 += (uint32_t)(int32_t)d;
                } else {
                    deltas[i0 + j] = 0;
                    uint32_t corr = m - (m0 + cum_corr);
                    exc_idx[ne] = i0 + j;
                    exc_corr[ne] = corr;
                    ne++;
                    cum_corr += corr;
                }
            }
            m_prev = m;
        }
    }
    *n_exc_out = ne;
}
