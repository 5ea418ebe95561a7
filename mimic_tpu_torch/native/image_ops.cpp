// Native image resize for the host input pipeline.
//
// Bit-exact reimplementation of PIL's BILINEAR and BICUBIC resampling for
// uint8 RGB images (Pillow src/libImaging/Resample.c): a separable filter
// convolution with support scaled by the downscale factor, coefficients
// quantized to fixed point (PRECISION_BITS), horizontal pass then vertical
// pass, each rounding back to uint8.  Bit-exactness lets the Python PIL path
// serve as the correctness oracle in tests while this path removes the PIL
// dependency from the hot loop (reference analog: the torch DataLoader's
// native PIL decode/resize workers).
//
// Exposed via ctypes (no pybind11 in this environment).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;

inline uint8_t clip8(int in) {
    int v = in >> PRECISION_BITS;
    if (v < 0) return 0;
    if (v > 255) return 255;
    return (uint8_t)v;
}

inline double bilinear_filter(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

// PIL bicubic (Catmull-Rom with a = -0.5), support 2.0
inline double bicubic_filter(double x) {
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

typedef double (*filter_fn)(double);

inline filter_fn pick_filter(int mode, double& support) {
    if (mode == 1) { support = 2.0; return bicubic_filter; }
    support = 1.0;
    return bilinear_filter;
}

// PIL precompute_coeffs: per output index, the window [bound, bound+count)
// into the input and the normalized filter weights.
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<double>& kk, int mode) {
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double base_support;
    filter_fn filt = pick_filter(mode, base_support);
    double support = base_support * filterscale;
    int ksize = (int)ceil(support) * 2 + 1;

    kk.assign((size_t)out_size * ksize, 0.0);
    bounds.assign((size_t)out_size * 2, 0);

    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &kk[(size_t)xx * ksize];
        int x;
        for (x = 0; x < xmax; x++) {
            double w = filt((x + xmin - center + 0.5) * ss) * ss;
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) k[x] /= ww;
        }
        for (; x < ksize; x++) k[x] = 0.0;
        bounds[(size_t)xx * 2 + 0] = xmin;
        bounds[(size_t)xx * 2 + 1] = xmax;
    }
    return ksize;
}

// PIL normalize_coeffs_8bpc
void quantize_coeffs(const std::vector<double>& prekk, std::vector<int>& kk) {
    kk.resize(prekk.size());
    for (size_t i = 0; i < prekk.size(); i++) {
        double w = prekk[i];
        kk[i] = w < 0 ? (int)(-0.5 + w * (1 << PRECISION_BITS))
                      : (int)(0.5 + w * (1 << PRECISION_BITS));
    }
}

}  // namespace

extern "C" {

// src: [sh, sw, 3] uint8 RGB, row-major.  dst: [dh, dw, 3] uint8.
// mode: 0 = bilinear, 1 = bicubic (both PIL-bit-exact).
// Returns 0 on success, -1 on invalid arguments.
int resize_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
              int dh, int dw, int mode) {
    if (!src || !dst || sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0) return -1;
    if (sh == dh && sw == dw) {
        memcpy(dst, src, (size_t)sh * sw * 3);
        return 0;
    }

    std::vector<int> bounds_h, bounds_v;
    std::vector<double> prekk;
    std::vector<int> kk_h, kk_v;
    int ksize_h = precompute_coeffs(sw, dw, bounds_h, prekk, mode);
    quantize_coeffs(prekk, kk_h);
    int ksize_v = precompute_coeffs(sh, dh, bounds_v, prekk, mode);
    quantize_coeffs(prekk, kk_v);

    // horizontal pass: [sh, sw, 3] -> [sh, dw, 3]
    std::vector<uint8_t> tmp((size_t)sh * dw * 3);
    for (int y = 0; y < sh; y++) {
        const uint8_t* srow = src + (size_t)y * sw * 3;
        uint8_t* trow = &tmp[(size_t)y * dw * 3];
        for (int x = 0; x < dw; x++) {
            int xmin = bounds_h[(size_t)x * 2 + 0];
            int xcount = bounds_h[(size_t)x * 2 + 1];
            const int* k = &kk_h[(size_t)x * ksize_h];
            for (int c = 0; c < 3; c++) {
                int ss = 1 << (PRECISION_BITS - 1);
                for (int i = 0; i < xcount; i++) {
                    ss += srow[(size_t)(xmin + i) * 3 + c] * k[i];
                }
                trow[(size_t)x * 3 + c] = clip8(ss);
            }
        }
    }

    // vertical pass: [sh, dw, 3] -> [dh, dw, 3]
    for (int y = 0; y < dh; y++) {
        int ymin = bounds_v[(size_t)y * 2 + 0];
        int ycount = bounds_v[(size_t)y * 2 + 1];
        const int* k = &kk_v[(size_t)y * ksize_v];
        uint8_t* drow = dst + (size_t)y * dw * 3;
        for (int x = 0; x < dw; x++) {
            for (int c = 0; c < 3; c++) {
                int ss = 1 << (PRECISION_BITS - 1);
                for (int i = 0; i < ycount; i++) {
                    ss += tmp[(size_t)(ymin + i) * dw * 3 + (size_t)x * 3 + c] * k[i];
                }
                drow[(size_t)x * 3 + c] = clip8(ss);
            }
        }
    }
    return 0;
}

// Back-compat alias (mode 0).
int resize_bilinear_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                       int dh, int dw) {
    return resize_u8(src, sh, sw, dst, dh, dw, 0);
}

// Fused resize + rescale(1/255) + per-channel normalize into float32 output.
// mean/stdv: 3 floats each.  Resize is the bit-exact uint8 path above, so the
// result equals normalize(resize(src)) of the Python pipeline exactly.
int resize_normalize_f32(const uint8_t* src, int sh, int sw, float* dst,
                         int dh, int dw, const float* mean, const float* stdv) {
    if (!dst || !mean || !stdv) return -1;
    std::vector<uint8_t> resized((size_t)dh * dw * 3);
    int rc = resize_u8(src, sh, sw, resized.data(), dh, dw, 0);
    if (rc != 0) return rc;
    float inv_std[3], off[3];
    for (int c = 0; c < 3; c++) {
        inv_std[c] = 1.0f / stdv[c];
        off[c] = mean[c];
    }
    size_t n = (size_t)dh * dw;
    for (size_t i = 0; i < n; i++) {
        for (int c = 0; c < 3; c++) {
            float v = resized[i * 3 + c] / 255.0f;
            dst[i * 3 + c] = (v - off[c]) * inv_std[c];
        }
    }
    return 0;
}

}  // extern "C"
