// Pillow-exact uint8 bilinear and bicubic resizes (Resample.c
// precompute_coeffs, normalize_coeffs_8bpc, ImagingResampleHorizontal_8bpc /
// Vertical_8bpc), the C++ twins of catseg_tpu_torch/data/resize.py
// resize_bilinear_u8 / resize_bicubic_u8, whose numpy versions stay the
// specification the tests hold these to.
//
// A filter of support s * max(in / out, 1) (triangle: s = 1; Keys cubic with
// a = -0.5: s = 2); output i's window starts at int(center - support + 0.5)
// (>= 0) and ends at int(center + support + 0.5) (<= in), center = (i + 0.5)
// * in / out; weights normalised by their sequential double sum and made
// int(+-0.5 + w * 2^22); sums start at 2^21, shift right by 22, clip to
// uint8.  Horizontal pass first (clipped to uint8), then vertical; an axis
// whose size does not change is not touched.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int PRECISION_BITS = 22;

double triangle(double x) {
    if (x < 0.0) x = -x;
    return x < 1.0 ? 1.0 - x : 0.0;
}

// Pillow's bicubic_filter, a = -0.5, its operations in its order
double cubic(double x) {
    const double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
    if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
    return 0.0;
}

struct Filter {
    double (*fn)(double);
    double support;
};

struct Coeffs {
    int ksize = 0;
    std::vector<int> xmin, n;
    std::vector<int32_t> k;  // out * ksize
};

Coeffs coeffs(int in_size, int out_size, Filter f) {
    Coeffs c;
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = f.support * filterscale;
    c.ksize = (int)std::ceil(support) * 2 + 1;
    c.xmin.resize(out_size);
    c.n.resize(out_size);
    c.k.assign((size_t)out_size * c.ksize, 0);
    std::vector<double> w(c.ksize);
    double ss = 1.0 / filterscale;
    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double ww = 0.0;
        for (int x = 0; x < xmax; ++x) {
            w[x] = f.fn((x + xmin - center + 0.5) * ss);
            ww += w[x];
        }
        for (int x = 0; x < xmax; ++x) {
            double v = ww != 0.0 ? w[x] / ww : w[x];
            c.k[(size_t)xx * c.ksize + x] = (int32_t)(v < 0 ? -0.5 + v * (1 << PRECISION_BITS)
                                                            : 0.5 + v * (1 << PRECISION_BITS));
        }
        c.xmin[xx] = xmin;
        c.n[xx] = xmax;
    }
    return c;
}

inline uint8_t clip8(int32_t v) {
    v >>= PRECISION_BITS;
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void horizontal(const uint8_t* in, int H, int W, int C, uint8_t* out, int w, Filter f) {
    Coeffs c = coeffs(W, w, f);
    for (int y = 0; y < H; ++y) {
        const uint8_t* row = in + (size_t)y * W * C;
        uint8_t* o = out + (size_t)y * w * C;
        for (int xx = 0; xx < w; ++xx) {
            const int32_t* k = &c.k[(size_t)xx * c.ksize];
            const uint8_t* p = row + (size_t)c.xmin[xx] * C;
            for (int ch = 0; ch < C; ++ch) {
                int32_t s = 1 << (PRECISION_BITS - 1);
                for (int x = 0; x < c.n[xx]; ++x) s += p[x * C + ch] * k[x];
                o[xx * C + ch] = clip8(s);
            }
        }
    }
}

void vertical(const uint8_t* in, int H, int W, int C, uint8_t* out, int h, Filter f) {
    Coeffs c = coeffs(H, h, f);
    const size_t rowlen = (size_t)W * C;
    std::vector<int32_t> acc(rowlen);
    for (int yy = 0; yy < h; ++yy) {
        const int32_t* k = &c.k[(size_t)yy * c.ksize];
        std::fill(acc.begin(), acc.end(), 1 << (PRECISION_BITS - 1));
        for (int y = 0; y < c.n[yy]; ++y) {
            const uint8_t* row = in + (size_t)(c.xmin[yy] + y) * rowlen;
            const int32_t ky = k[y];
            for (size_t i = 0; i < rowlen; ++i) acc[i] += row[i] * ky;
        }
        uint8_t* o = out + (size_t)yy * rowlen;
        for (size_t i = 0; i < rowlen; ++i) o[i] = clip8(acc[i]);
    }
}

int resize_u8(const uint8_t* in, int H, int W, int C, uint8_t* out, int h, int w, Filter f) {
    if (W == w && H == h) {
        memcpy(out, in, (size_t)H * W * C);
        return 0;
    }
    if (H == h) {
        horizontal(in, H, W, C, out, w, f);
        return 0;
    }
    if (W == w) {
        vertical(in, H, W, C, out, h, f);
        return 0;
    }
    std::vector<uint8_t> tmp((size_t)H * w * C);
    horizontal(in, H, W, C, tmp.data(), w, f);
    vertical(tmp.data(), H, w, C, out, h, f);
    return 0;
}

}  // namespace

extern "C" {

// (H, W, C) uint8 -> (h, w, C) uint8, Image.resize(BILINEAR).
int catseg_resize_bilinear_u8(const uint8_t* in, int H, int W, int C, uint8_t* out, int h, int w) {
    return resize_u8(in, H, W, C, out, h, w, Filter{triangle, 1.0});
}

// (H, W, C) uint8 -> (h, w, C) uint8, Image.resize(BICUBIC).
int catseg_resize_bicubic_u8(const uint8_t* in, int H, int W, int C, uint8_t* out, int h, int w) {
    return resize_u8(in, H, W, C, out, h, w, Filter{cubic, 2.0});
}

}  // extern "C"
