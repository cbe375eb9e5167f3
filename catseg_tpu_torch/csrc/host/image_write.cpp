// Baseline JPEG encoder at libjpeg's defaults (what the reference library's
// Image.save(".jpg") writes with no options): JFIF, quality 75 (the standard
// tables of ITU-T T.81 Annex K scaled as jpeg_quality_scaling does, forced
// to 8 bits), YCbCr 4:2:0 (colour) or one grey component, libjpeg's
// fixed-point colour conversion (jccolor.c), its h2v2 downsampling with the
// 1, 2, 1, 2 bias (jcsample.c) and its edge replication (jcprepct.c), the
// islow forward DCT (jfdctint.c), libjpeg-turbo's reciprocal quantisation
// (jcdctmgr.c compute_reciprocal / quantize, which rounds as the division
// it replaces), the standard Huffman tables, no restart markers.
//
// A block past a component's width or height (an MCU's dummy block) is
// coded as libjpeg codes it: zero AC, the DC of the block before it.
//
// catseg_jpeg_encode allocates the file with malloc; the caller copies it
// and hands it back to catseg_free.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// zig-zag position -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1 / K.2 quantisation tables, natural order
const int kLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                        14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                        18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                          24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                          99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                          99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 Huffman tables: code counts by length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22,
    0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33,
    0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34,
    0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55,
    0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76,
    0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
    0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4,
    0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1,
    0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13,
    0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62,
    0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29,
    0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
    0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94,
    0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3,
    0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
    0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huff {
    uint16_t code[256];
    uint8_t size[256];
};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes by length
Huff derive(const uint8_t* bits, const uint8_t* vals) {
    Huff h{};
    uint16_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
        for (int i = 0; i < bits[len - 1]; ++i, ++k) {
            h.code[vals[k]] = code++;
            h.size[vals[k]] = (uint8_t)len;
        }
        code <<= 1;
    }
    return h;
}

struct Bits {
    std::vector<uint8_t>& out;
    uint32_t acc = 0;
    int n = 0;

    void put(uint32_t v, int len) {
        acc = (acc << len) | (v & ((1u << len) - 1));
        n += len;
        while (n >= 8) {
            uint8_t b = (uint8_t)(acc >> (n - 8));
            out.push_back(b);
            if (b == 0xFF) out.push_back(0);   // byte stuffing
            n -= 8;
        }
        acc &= (1u << n) - 1;
    }
    void flush() {   // pad the last byte with 1 bits
        if (n > 0) put(0x7F, 8 - n);
    }
};

// jfdctint.c jpeg_fdct_islow (libjpeg 6b scaling: outputs x8)
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* d) {
    for (int r = 0; r < 8; ++r) {
        int32_t* p = d + r * 8;
        int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = (tmp10 + tmp11) << PASS1_BITS;
        p[4] = (tmp10 - tmp11) << PASS1_BITS;
        int32_t z1 = (tmp12 + tmp13) * 4433;
        p[2] = descale(z1 + tmp13 * 6270, CONST_BITS - PASS1_BITS);
        p[6] = descale(z1 + tmp12 * -15137, CONST_BITS - PASS1_BITS);
        z1 = tmp4 + tmp7;
        int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int32_t z5 = (z3 + z4) * 9633;
        tmp4 *= 2446;
        tmp5 *= 16819;
        tmp6 *= 25172;
        tmp7 *= 12299;
        z1 *= -7373;
        z2 *= -20995;
        z3 *= -16069;
        z4 *= -3196;
        z3 += z5;
        z4 += z5;
        p[7] = descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
        p[5] = descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
        p[3] = descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
        p[1] = descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
    }
    for (int c = 0; c < 8; ++c) {
        int32_t* p = d + c;
        int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = descale(tmp10 + tmp11, PASS1_BITS);
        p[32] = descale(tmp10 - tmp11, PASS1_BITS);
        int32_t z1 = (tmp12 + tmp13) * 4433;
        p[16] = descale(z1 + tmp13 * 6270, CONST_BITS + PASS1_BITS);
        p[48] = descale(z1 + tmp12 * -15137, CONST_BITS + PASS1_BITS);
        z1 = tmp4 + tmp7;
        int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int32_t z5 = (z3 + z4) * 9633;
        tmp4 *= 2446;
        tmp5 *= 16819;
        tmp6 *= 25172;
        tmp7 *= 12299;
        z1 *= -7373;
        z2 *= -20995;
        z3 *= -16069;
        z4 *= -3196;
        z3 += z5;
        z4 += z5;
        p[56] = descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
        p[40] = descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
        p[24] = descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
        p[8] = descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
    }
}

// libjpeg-turbo's compute_reciprocal for a 16-bit DCTELEM
struct Divisor {
    uint32_t recip, corr;
    int shift;   // total right shift of (x + corr) * recip
};

int flss(uint32_t v) {
    int b = 0;
    while (v) {
        ++b;
        v >>= 1;
    }
    return b;
}

Divisor reciprocal(uint32_t divisor) {
    if (divisor == 1) return {1, 0, 0};
    int b = flss(divisor) - 1;
    int r = 16 + b;
    uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
    uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        --r;
    } else if (fr <= divisor / 2u) {
        ++c;
    } else {
        ++fq;
    }
    return {fq & 0xFFFF, c & 0xFFFF, r};
}

struct Component {
    int id, h, v, tq, td, ta;   // sampling factors, quant and Huffman table ids
    int wblocks, hblocks;       // blocks that hold samples
    std::vector<uint8_t> plane; // wblocks * 8 x hblocks * 8 samples, edges replicated
};

inline uint8_t at(const std::vector<uint8_t>& p, int stride, int y, int x) { return p[(size_t)y * stride + x]; }

void segment(std::vector<uint8_t>& out, uint8_t marker, const std::vector<uint8_t>& body) {
    out.push_back(0xFF);
    out.push_back(marker);
    size_t n = body.size() + 2;
    out.push_back((uint8_t)(n >> 8));
    out.push_back((uint8_t)n);
    out.insert(out.end(), body.begin(), body.end());
}

void dht(std::vector<uint8_t>& out, int cls_id, const uint8_t* bits, const uint8_t* vals) {
    std::vector<uint8_t> b{(uint8_t)cls_id};
    int n = 0;
    for (int i = 0; i < 16; ++i) {
        b.push_back(bits[i]);
        n += bits[i];
    }
    b.insert(b.end(), vals, vals + n);
    segment(out, 0xC4, b);
}

inline int magnitude(int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
        ++n;
        a >>= 1;
    }
    return n;
}

}  // namespace

extern "C" {

// (H, W, C) uint8, C 1 (grey) or 3 (RGB) -> a baseline JPEG in *out (malloc'd, *size bytes).
// Returns 0, or 1 for an unsupported shape or quality.
int catseg_jpeg_encode(const uint8_t* px, int H, int W, int C, int quality, uint8_t** out_ptr, size_t* out_size) {
    if ((C != 1 && C != 3) || H < 1 || W < 1 || H > 65535 || W > 65535 || quality < 1 || quality > 100) return 1;
    // jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    int q[2][64];
    for (int i = 0; i < 64; ++i) {
        const int* base[2] = {kLumaQ, kChromaQ};
        for (int t = 0; t < 2; ++t) {
            long v = ((long)base[t][i] * scale + 50L) / 100L;
            q[t][i] = v <= 0 ? 1 : v > 255 ? 255 : (int)v;
        }
    }
    const int hmax = C == 3 ? 2 : 1, vmax = hmax;
    std::vector<Component> comps;
    if (C == 3) {
        comps = {{1, 2, 2, 0, 0, 0, 0, 0, {}}, {2, 1, 1, 1, 1, 1, 0, 0, {}}, {3, 1, 1, 1, 1, 1, 0, 0, {}}};
    } else {
        comps = {{1, 1, 1, 0, 0, 0, 0, 0, {}}};
    }
    for (auto& c : comps) {   // jdiv_round_up(image_size * samp, max_samp * 8)
        c.wblocks = (int)(((long)W * c.h + hmax * 8 - 1) / (hmax * 8));
        c.hblocks = (int)(((long)H * c.v + vmax * 8 - 1) / (vmax * 8));
    }
    // colour conversion (jccolor.c rgb_ycc_convert, 16-bit fixed point), on the
    // full-size grid padded to whole sample groups by edge replication
    // (jcprepct.c expand_bottom_edge, jcsample.c expand_right_edge)
    const int Wf = comps[0].wblocks * 8 * hmax / comps[0].h;   // full-size columns the planes need
    const int Wp = comps.size() > 1 ? std::max(Wf, comps[1].wblocks * 8 * 2) : Wf;
    const int Hp = ((H + vmax - 1) / vmax) * vmax;
    std::vector<uint8_t> full[3];
    for (int ci = 0; ci < C; ++ci) full[ci].assign((size_t)Hp * Wp, 0);
    const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    const int32_t yr = fix(0.29900), yg = fix(0.58700), yb = fix(0.11400), cbr = fix(0.16874), cbg = fix(0.33126),
                  half = fix(0.5), crg = fix(0.41869), crb = fix(0.08131);
    for (int y = 0; y < Hp; ++y) {
        const int sy = y < H ? y : H - 1;
        for (int x = 0; x < Wp; ++x) {
            const int sx = x < W ? x : W - 1;
            const uint8_t* p = px + ((size_t)sy * W + sx) * C;
            size_t o = (size_t)y * Wp + x;
            if (C == 1) {
                full[0][o] = p[0];
                continue;
            }
            int32_t r = p[0], g = p[1], b = p[2];
            full[0][o] = (uint8_t)((yr * r + yg * g + (yb * b + ONE_HALF)) >> 16);
            full[1][o] = (uint8_t)((-cbr * r + -cbg * g + (half * b + CBCR_OFFSET + ONE_HALF - 1)) >> 16);
            full[2][o] = (uint8_t)(((half * r + CBCR_OFFSET + ONE_HALF - 1) + -crg * g + -crb * b) >> 16);
        }
    }
    // each component's plane: whole blocks; rows past the last sample row
    // replicate it (jcprepct.c pads each component to its iMCU height)
    for (int ci = 0; ci < (int)comps.size(); ++ci) {
        Component& c = comps[ci];
        const int pw = c.wblocks * 8, ph = c.hblocks * 8;
        c.plane.assign((size_t)pw * ph, 0);
        if (c.h == hmax) {
            for (int y = 0; y < ph; ++y) {
                const int sy = y < Hp ? y : Hp - 1;
                memcpy(&c.plane[(size_t)y * pw], &full[ci][(size_t)sy * Wp], pw);
            }
            continue;
        }
        const int rows = Hp / 2;   // h2v2_downsample, bias 1, 2, 1, 2 along a row
        for (int y = 0; y < ph; ++y) {
            const int sy = y < rows ? y : rows - 1;
            for (int x = 0; x < pw; ++x) {
                const int bias = (x & 1) ? 2 : 1;
                int s = at(full[ci], Wp, 2 * sy, 2 * x) + at(full[ci], Wp, 2 * sy, 2 * x + 1) +
                        at(full[ci], Wp, 2 * sy + 1, 2 * x) + at(full[ci], Wp, 2 * sy + 1, 2 * x + 1);
                c.plane[(size_t)y * pw + x] = (uint8_t)((s + bias) >> 2);
            }
        }
    }
    Divisor div[2][64];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) div[t][i] = reciprocal((uint32_t)q[t][i] << 3);
    const Huff dc[2] = {derive(kDcLumaBits, kDcVals), derive(kDcChromaBits, kDcVals)};
    const Huff ac[2] = {derive(kAcLumaBits, kAcLumaVals), derive(kAcChromaBits, kAcChromaVals)};

    std::vector<uint8_t> f = {0xFF, 0xD8};
    segment(f, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    for (int t = 0; t < (C == 3 ? 2 : 1); ++t) {
        std::vector<uint8_t> b{(uint8_t)t};
        for (int k = 0; k < 64; ++k) b.push_back((uint8_t)q[t][kNatural[k]]);
        segment(f, 0xDB, b);
    }
    std::vector<uint8_t> sof{8, (uint8_t)(H >> 8), (uint8_t)H, (uint8_t)(W >> 8), (uint8_t)W, (uint8_t)C};
    for (auto& c : comps) {
        sof.push_back((uint8_t)c.id);
        sof.push_back((uint8_t)(c.h << 4 | c.v));
        sof.push_back((uint8_t)c.tq);
    }
    segment(f, 0xC0, sof);
    dht(f, 0x00, kDcLumaBits, kDcVals);
    dht(f, 0x10, kAcLumaBits, kAcLumaVals);
    if (C == 3) {
        dht(f, 0x01, kDcChromaBits, kDcVals);
        dht(f, 0x11, kAcChromaBits, kAcChromaVals);
    }
    std::vector<uint8_t> sos{(uint8_t)C};
    for (auto& c : comps) {
        sos.push_back((uint8_t)c.id);
        sos.push_back((uint8_t)(c.td << 4 | c.ta));
    }
    sos.insert(sos.end(), {0, 63, 0});
    segment(f, 0xDA, sos);

    Bits bits{f};
    std::vector<int> pred(comps.size(), 0);
    // an interleaved scan (colour) walks MCUs of hmax x vmax blocks; a single
    // component's scan walks its blocks
    const int mcux = C == 3 ? (W + 15) / 16 : comps[0].wblocks;
    const int mcuy = C == 3 ? (H + 15) / 16 : comps[0].hblocks;
    int32_t blk[64];
    int coef[64];
    for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
            for (int ci = 0; ci < (int)comps.size(); ++ci) {
                const Component& c = comps[ci];
                const int t = ci == 0 ? 0 : 1;
                const int pw = c.wblocks * 8;
                for (int by = 0; by < c.v; ++by) {
                    for (int bx = 0; bx < c.h; ++bx) {
                        const int gx = mx * c.h + bx, gy = my * c.v + by;
                        if (gx < c.wblocks && gy < c.hblocks) {
                            for (int y = 0; y < 8; ++y)
                                for (int x = 0; x < 8; ++x)
                                    blk[y * 8 + x] = (int32_t)at(c.plane, pw, gy * 8 + y, gx * 8 + x) - 128;
                            fdct_islow(blk);
                            for (int i = 0; i < 64; ++i) {
                                int32_t v = (int16_t)blk[i];   // DCTELEM is 16 bits
                                const Divisor& d = div[t][i];
                                const bool neg = v < 0;
                                const uint32_t a = (uint32_t)(neg ? -v : v);
                                const uint32_t r = (uint32_t)(((uint64_t)(a + d.corr) * d.recip) >> d.shift);
                                coef[i] = neg ? -(int)(int16_t)r : (int)(int16_t)r;
                            }
                        } else {   // a dummy block: zero AC, the DC of the block before
                            for (int i = 1; i < 64; ++i) coef[i] = 0;
                            coef[0] = pred[ci];
                        }
                        const int diff = coef[0] - pred[ci];
                        pred[ci] = coef[0];
                        const int ns = magnitude(diff);
                        bits.put(dc[t].code[ns], dc[t].size[ns]);
                        if (ns) bits.put((uint32_t)(diff < 0 ? diff - 1 : diff), ns);
                        int run = 0;
                        for (int k = 1; k < 64; ++k) {
                            const int v = coef[kNatural[k]];
                            if (v == 0) {
                                ++run;
                                continue;
                            }
                            while (run > 15) {
                                bits.put(ac[t].code[0xF0], ac[t].size[0xF0]);
                                run -= 16;
                            }
                            const int nb = magnitude(v);
                            const int sym = (run << 4) | nb;
                            bits.put(ac[t].code[sym], ac[t].size[sym]);
                            bits.put((uint32_t)(v < 0 ? v - 1 : v), nb);
                            run = 0;
                        }
                        if (run > 0) bits.put(ac[t].code[0], ac[t].size[0]);
                    }
                }
            }
        }
    }
    bits.flush();
    f.push_back(0xFF);
    f.push_back(0xD9);
    *out_ptr = (uint8_t*)malloc(f.size());
    if (!*out_ptr) return 2;
    memcpy(*out_ptr, f.data(), f.size());
    *out_size = f.size();
    return 0;
}

void catseg_free(void* p) { free(p); }

}  // extern "C"
