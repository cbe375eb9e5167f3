// Host image decoding for the data path: JPEG (baseline and progressive
// Huffman) and PNG row unfiltering, bound through ctypes
// (catseg_tpu_torch/data/image_io.py).
//
// The JPEG decoder reproduces libjpeg's default decompression bit for bit:
//   - Huffman decoding of sequential (jdhuff.c) and progressive (jdphuff.c)
//     scans, restart markers included;
//   - the ISLOW integer IDCT (jidctint.c jpeg_idct_islow, CONST_BITS 13,
//     PASS1_BITS 2) with its output clamp to [0, 255];
//   - fancy upsampling (jdsample.c): h2v1 and h2v2 triangle filters with
//     their alternating rounding biases, h1v2, edge samples replicated at the
//     component's downsampled size; plain replication for other integral
//     factors and for h2 components two samples wide or less;
//   - jdcolor.c ycc_rgb_convert's fixed-point tables (SCALEBITS 16).
// What libjpeg would decode differently is refused (return code 1):
// arithmetic coding, 12-bit samples, lossless and hierarchical frames,
// 2- and 4-component (CMYK / YCCK) images, fractional sampling ratios, and a
// progressive file that leaves a coefficient never fully sent (libjpeg's
// block smoothing, jdcoefct.c decompress_smooth_data, would then change
// pixels).  EXIF orientation is not applied.
//
// Every entry point returns 0 on success, 1 for an unsupported feature and
// 2 for a malformed file, with a message in ``err``.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Unsupported {
    std::string what;
};
struct Corrupt {
    std::string what;
};

// zigzag index -> natural (row-major) index, with 16 guard entries as in
// libjpeg's jpeg_natural_order (a corrupt run may step past 63)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
    bool defined = false;
    uint8_t vals[256] = {};
    int max_val = 0;
    int maxcode[18] = {};
    int valoffset[18] = {};
    // 9-bit lookahead: (length << 8) | value, 0 where the code is longer
    uint16_t look[1 << 9] = {};

    void build(const uint8_t* counts, const uint8_t* values, int nvals) {
        memcpy(vals, values, nvals);
        max_val = 0;
        for (int i = 0; i < nvals; ++i) max_val = std::max(max_val, (int)values[i]);
        int code = 0, k = 0;
        int huffsize[257], huffcode[257];
        for (int l = 1; l <= 16; ++l)
            for (int i = 0; i < counts[l - 1]; ++i) huffsize[k++] = l;
        huffsize[k] = 0;
        int n = k;
        k = 0;
        int si = huffsize[0];
        while (k < n && huffsize[k]) {
            while (huffsize[k] == si) huffcode[k++] = code++;
            if (code >= (1 << si)) throw Corrupt{"bad Huffman table"};
            code <<= 1;
            ++si;
        }
        k = 0;
        for (int l = 1; l <= 16; ++l) {
            if (counts[l - 1]) {
                valoffset[l] = k - huffcode[k];
                k += counts[l - 1];
                maxcode[l] = huffcode[k - 1];
            } else {
                maxcode[l] = -1;
            }
        }
        maxcode[17] = 0x7fffffff;
        memset(look, 0, sizeof(look));
        k = 0;
        for (int l = 1; l <= 9; ++l) {
            for (int i = 0; i < counts[l - 1]; ++i, ++k) {
                int base = huffcode[k] << (9 - l);
                for (int j = 0; j < (1 << (9 - l)); ++j)
                    look[base + j] = (uint16_t)((l << 8) | vals[k]);
            }
        }
        defined = true;
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;          // blocks stored (MCU-padded)
    int dw = 0, dh = 0;          // downsampled size in samples
    std::vector<int16_t> coefs;  // bw * bh * 64, natural order
    int qt[64] = {};             // quantisation table latched at the first scan
    bool latched = false;
    int coef_bits[64];           // progressive: bits still to come (-1 never sent)
    int dc_tbl = 0, ac_tbl = 0, pred = 0;
};

// MSB-first bit reader over one scan's entropy-coded segment.  At a marker
// (or the end) it feeds zero bits, as libjpeg does.
struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t buf = 0;
    int cnt = 0;
    bool at_marker = false;

    void fill() {
        while (cnt <= 56) {
            uint64_t b = 0;
            if (!at_marker && p < end) {
                if (*p == 0xFF) {
                    if (p + 1 < end && p[1] == 0x00) {
                        b = 0xFF;
                        p += 2;
                    } else {
                        at_marker = true;
                    }
                } else {
                    b = *p++;
                }
            }
            buf |= b << (56 - cnt);
            cnt += 8;
        }
    }
    int bits(int n) {
        if (n == 0) return 0;
        if (cnt < n) fill();
        int v = (int)(buf >> (64 - n));
        buf <<= n;
        cnt -= n;
        return v;
    }
    int bit() { return bits(1); }
    int decode(const Huffman& t) {
        if (cnt < 16) fill();
        int e = t.look[buf >> (64 - 9)];
        if (e) {
            int l = e >> 8;
            buf <<= l;
            cnt -= l;
            return e & 0xFF;
        }
        int l = 10;
        int code = (int)(buf >> (64 - l));
        while (l <= 16 && code > t.maxcode[l]) {
            ++l;
            code = (int)(buf >> (64 - l));
        }
        if (l > 16) {  // corrupt data: libjpeg warns and returns 0
            buf <<= 16;
            cnt -= 16;
            return 0;
        }
        buf <<= l;
        cnt -= l;
        return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
    // restart: drop the buffered bits, step over the RSTn marker
    void restart() {
        buf = 0;
        cnt = 0;
        while (p < end && !(p[0] == 0xFF && p + 1 < end && p[1] >= 0xD0 && p[1] <= 0xD7)) ++p;
        if (p < end) p += 2;
        at_marker = false;
    }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v; }

struct Jpeg {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;
    int width = 0, height = 0, ncomp = 0;
    bool progressive = false;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    Component comp[4];
    int qt[4][64] = {};
    bool qt_defined[4] = {};
    Huffman dc[4], ac[4];
    int restart_interval = 0;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    bool frame = false;

    Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {}

    int u8() {
        if (pos >= size) throw Corrupt{"unexpected end of file"};
        return data[pos++];
    }
    int u16() {
        int a = u8();
        return (a << 8) | u8();
    }

    int next_marker() {
        // skip to 0xFF, then over fill bytes
        while (pos < size && data[pos] != 0xFF) ++pos;
        while (pos < size && data[pos] == 0xFF) ++pos;
        if (pos >= size) throw Corrupt{"no EOI marker"};
        return data[pos++];
    }

    void read_header_only() {
        if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) throw Corrupt{"not a JPEG file"};
        pos = 2;
        for (;;) {
            int m = next_marker();
            if (is_sof(m)) {
                read_sof(m);
                return;
            }
            if (m == 0xD9) throw Corrupt{"no frame header"};
            skip_segment();
        }
    }

    static bool is_sof(int m) {
        return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
    }

    void skip_segment() {
        int len = u16();
        if (len < 2 || pos + len - 2 > size) throw Corrupt{"bad segment length"};
        pos += len - 2;
    }

    void read_sof(int m) {
        if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) throw Unsupported{"lossless JPEG"};
        if (m >= 0xC9) throw Unsupported{"arithmetic-coded JPEG"};
        if (m == 0xC5 || m == 0xC6) throw Unsupported{"hierarchical JPEG"};
        progressive = m == 0xC2;
        int len = u16();
        int precision = u8();
        height = u16();
        width = u16();
        ncomp = u8();
        if (precision != 8) throw Unsupported{std::to_string(precision) + "-bit JPEG samples"};
        if (height == 0) throw Unsupported{"JPEG height defined by a DNL marker"};
        if (width == 0) throw Corrupt{"zero width"};
        if (ncomp == 2 || ncomp == 4) throw Unsupported{std::to_string(ncomp) + "-component (CMYK / YCCK) JPEG"};
        if (ncomp != 1 && ncomp != 3) throw Corrupt{"bad component count"};
        if (len != 8 + 3 * ncomp) throw Corrupt{"bad frame header length"};
        for (int i = 0; i < ncomp; ++i) {
            comp[i].id = u8();
            int hv = u8();
            comp[i].h = hv >> 4;
            comp[i].v = hv & 15;
            comp[i].tq = u8();
            if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 || comp[i].tq > 3)
                throw Corrupt{"bad sampling factors"};
        }
        frame = true;
    }

    void setup() {
        hmax = vmax = 1;
        for (int i = 0; i < ncomp; ++i) {
            hmax = std::max(hmax, comp[i].h);
            vmax = std::max(vmax, comp[i].v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comp[i];
            if (hmax % c.h || vmax % c.v) throw Unsupported{"fractional JPEG sampling ratio"};
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.dw = (int)(((long long)width * c.h + hmax - 1) / hmax);
            c.dh = (int)(((long long)height * c.v + vmax - 1) / vmax);
            c.coefs.assign((size_t)c.bw * c.bh * 64, 0);
            for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
        }
    }

    void read_dqt() {
        int len = u16() - 2;
        while (len > 0) {
            int pq = u8();
            int t = pq & 15, prec = pq >> 4;
            if (t > 3 || prec > 1) throw Corrupt{"bad quantisation table"};
            for (int k = 0; k < 64; ++k) qt[t][kNatural[k]] = prec ? u16() : u8();
            qt_defined[t] = true;
            len -= 1 + 64 * (prec + 1);
        }
    }

    void read_dht() {
        int len = u16() - 2;
        while (len > 0) {
            int tc = u8();
            int cls = tc >> 4, t = tc & 15;
            if (cls > 1 || t > 3) throw Corrupt{"bad Huffman table id"};
            uint8_t counts[16];
            int n = 0;
            for (int i = 0; i < 16; ++i) {
                counts[i] = (uint8_t)u8();
                n += counts[i];
            }
            if (n > 256) throw Corrupt{"bad Huffman table"};
            uint8_t vals[256];
            for (int i = 0; i < n; ++i) vals[i] = (uint8_t)u8();
            (cls ? ac[t] : dc[t]).build(counts, vals, n);
            len -= 17 + n;
        }
    }

    void read_app(int m) {
        int len = u16();
        size_t start = pos;
        if (len < 2 || pos + len - 2 > size) throw Corrupt{"bad segment length"};
        if (m == 0xE0 && len - 2 >= 14 && memcmp(data + pos, "JFIF\0", 5) == 0) jfif = true;
        if (m == 0xEE && len - 2 >= 12 && memcmp(data + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[pos + 11];
        }
        pos = start + len - 2;
    }

    // end of the entropy-coded segment that starts at pos: the first marker
    // that is neither a stuffed 0xFF00 nor a restart marker
    size_t segment_end(size_t p) const {
        while (p + 1 < size) {
            if (data[p] == 0xFF) {
                uint8_t b = data[p + 1];
                if (b == 0x00 || (b >= 0xD0 && b <= 0xD7) || b == 0xFF) {
                    p += (b == 0xFF) ? 1 : 2;
                    continue;
                }
                return p;
            }
            ++p;
        }
        return size;
    }

    void read_sos() {
        if (!frame) throw Corrupt{"scan before frame header"};
        int len = u16();
        int ns = u8();
        if (ns < 1 || ns > 4 || len != 6 + 2 * ns) throw Corrupt{"bad scan header"};
        Component* sc[4];
        for (int i = 0; i < ns; ++i) {
            int id = u8(), tt = u8();
            Component* c = nullptr;
            for (int j = 0; j < ncomp; ++j)
                if (comp[j].id == id) c = &comp[j];
            if (!c) throw Corrupt{"scan names an unknown component"};
            c->dc_tbl = tt >> 4;
            c->ac_tbl = tt & 15;
            if (c->dc_tbl > 3 || c->ac_tbl > 3) throw Corrupt{"bad table selector"};
            sc[i] = c;
        }
        int Ss = u8(), Se = u8(), A = u8();
        int Ah = A >> 4, Al = A & 15;
        for (int i = 0; i < ns; ++i) {
            Component* c = sc[i];
            if (!c->latched) {  // jdinput.c latch_quant_tables
                if (!qt_defined[c->tq]) throw Corrupt{"missing quantisation table"};
                memcpy(c->qt, qt[c->tq], sizeof(c->qt));
                c->latched = true;
            }
            c->pred = 0;
        }
        if (progressive) {
            if (Ss > Se || Se > 63 || (Ss == 0 && Se != 0) || (Ss > 0 && ns != 1) || Al > 13)
                throw Corrupt{"bad progressive scan parameters"};
            for (int i = 0; i < ns; ++i)
                for (int k = Ss; k <= Se; ++k) sc[i]->coef_bits[k] = Al;
        } else if (Ss != 0 || Se != 63 || Ah != 0 || Al != 0) {
            throw Corrupt{"bad sequential scan parameters"};
        }
        for (int i = 0; i < ns; ++i) {
            bool need_dc = !progressive || (Ss == 0 && Ah == 0);
            bool need_ac = !progressive || Ss > 0;
            if (need_dc && !dc[sc[i]->dc_tbl].defined) throw Corrupt{"missing DC Huffman table"};
            // a DC symbol is a bit count: libjpeg refuses one above 15 when the
            // scan derives its tables (jdhuff.c jpeg_make_d_derived_tbl)
            if (need_dc && dc[sc[i]->dc_tbl].max_val > 15) throw Corrupt{"bad Huffman table: DC symbol above 15"};
            if (need_ac && !ac[sc[i]->ac_tbl].defined) throw Corrupt{"missing AC Huffman table"};
        }

        size_t end = segment_end(pos);
        BitReader br{data + pos, data + end};
        int eobrun = 0;
        auto block = [&](Component* c, int by, int bx) -> int16_t* {
            return c->coefs.data() + ((size_t)by * c->bw + bx) * 64;
        };
        auto decode_block = [&](Component* c, int16_t* b) {
            if (!progressive) {
                int s = br.decode(dc[c->dc_tbl]);
                if (s) s = extend(br.bits(s), s);
                c->pred += s;
                b[0] = (int16_t)c->pred;
                const Huffman& t = ac[c->ac_tbl];
                for (int k = 1; k < 64; ++k) {
                    int rs = br.decode(t);
                    int r = rs >> 4;
                    s = rs & 15;
                    if (s) {
                        k += r;
                        b[kNatural[k]] = (int16_t)extend(br.bits(s), s);
                    } else {
                        if (r != 15) break;
                        k += 15;
                    }
                }
            } else if (Ss == 0) {
                if (Ah == 0) {
                    int s = br.decode(dc[c->dc_tbl]);
                    if (s) s = extend(br.bits(s), s);
                    c->pred += s;
                    b[0] = (int16_t)(c->pred * (1 << Al));
                } else if (br.bit()) {
                    b[0] = (int16_t)(b[0] | (1 << Al));
                }
            } else if (Ah == 0) {
                if (eobrun > 0) {
                    --eobrun;
                    return;
                }
                const Huffman& t = ac[c->ac_tbl];
                for (int k = Ss; k <= Se; ++k) {
                    int rs = br.decode(t);
                    int r = rs >> 4, s = rs & 15;
                    if (s) {
                        k += r;
                        b[kNatural[k]] = (int16_t)(extend(br.bits(s), s) * (1 << Al));
                    } else if (r == 15) {
                        k += 15;
                    } else {
                        eobrun = 1 << r;
                        if (r) eobrun += br.bits(r);
                        --eobrun;
                        break;
                    }
                }
            } else {
                int p1 = 1 << Al, m1 = -1 * (1 << Al);
                const Huffman& t = ac[c->ac_tbl];
                int k = Ss;
                if (eobrun == 0) {
                    for (; k <= Se; ++k) {
                        int rs = br.decode(t);
                        int r = rs >> 4, s = rs & 15;
                        if (s) {
                            s = br.bit() ? p1 : m1;
                        } else if (r != 15) {
                            eobrun = 1 << r;
                            if (r) eobrun += br.bits(r);
                            break;
                        }
                        do {
                            int16_t* coef = b + kNatural[k];
                            if (*coef != 0) {
                                if (br.bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                            } else if (--r < 0) {
                                break;
                            }
                            ++k;
                        } while (k <= Se);
                        if (s) b[kNatural[k]] = (int16_t)s;
                    }
                }
                if (eobrun > 0) {
                    for (; k <= Se; ++k) {
                        int16_t* coef = b + kNatural[k];
                        if (*coef != 0 && br.bit() && (*coef & p1) == 0)
                            *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                    }
                    --eobrun;
                }
            }
        };

        long long n_mcu;
        int scan_bw = 0;
        if (ns == 1) {
            scan_bw = (sc[0]->dw + 7) / 8;
            n_mcu = (long long)scan_bw * ((sc[0]->dh + 7) / 8);
        } else {
            n_mcu = (long long)mcux * mcuy;
        }
        for (long long m = 0; m < n_mcu; ++m) {
            if (restart_interval && m > 0 && m % restart_interval == 0) {
                br.restart();
                eobrun = 0;
                for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
            }
            if (ns == 1) {
                decode_block(sc[0], block(sc[0], (int)(m / scan_bw), (int)(m % scan_bw)));
            } else {
                int my = (int)(m / mcux), mx = (int)(m % mcux);
                for (int i = 0; i < ns; ++i) {
                    Component* c = sc[i];
                    for (int y = 0; y < c->v; ++y)
                        for (int x = 0; x < c->h; ++x) decode_block(c, block(c, my * c->v + y, mx * c->h + x));
                }
            }
        }
        pos = end;
    }

    void read_all() {
        if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) throw Corrupt{"not a JPEG file"};
        pos = 2;
        bool any_scan = false;
        for (;;) {
            int m = next_marker();
            if (m == 0xD9) break;
            if (is_sof(m)) {
                if (frame) throw Corrupt{"second frame header"};
                read_sof(m);
                setup();
            } else if (m == 0xC4) {
                read_dht();
            } else if (m == 0xCC) {
                throw Unsupported{"arithmetic-coded JPEG"};
            } else if (m == 0xDB) {
                read_dqt();
            } else if (m == 0xDD) {
                if (u16() != 4) throw Corrupt{"bad DRI length"};
                restart_interval = u16();
            } else if (m == 0xDA) {
                read_sos();
                any_scan = true;
            } else if (m >= 0xE0 && m <= 0xEF) {
                read_app(m);
            } else if (m >= 0xD0 && m <= 0xD7) {
                continue;  // stray restart marker
            } else if (m == 0xDC) {
                throw Unsupported{"JPEG DNL marker"};
            } else {
                skip_segment();
            }
        }
        if (!any_scan) throw Corrupt{"no scan"};
        if (progressive)
            for (int i = 0; i < ncomp; ++i)
                for (int k = 0; k < 64; ++k)
                    if (comp[i].coef_bits[k] != 0)
                        throw Unsupported{
                            "progressive JPEG that leaves a coefficient not fully sent (libjpeg's block "
                            "smoothing would change its pixels)"};
    }
};

// jidctint.c jpeg_idct_islow
const int CONST_BITS = 13, PASS1_BITS = 2;
const long FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
           FIX_0_899976223 = 7373, FIX_1_175875602 = 9633, FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
           FIX_1_961570560 = 16069, FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }
inline uint8_t clamp_sample(long x) { return (uint8_t)(x < -128 ? 0 : x > 127 ? 255 : x + 128); }

void idct_islow(const int16_t* in, const int* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const int* qp = q + c;
        int* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        long z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
        long z1 = (z2 + z3) * FIX_0_541196100;
        long tmp2 = z1 + z3 * -FIX_1_847759065;
        long tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        long tmp0 = (z2 + z3) * (1L << CONST_BITS);
        long tmp1 = (z2 - z3) * (1L << CONST_BITS);
        long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = ip[56] * qp[56];
        tmp1 = ip[40] * qp[40];
        tmp2 = ip[24] * qp[24];
        tmp3 = ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        long z4 = tmp1 + tmp3;
        long z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS - PASS1_BITS;
        wp[0] = (int)descale(tmp10 + tmp3, sh);
        wp[56] = (int)descale(tmp10 - tmp3, sh);
        wp[8] = (int)descale(tmp11 + tmp2, sh);
        wp[48] = (int)descale(tmp11 - tmp2, sh);
        wp[16] = (int)descale(tmp12 + tmp1, sh);
        wp[40] = (int)descale(tmp12 - tmp1, sh);
        wp[24] = (int)descale(tmp13 + tmp0, sh);
        wp[32] = (int)descale(tmp13 - tmp0, sh);
    }
    for (int r = 0; r < 8; ++r) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + (size_t)r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            uint8_t dc = clamp_sample(descale(wp[0], PASS1_BITS + 3));
            for (int c = 0; c < 8; ++c) op[c] = dc;
            continue;
        }
        long z2 = wp[2], z3 = wp[6];
        long z1 = (z2 + z3) * FIX_0_541196100;
        long tmp2 = z1 + z3 * -FIX_1_847759065;
        long tmp3 = z1 + z2 * FIX_0_765366865;
        long tmp0 = ((long)wp[0] + wp[4]) * (1L << CONST_BITS);
        long tmp1 = ((long)wp[0] - wp[4]) * (1L << CONST_BITS);
        long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        long z4 = tmp1 + tmp3;
        long z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        op[0] = clamp_sample(descale(tmp10 + tmp3, sh));
        op[7] = clamp_sample(descale(tmp10 - tmp3, sh));
        op[1] = clamp_sample(descale(tmp11 + tmp2, sh));
        op[6] = clamp_sample(descale(tmp11 - tmp2, sh));
        op[2] = clamp_sample(descale(tmp12 + tmp1, sh));
        op[5] = clamp_sample(descale(tmp12 - tmp1, sh));
        op[3] = clamp_sample(descale(tmp13 + tmp0, sh));
        op[4] = clamp_sample(descale(tmp13 - tmp0, sh));
    }
}

// One component's samples (bw*8 wide) -> a full-size W x H plane.
void upsample(const Component& c, const std::vector<uint8_t>& in, int hmax, int vmax, int W, int H,
              uint8_t* out) {
    const int stride = c.bw * 8;
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int dw = c.dw, dh = c.dh;
    auto row = [&](int i) { return in.data() + (size_t)(i < 0 ? 0 : i >= dh ? dh - 1 : i) * stride; };
    std::vector<int> colsum(dw);
    std::vector<uint8_t> wide((size_t)2 * dw + 2);
    for (int y = 0; y < H; ++y) {
        uint8_t* o = out + (size_t)y * W;
        if (rh == 1 && rv == 1) {
            memcpy(o, row(y), W);
        } else if (rh == 2 && rv == 1 && dw > 2) {  // h2v1_fancy_upsample
            const uint8_t* r = row(y);
            uint8_t* w = wide.data();
            w[0] = r[0];
            w[1] = (uint8_t)((r[0] * 3 + r[1] + 2) >> 2);
            for (int j = 1; j < dw - 1; ++j) {
                int v = r[j] * 3;
                w[2 * j] = (uint8_t)((v + r[j - 1] + 1) >> 2);
                w[2 * j + 1] = (uint8_t)((v + r[j + 1] + 2) >> 2);
            }
            int j = dw - 1;
            w[2 * j] = (uint8_t)((r[j] * 3 + r[j - 1] + 1) >> 2);
            w[2 * j + 1] = r[j];
            memcpy(o, w, W);
        } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
            int i = y >> 1;
            const uint8_t* r0 = row(i);
            const uint8_t* r1 = (y & 1) ? row(i + 1) : row(i - 1);
            int bias = (y & 1) ? 2 : 1;
            for (int x = 0; x < W; ++x) o[x] = (uint8_t)((r0[x] * 3 + r1[x] + bias) >> 2);
        } else if (rh == 2 && rv == 2 && dw > 2) {  // h2v2_fancy_upsample
            int i = y >> 1;
            const uint8_t* r0 = row(i);
            const uint8_t* r1 = (y & 1) ? row(i + 1) : row(i - 1);
            for (int x = 0; x < dw; ++x) colsum[x] = r0[x] * 3 + r1[x];
            uint8_t* w = wide.data();
            w[0] = (uint8_t)((colsum[0] * 4 + 8) >> 4);
            w[1] = (uint8_t)((colsum[0] * 3 + colsum[1] + 7) >> 4);
            for (int j = 1; j < dw - 1; ++j) {
                w[2 * j] = (uint8_t)((colsum[j] * 3 + colsum[j - 1] + 8) >> 4);
                w[2 * j + 1] = (uint8_t)((colsum[j] * 3 + colsum[j + 1] + 7) >> 4);
            }
            int j = dw - 1;
            w[2 * j] = (uint8_t)((colsum[j] * 3 + colsum[j - 1] + 8) >> 4);
            w[2 * j + 1] = (uint8_t)((colsum[j] * 4 + 7) >> 4);
            memcpy(o, w, W);
        } else {  // int_upsample / h2v1_upsample / h2v2_upsample: replication
            const uint8_t* r = in.data() + (size_t)(y / rv) * stride;
            for (int x = 0; x < W; ++x) o[x] = r[x / rh];
        }
    }
}

int fail(char* err, int errlen, const std::string& msg, int code) {
    if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
    return code;
}

}  // namespace

extern "C" {

// Frame size and component count without decoding (1 or 3 components).
int catseg_jpeg_info(const uint8_t* data, size_t size, int* height, int* width, int* channels, char* err,
                     int errlen) {
    try {
        Jpeg j(data, size);
        j.read_header_only();
        *height = j.height;
        *width = j.width;
        *channels = j.ncomp;
        return 0;
    } catch (const Unsupported& e) {
        return fail(err, errlen, e.what, 1);
    } catch (const Corrupt& e) {
        return fail(err, errlen, e.what, 2);
    }
}

// Decode into out: height * width * channels bytes (channels from
// catseg_jpeg_info; 3-component images come out as RGB).
int catseg_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, char* err, int errlen) {
    try {
        Jpeg j(data, size);
        j.read_all();
        const int W = j.width, H = j.height;
        std::vector<std::vector<uint8_t>> planes(j.ncomp);
        for (int i = 0; i < j.ncomp; ++i) {
            Component& c = j.comp[i];
            if (!c.latched) throw Corrupt{"a component appears in no scan"};
            const int stride = c.bw * 8;
            std::vector<uint8_t> samples((size_t)stride * c.bh * 8);
            const int by_end = (c.dh + 7) / 8, bx_end = (c.dw + 7) / 8;
            for (int by = 0; by < by_end; ++by)
                for (int bx = 0; bx < bx_end; ++bx)
                    idct_islow(c.coefs.data() + ((size_t)by * c.bw + bx) * 64, c.qt,
                               samples.data() + (size_t)by * 8 * stride + bx * 8, stride);
            c.coefs.clear();
            c.coefs.shrink_to_fit();
            planes[i].resize((size_t)W * H);
            upsample(c, samples, j.hmax, j.vmax, W, H, planes[i].data());
        }
        if (j.ncomp == 1) {
            memcpy(out, planes[0].data(), (size_t)W * H);
            return 0;
        }
        // jdapimin.c default_decompress_parms: JFIF -> YCbCr; Adobe
        // transform 0 -> RGB; else component ids 'R','G','B' -> RGB
        bool rgb = false;
        if (!j.jfif) {
            if (j.adobe)
                rgb = j.adobe_transform == 0;
            else
                rgb = j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B';
        }
        const uint8_t *Y = planes[0].data(), *Cb = planes[1].data(), *Cr = planes[2].data();
        const size_t n = (size_t)W * H;
        if (rgb) {
            for (size_t p = 0; p < n; ++p) {
                out[3 * p] = Y[p];
                out[3 * p + 1] = Cb[p];
                out[3 * p + 2] = Cr[p];
            }
            return 0;
        }
        // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
        const long SCALEBITS = 16, ONE_HALF = 1L << 15;
        auto FIX = [](double x) { return (long)(x * (1L << 16) + 0.5); };
        int cr_r[256], cb_b[256];
        long cr_g[256], cb_g[256];
        for (int i = 0; i < 256; ++i) {
            long x = i - 128;
            cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -FIX(0.71414) * x;
            cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
        }
        auto lim = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
        for (size_t p = 0; p < n; ++p) {
            int y = Y[p], cb = Cb[p], cr = Cr[p];
            out[3 * p] = lim(y + cr_r[cr]);
            out[3 * p + 1] = lim(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
            out[3 * p + 2] = lim(y + cb_b[cb]);
        }
        return 0;
    } catch (const Unsupported& e) {
        return fail(err, errlen, e.what, 1);
    } catch (const Corrupt& e) {
        return fail(err, errlen, e.what, 2);
    } catch (const std::bad_alloc&) {
        return fail(err, errlen, "out of memory", 2);
    }
}

// PNG row unfiltering (filter types None / Sub / Up / Average / Paeth),
// in place: raw holds height rows of (1 + rowbytes) bytes, the filter type
// first; out receives height * rowbytes bytes.  bpp is the filter's byte
// distance (bytes per complete pixel, at least 1).
int catseg_png_unfilter(const uint8_t* raw, int height, int rowbytes, int bpp, uint8_t* out, char* err,
                        int errlen) {
    const uint8_t* prev = nullptr;
    for (int y = 0; y < height; ++y) {
        const uint8_t* in = raw + (size_t)y * (rowbytes + 1);
        int ft = in[0];
        ++in;
        uint8_t* o = out + (size_t)y * rowbytes;
        switch (ft) {
            case 0:
                memcpy(o, in, rowbytes);
                break;
            case 1:
                for (int x = 0; x < rowbytes; ++x) o[x] = (uint8_t)(in[x] + (x >= bpp ? o[x - bpp] : 0));
                break;
            case 2:
                for (int x = 0; x < rowbytes; ++x) o[x] = (uint8_t)(in[x] + (prev ? prev[x] : 0));
                break;
            case 3:
                for (int x = 0; x < rowbytes; ++x) {
                    int a = x >= bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
                    o[x] = (uint8_t)(in[x] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int x = 0; x < rowbytes; ++x) {
                    int a = x >= bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
                    int c = (x >= bpp && prev) ? prev[x - bpp] : 0;
                    int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
                        pc = p > c ? p - c : c - p;
                    int pr = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    o[x] = (uint8_t)(in[x] + pr);
                }
                break;
            default:
                return fail(err, errlen, "bad PNG filter type " + std::to_string(ft), 2);
        }
        prev = o;
    }
    return 0;
}

}  // extern "C"
