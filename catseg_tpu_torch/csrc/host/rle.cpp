// COCO RLE codec of the prediction dump (catseg_tpu/native/rle.cpp).
//
// Replaces the reference's native dependency on pycocotools' C RLE codec
// (used by the evaluators to dump sem_seg_predictions.json).  Built into the
// host library with image_io.cpp, bound via ctypes
// (catseg_tpu_torch/evaluation/coco_dump.py).

#include <cstdint>
#include <cstring>

extern "C" {

// COCO-style RLE of a binary mask in Fortran (column-major) order:
// alternating run lengths starting with the count of zeros.
// Returns the number of runs written (at most h*w+1).
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts) {
    int n = 0;
    uint32_t run = 0;
    uint8_t cur = 0;
    for (int x = 0; x < w; ++x) {
        const uint8_t* col = mask + x;  // row-major input, walk column-major
        for (int y = 0; y < h; ++y) {
            uint8_t v = col[(size_t)y * w] != 0;
            if (v == cur) {
                ++run;
            } else {
                counts[n++] = run;
                cur = v;
                run = 1;
            }
        }
    }
    counts[n++] = run;
    return n;
}

// Inverse of rle_encode; mask must be zero-initialized by the caller or will
// be fully overwritten (it is).
void rle_decode(const uint32_t* counts, int n, int h, int w, uint8_t* mask) {
    uint8_t cur = 0;
    size_t pos = 0;
    for (int i = 0; i < n; ++i) {
        for (uint32_t j = 0; j < counts[i]; ++j, ++pos) {
            size_t x = pos / (size_t)h;
            size_t y = pos % (size_t)h;
            mask[y * (size_t)w + x] = cur;
        }
        cur = !cur;
    }
}

}  // extern "C"
