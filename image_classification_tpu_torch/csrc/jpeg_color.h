// libjpeg's default decode from component planes to RGB, for the nvJPEG
// build (nvjpeg_codec.cpp): nvJPEG returns the planes after its IDCT and
// this header finishes them as libjpeg-turbo does by default, so the two
// builds differ only by the IDCT's rounding. The chroma is upsampled with
// jdsample.c's "fancy" filters (h2v1_fancy_upsample for 4:2:2,
// h2v2_fancy_upsample for 4:2:0: the nearer input row and column weigh 3:1
// against the further ones, with libjpeg's alternating rounding, and edges
// replicate; planes at most 2 wide get its box upsampling), then converted
// with jdcolor.c's fixed-point tables (build_ycc_rgb_table,
// ycc_rgb_convert). tests/test_torch_data.py holds it to libjpeg on planes
// libjpeg itself returns (raw_data_out).

#ifndef IC_JPEG_COLOR_H_
#define IC_JPEG_COLOR_H_

#include <cstddef>
#include <cstdint>
#include <vector>

struct IcYccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  IcYccTables() {
    constexpr int kBits = 16;
    constexpr long kHalf = 1L << (kBits - 1);
    auto fix = [](double x) { return static_cast<long>(x * (1L << kBits) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const long x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + kHalf);
    }
  }
};

inline const IcYccTables& ic_ycc_tables() {
  static const IcYccTables tables;
  return tables;
}

inline uint8_t ic_clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Row r of a full-size (w wide) plane upsampled from `plane` (cw x ch) by
// fx, fy in {1, 2}.
inline void ic_upsample_row(const uint8_t* plane, int cw, int ch, int fx, int fy,
                            int r, int w, int* out) {
  auto at = [&](int y, int x) {
    x = x < 0 ? 0 : (x >= cw ? cw - 1 : x);
    return static_cast<int>(plane[static_cast<size_t>(y) * cw + x]);
  };
  const int y0 = fy == 2 ? r / 2 : r;
  if (fx == 1) {
    for (int x = 0; x < w; ++x) out[x] = at(y0, x);
  } else if (cw <= 2) {
    for (int x = 0; x < w; ++x) out[x] = at(y0, x / 2);
  } else if (fy == 1) {
    for (int x = 0; x < w; ++x) {
      const int i = x / 2;
      const int c = at(y0, i) * 3;
      out[x] = (x & 1) ? (c + at(y0, i + 1) + 2) >> 2 : (c + at(y0, i - 1) + 1) >> 2;
    }
  } else {
    // the next-nearest input row: above for even output rows, below for odd
    int y1 = (r & 1) ? y0 + 1 : y0 - 1;
    y1 = y1 < 0 ? 0 : (y1 >= ch ? ch - 1 : y1);
    auto colsum = [&](int i) {
      i = i < 0 ? 0 : (i >= cw ? cw - 1 : i);
      return static_cast<int>(plane[static_cast<size_t>(y0) * cw + i]) * 3 +
             plane[static_cast<size_t>(y1) * cw + i];
    };
    for (int x = 0; x < w; ++x) {
      const int i = x / 2;
      const int c = colsum(i) * 3;
      out[x] = (x & 1) ? (c + colsum(i + 1) + 7) >> 4 : (c + colsum(i - 1) + 8) >> 4;
    }
  }
}

// Y (w x h) and Cb, Cr (cw x ch, upsampled by fx, fy) -> interleaved RGB
// (h x w x 3). cb == nullptr marks a grey image (R = G = B = Y). `rows` is
// scratch space.
inline void ic_planes_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                             int w, int h, int cw, int ch, int fx, int fy,
                             uint8_t* rgb, std::vector<int>* rows) {
  const size_t npx = static_cast<size_t>(w) * h;
  if (cb == nullptr) {
    for (size_t p = 0; p < npx; ++p) rgb[3 * p] = rgb[3 * p + 1] = rgb[3 * p + 2] = y[p];
    return;
  }
  const IcYccTables& t = ic_ycc_tables();
  rows->resize(2 * static_cast<size_t>(w));
  int* cb_row = rows->data();
  int* cr_row = cb_row + w;
  for (int r = 0; r < h; ++r) {
    ic_upsample_row(cb, cw, ch, fx, fy, r, w, cb_row);
    ic_upsample_row(cr, cw, ch, fx, fy, r, w, cr_row);
    const uint8_t* yrow = y + static_cast<size_t>(r) * w;
    uint8_t* out = rgb + static_cast<size_t>(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int yy = yrow[x], b = cb_row[x], c = cr_row[x];
      out[3 * x] = ic_clamp255(yy + t.cr_r[c]);
      out[3 * x + 1] = ic_clamp255(yy + ((t.cb_g[b] + t.cr_g[c]) >> 16));
      out[3 * x + 2] = ic_clamp255(yy + t.cb_b[b]);
    }
  }
}

#endif  // IC_JPEG_COLOR_H_
