// Host data path of the port, a plain C interface loaded with ctypes.
//
// Copied from mvdetr_tpu/native/dataio.cpp (the CPython module there becomes
// extern "C" functions here; the algorithms are unchanged):
//   - dataio_splat_gaussian: max-composited Gaussian target splats
//     (contract: datasets/frameDataset.py:19-46, utils/image_utils.py:86-111)
//   - dataio_greedy_nms: greedy ground-plane NMS (contract: utils/nms.py:7-44)
//   - dataio_warp_u8: bilinear perspective warp of a uint8 image, the
//     augmentation warp (utils/image_utils.py:43-44)
// and one function that the JAX package leaves to cv2:
//   - dataio_resize_u8: cv2.resize(INTER_LINEAR) of a uint8 image, with
//     OpenCV's 11-bit fixed-point coefficients and its rounding.
// and the row filters of the PNG decoder (data/png.py), which the JAX
// package leaves to cv2 or PIL:
//   - png_unfilter: undoes the five PNG filters (None, Sub, Up, Average,
//     Paeth; PNG specification, section 9) of 8-bit, non-interlaced rows.
//
// Every function is pure arithmetic on caller-owned buffers and returns 0 or
// an error code; ctypes releases the interpreter lock around each call, so
// the data loader's worker threads run them in parallel. Built with
// -ffp-contract=off: no fused multiply-adds, so one source gives the same
// bytes on every x86-64 host.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kResizeCoefBits = 11;  // OpenCV's INTER_RESIZE_COEF_BITS
constexpr int kResizeCoefScale = 1 << kResizeCoefBits;

// Source index and 11-bit weights of each output coordinate, as cv::resize
// computes them for INTER_LINEAR (resize.cpp, resizeGeneric_): the fraction
// in float, weights rounded to nearest even. Along x an index past either
// edge is clamped with its fraction set to 0; along y (`clamp` false) the
// fraction is kept and the caller clamps the two rows it reads.
void linear_coefs(int64_t out, int64_t in, bool clamp, std::vector<int32_t>& idx, std::vector<int16_t>& coef) {
  const double scale = 1.0 / (static_cast<double>(out) / static_cast<double>(in));
  idx.resize(out);
  coef.resize(2 * out);
  for (int64_t d = 0; d < out; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int64_t s = static_cast<int64_t>(std::floor(f));
    f -= static_cast<float>(s);
    if (clamp && s < 0) f = 0.f, s = 0;
    if (clamp && s >= in - 1) f = 0.f, s = in - 1;
    idx[d] = static_cast<int32_t>(s);
    coef[2 * d] = static_cast<int16_t>(std::lrint((1.f - f) * kResizeCoefScale));
    coef[2 * d + 1] = static_cast<int16_t>(std::lrint(f * kResizeCoefScale));
  }
}

}  // namespace

extern "C" {

// heatmap [H, W] float32 (written in place); centers [K, 2] int32 (x, y);
// sigma > 0. Max-composites a radius = int(3*sigma) Gaussian at each center.
int dataio_splat_gaussian(float* heatmap, int64_t H, int64_t W, const int32_t* centers, int64_t K, double sigma) {
  if (H < 0 || W < 0 || K < 0 || !(sigma > 0.0)) return 1;
  const int radius = static_cast<int>(3.0 * sigma);
  const int diameter = 2 * radius + 1;
  // the gaussian stamp once (same for all centers)
  std::vector<float> g(static_cast<size_t>(diameter) * diameter);
  double maxv = 0.0;
  for (int dy = -radius; dy <= radius; ++dy)
    for (int dx = -radius; dx <= radius; ++dx) {
      double v = std::exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma));
      g[(dy + radius) * diameter + (dx + radius)] = static_cast<float>(v);
      maxv = std::max(maxv, v);
    }
  const float eps_cut = static_cast<float>(maxv * 2.220446049250313e-16);
  for (auto& v : g)
    if (v < eps_cut) v = 0.0f;

  for (int64_t k = 0; k < K; ++k) {
    const int64_t x = centers[2 * k], y = centers[2 * k + 1];
    const int64_t left = std::min<int64_t>(x, radius), right = std::min<int64_t>(W - x, radius + 1);
    const int64_t top = std::min<int64_t>(y, radius), bottom = std::min<int64_t>(H - y, radius + 1);
    if (left + right <= 0 || top + bottom <= 0) continue;
    for (int64_t iy = -top; iy < bottom; ++iy) {
      float* row = heatmap + (y + iy) * W + x;
      const float* grow = g.data() + (iy + radius) * diameter + radius;
      for (int64_t ix = -left; ix < right; ++ix) row[ix] = std::max(row[ix], grow[ix]);
    }
  }
  return 0;
}

// points [K, 2] float32, scores [K] float32 -> keep [K] uint8 (0/1).
// Greedy by descending score (stable); drops later candidates with
// dist <= thres (ties dropped, matching `utils/nms.py:43`).
int dataio_greedy_nms(const float* p, const float* s, int64_t K, double thres, uint8_t* keep) {
  if (K < 0) return 1;
  std::vector<int64_t> order(K);
  for (int64_t i = 0; i < K; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) { return s[a] > s[b]; });

  std::vector<uint8_t> dead(K, 0);
  std::fill(keep, keep + K, 0);
  const double t2 = thres * thres;
  for (int64_t oi = 0; oi < K; ++oi) {
    const int64_t i = order[oi];
    if (dead[i]) continue;
    keep[i] = 1;
    const double xi = p[2 * i], yi = p[2 * i + 1];
    for (int64_t oj = oi + 1; oj < K; ++oj) {
      const int64_t j = order[oj];
      if (dead[j]) continue;
      const double dx = p[2 * j] - xi, dy = p[2 * j + 1] - yi;
      if (dx * dx + dy * dy <= t2) dead[j] = 1;
    }
  }
  return 0;
}

// src [H, W, 3] uint8, M [3, 3] float64 (src->dst), border uint8 ->
// dst [H, W, 3] uint8: bilinear, inverse-mapped, taps outside the image read
// `border` (cv2.warpPerspective with INTER_LINEAR and a constant border).
// Returns 2 for a singular M.
int dataio_warp_u8(const uint8_t* src, int64_t H, int64_t W, const double* m, int border, uint8_t* dst) {
  if (H <= 0 || W <= 0) return 1;
  // invert M (dst -> src)
  double inv[9];
  {
    const double a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5], g = m[6], h = m[7], i = m[8];
    const double A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
    const double det = a * A + b * B + c * C;
    if (std::abs(det) < 1e-12) return 2;
    inv[0] = A / det; inv[1] = -(b * i - c * h) / det; inv[2] = (b * f - c * e) / det;
    inv[3] = B / det; inv[4] = (a * i - c * g) / det; inv[5] = -(a * f - c * d) / det;
    inv[6] = C / det; inv[7] = -(a * h - b * g) / det; inv[8] = (a * e - b * d) / det;
  }
  const double bval = static_cast<double>(border);

  for (int64_t y = 0; y < H; ++y) {
    // the row's terms: the same products and the same order of additions as
    // inv[0] * x + inv[1] * y + inv[2], so the same bits
    const double ry = inv[1] * y, rz = inv[7] * y, rv = inv[4] * y;
    for (int64_t x = 0; x < W; ++x) {
      const double wz = inv[6] * x + rz + inv[8];
      const double sx = (inv[0] * x + ry + inv[2]) / wz, sy = (inv[3] * x + rv + inv[5]) / wz;
      uint8_t* px = dst + (y * W + x) * 3;
      const double flx = std::floor(sx), fly = std::floor(sy);
      if (!(flx >= -1.0 && flx < static_cast<double>(W) && fly >= -1.0 && fly < static_cast<double>(H))) {
        px[0] = px[1] = px[2] = static_cast<uint8_t>(border);
        continue;
      }
      const int64_t x0 = static_cast<int64_t>(flx), y0 = static_cast<int64_t>(fly);
      const double fx = sx - x0, fy = sy - y0;
      const double w00 = (1 - fx) * (1 - fy), w01 = fx * (1 - fy), w10 = (1 - fx) * fy, w11 = fx * fy;
      if (x0 >= 0 && x0 < W - 1 && y0 >= 0 && y0 < H - 1) {  // all four taps inside
        const uint8_t* p0 = src + (y0 * W + x0) * 3;
        const uint8_t* p1 = p0 + W * 3;
        for (int ch = 0; ch < 3; ++ch) {
          double acc = w00 * p0[ch];
          acc += w01 * p0[3 + ch];
          acc += w10 * p1[ch];
          acc += w11 * p1[3 + ch];
          px[ch] = static_cast<uint8_t>(acc + 0.5);
        }
        continue;
      }
      for (int ch = 0; ch < 3; ++ch) {
        double acc = 0.0;
        for (int dy = 0; dy <= 1; ++dy)
          for (int dx = 0; dx <= 1; ++dx) {
            const int64_t xi = x0 + dx, yi = y0 + dy;
            const double wgt = (dx ? fx : 1 - fx) * (dy ? fy : 1 - fy);
            const double v = (xi >= 0 && xi < W && yi >= 0 && yi < H) ? src[(yi * W + xi) * 3 + ch] : bval;
            acc += wgt * v;
          }
        px[ch] = static_cast<uint8_t>(acc + 0.5);
      }
    }
  }
  return 0;
}

// src [H, W, C] uint8 -> dst [Ho, Wo, C] uint8, bilinear with OpenCV's
// INTER_LINEAR arithmetic for 8-bit images: 11-bit coefficients, a
// horizontal pass into 32-bit sums, then
// dst = ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2
// (VResizeLinear<uchar, int, short, FixedPtCast<int, uchar, 22>>).
int dataio_resize_u8(const uint8_t* src, int64_t H, int64_t W, int64_t C, uint8_t* dst, int64_t Ho, int64_t Wo) {
  if (H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0) return 1;
  std::vector<int32_t> xi, yi;
  std::vector<int16_t> xc, yc;
  linear_coefs(Wo, W, true, xi, xc);
  linear_coefs(Ho, H, false, yi, yc);
  const int64_t row = Wo * C;
  // horizontal passes of the two source rows the current output row reads
  std::vector<int32_t> rows[2] = {std::vector<int32_t>(row), std::vector<int32_t>(row)};
  int64_t have[2] = {-1, -1};
  auto hpass = [&](int64_t sy, std::vector<int32_t>& out) {
    const uint8_t* s = src + sy * W * C;
    for (int64_t dx = 0; dx < Wo; ++dx) {
      const int64_t s0 = xi[dx] * C, s1 = std::min<int64_t>(xi[dx] + 1, W - 1) * C;
      const int32_t a0 = xc[2 * dx], a1 = xc[2 * dx + 1];
      for (int64_t c = 0; c < C; ++c) out[dx * C + c] = s[s0 + c] * a0 + s[s1 + c] * a1;
    }
  };
  auto source_row = [&](int64_t sy) -> const int32_t* {
    for (int k = 0; k < 2; ++k)
      if (have[k] == sy) return rows[k].data();
    const int k = (have[0] < have[1]) ? 0 : 1;  // replace the older row
    hpass(sy, rows[k]);
    have[k] = sy;
    return rows[k].data();
  };
  for (int64_t dy = 0; dy < Ho; ++dy) {
    const int64_t sy0 = std::clamp<int64_t>(yi[dy], 0, H - 1), sy1 = std::clamp<int64_t>(yi[dy] + 1, 0, H - 1);
    const int32_t* r0 = source_row(sy0);
    const int32_t* r1 = source_row(sy1);
    const int32_t b0 = yc[2 * dy], b1 = yc[2 * dy + 1];
    uint8_t* d = dst + dy * row;
    for (int64_t x = 0; x < row; ++x) {
      const int32_t v = (((b0 * (r0[x] >> 4)) >> 16) + ((b1 * (r1[x] >> 4)) >> 16) + 2) >> 2;
      d[x] = static_cast<uint8_t>(std::min(255, std::max(0, v)));
    }
  }
  return 0;
}

// src [H, 1 + row_bytes] uint8: each row's filter type byte, then its
// filtered bytes (the inflated IDAT stream of an 8-bit non-interlaced PNG);
// bpp the bytes per pixel (1-4) -> dst [H, row_bytes] uint8, the unfiltered
// rows. Each row reads the previous unfiltered row (zeros above the first)
// and its own bytes bpp to the left (zeros before the first pixel). Paeth's
// predictor is computed in int, as the specification requires. Returns 2
// for a filter type byte outside 0-4.
int png_unfilter(const uint8_t* src, int64_t H, int64_t row_bytes, int64_t bpp, uint8_t* dst) {
  if (H < 0 || row_bytes < 0 || bpp < 1 || bpp > 8) return 1;
  std::vector<uint8_t> zeros(static_cast<size_t>(row_bytes), 0);
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* in = src + y * (row_bytes + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* out = dst + y * row_bytes;
    const uint8_t* up = y > 0 ? dst + (y - 1) * row_bytes : zeros.data();
    switch (type) {
      case 0:
        std::copy(in, in + row_bytes, out);
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i) out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i) out[i] = static_cast<uint8_t>(in[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int left = i >= bpp ? out[i - bpp] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((left + up[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0, b = up[i], c = i >= bpp ? up[i - bpp] : 0;
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return 2;
    }
  }
  return 0;
}

}  // extern "C"
