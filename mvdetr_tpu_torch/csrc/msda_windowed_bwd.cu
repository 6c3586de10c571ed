// Windowed deformable-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel mvdetr_tpu/ops/pallas/msda_kernel_bwd.py::_bwd_kernel
// (launched from msda_windowed_pallas_bwd_prepped). For the forward of
// msda_windowed_fwd.cu,
//
//   out[b,c,y,x,m*D+d] = sum_{l,p} w * bilinear(value[b,l,:,:,m,d], x + clamp(ox,+-R), y + clamp(oy,+-R)),
//
// and the cotangent g of out, it returns three f32 cotangents. Per query
// (b, c, y, x), head m and sample (l, p), with ix = floor(ox), fx = ox - ix
// taken from the clamped offset itself (as the forward does) and the four
// taps v00 = value[y0, x0], v01 = value[y0, x0+1], v10, v11 (zero outside
// the grid):
//
//   g_w  = sum_d g * ((1-fy)((1-fx)v00 + fx v01) + fy((1-fx)v10 + fx v11))
//   g_ox = w [|ox_raw| <= R] sum_d g ((1-fy)(sa v00 + sb v01) + fy(sa v10 + sb v11))
//   g_oy = w [|oy_raw| <= R] sum_d g ((1-fx)(sa' v00 + sb' v10) + fx(sa' v01 + sb' v11))
//   g_value[tap] += (w * cy) * cx * g          for each of the four taps,
//
// with the TPU kernel's hat slopes sa = slope(ox - ix), sb = slope(ox - ix - 1),
// slope(t) = -sign(t) for |t| < 1 and 0 otherwise, t computed in f32. These
// are the TPU kernel's 81-shift hat sums written as 4 taps: for a fraction in
// (0, 1) the slopes are -1 and +1 (g_ox ~ v01 - v00), an integer offset gets
// a zero offset cotangent, and a fraction below f32 resolution next to 1 (the
// radial init's cos(pi/2) ~ 1e-16 components) keeps only one slope, exactly
// as on the TPU.
//
// Determinism: no float atomics. Two kernels on the caller's stream:
//
// - query side (g_offsets, g_weights): one thread per sample (b, c, y, x, m,
//   l, p) sums over the D channels of its head in order (8 channels per
//   16-byte load when D % 8 == 0) and writes its own outputs.
// - value side (g_value): one block of kWarps warps per (b, head m, chunk
//   of 16 channels, value tile of kTileY x kTileX cells, level l), l fastest
//   so that the L blocks reading the same g run together. A sample of query
//   (qy, qx) taps rows y0, y0+1 and columns x0, x0+1 with x0 - qx in [-R, R],
//   so only the tile's halo, queries with qy in [y_t-R-1, y_t+kTileY-1+R]
//   (and likewise in x, clipped to the grid), can land on it. For each
//   camera c in order, the block stages the halo in slabs of query rows with
//   cp.async into a ring of kStages buffers: each query's P offset pairs and
//   weights for (m, l) and its 16 channels of g, so each offset is read from
//   device memory about twice (the halo ratio) instead of once per
//   candidate cell. The tile's accumulators live in shared memory, start at
//   zero and are written to g_value once.
//
//   Each warp owns a band of kBandX tile columns, every row of them. It
//   scans the staged samples whose taps can reach its band, 32 at a time:
//   each lane turns one sample into a record (tap position, which of the
//   four taps fall in the band, the four coefficients (w * cy) * cx, with
//   cy, cx from the clamped offset as above) in the warp's slot of shared
//   memory, and a ballot collects the samples that land. The warp then takes
//   those in order, one per step, with lanes as (tap row, channel): lanes
//   0-15 add to row y0, lanes 16-31 to row y0+1, each into columns x0 and
//   x0+1 where they are in the band, acc = fma(coef, g, acc). A sample lands
//   in one band, or two when its columns straddle bands (1 in 8). Each cell
//   belongs to one warp and one lane of it, so it is summed without atomics
//   in the order (c, qy, qx, p): the order of the value-stationary thread
//   per cell that this design replaced, and g_value is bitwise what that
//   design gave. Any radius, D, C and grid size work: the slab height
//   follows the radius so that a stage buffer stays near kStageBytes, D > 16
//   takes more channel chunks (lanes past D fill unused slots), and ragged
//   tiles mask their edges.
//
// Bound on an H100 SXM: memory. At the flagship shape (B=2, L=C=7, 60x180,
// M=8, D=16, P=4) one call reads value 38.7 MB (bf16), offsets 271 MB,
// weights 135 MB and g 77 MB (f32), and writes g_value 77 MB, g_offsets
// 271 MB and g_weights 135 MB: ~1.0 GB, ~0.30 ms at 3.35 TB/s. The
// arithmetic, ~30 FLOP per (sample, channel) or ~16 GFLOP, is ~0.24 ms at the
// 67 TFLOP/s f32 rate. The value side alone moves 0.56 GB (0.17 ms). On an
// H100 80GB HBM3 at 700 W it takes ~2.8 ms at that shape (the value-stationary
// thread per cell took ~14 ms): about half of it is the per-hit update, which
// costs ~7 shared-memory wavefronts (record, g, two read-modify-writes), and
// most of the rest is staging ~2.5 GB of halos through L2; occupancy (7
// blocks per SM, by registers and shared memory) decides the sizes above.
// PERF.md has the measurements.
//
// Interface: a plain C function, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/msda_windowed.py). It launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

// value side
constexpr int kChunk = 16;                      // channels of one head per block, one per lane of a half-warp
constexpr int kWarps = 4;                       // warps per block
constexpr int kTileY = 8;                       // tile rows
constexpr int kTileX = 32;                      // tile columns
constexpr int kBandX = kTileX / kWarps;         // tile columns per warp (a warp owns every row of them)
constexpr int kAccRow = kTileX * kChunk + 16;   // floats per tile row: the pad puts rows y0, y0+1 on other banks
constexpr int kStages = 2;                      // stage buffers in the cp.async ring
constexpr int kStageBytes = 6 * 1024;           // aim for one stage buffer (a slab of halo rows)
constexpr int kSmemLimit = 232448;              // dynamic shared memory one Hopper block may use
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n / d for 0 <= n < 2^24 and d > 0, from a float reciprocal and one correction
__device__ __forceinline__ int div_small(int n, int d, float inv_d) {
  int q = __float2int_rz((float)n * inv_d);
  const int r = n - q * d;
  q += (r >= d) - (r < 0);
  return q;
}

// slope of the hat weight max(0, 1 - |t|) as the TPU kernel takes it
__device__ __forceinline__ float hat_slope(float t) {
  return fabsf(t) < 1.f ? (t > 0.f ? -1.f : (t < 0.f ? 1.f : 0.f)) : 0.f;
}

// 8 bf16 channels from one 16-byte load, or zeros for a tap outside the grid
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ base, long long i, bool inside, float* out) {
  if (inside) {
    const uint4 u = *reinterpret_cast<const uint4*>(base + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = 0.f;
  }
}

// Query side: one thread per sample (b, c, y, x, m, l, p). With vec (D % 8 == 0
// and 16-byte aligned value and g) the channels are read 8 at a time; the
// sums run over d in the same order either way.
__global__ void msda_bwd_query_kernel(const __nv_bfloat16* __restrict__ value,  // [B, L, H, W, K]
                                      const float* __restrict__ offsets,        // [B, C, H, W, M, L, P, 2]
                                      const float* __restrict__ weights,        // [B, C, H, W, M, L, P]
                                      const float* __restrict__ g,              // [B, C, H, W, K]
                                      float* __restrict__ g_off, float* __restrict__ g_w, int C, int L, int H,
                                      int W, int M, int D, int P, float radius, bool vec, long long num_samples) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= num_samples) return;
  // s = ((q * M + m) * L + l) * P + p with q = ((b * C + c) * H + y) * W + x
  long long r = s / P;
  const int l = (int)(r % L);
  r /= L;
  const int m = (int)(r % M);
  const long long q = r / M;
  const int x = (int)(q % W);
  const int y = (int)((q / W) % H);
  const long long b = q / ((long long)W * H * C);
  const int K = M * D;

  const float ox_raw = offsets[2 * s];
  const float oy_raw = offsets[2 * s + 1];
  const float ox = fminf(fmaxf(ox_raw, -radius), radius);
  const float oy = fminf(fmaxf(oy_raw, -radius), radius);
  const float wgt = weights[s];
  const float ix = floorf(ox);
  const float iy = floorf(oy);
  const float fx = ox - ix;
  const float fy = oy - iy;
  const int x0 = x + (int)ix;
  const int y0 = y + (int)iy;
  const bool xa = x0 >= 0 && x0 < W;
  const bool xb = x0 + 1 >= 0 && x0 + 1 < W;
  const bool ya = y0 >= 0 && y0 < H;
  const bool yb = y0 + 1 >= 0 && y0 + 1 < H;
  const long long row = (long long)W * K;
  const __nv_bfloat16* v = value + (b * L + l) * H * row + (long long)m * D;
  const long long i00 = (long long)y0 * row + (long long)x0 * K;
  const float* gq = g + q * K + (long long)m * D;
  const float sax = hat_slope(ox - ix), sbx = hat_slope(ox - (ix + 1.f));
  const float say = hat_slope(oy - iy), sby = hat_slope(oy - (iy + 1.f));

  float sw = 0.f, sx = 0.f, sy = 0.f;
  auto add = [&](float gd, float v00, float v01, float v10, float v11) {
    const float top = (1.f - fx) * v00 + fx * v01;
    const float bot = (1.f - fx) * v10 + fx * v11;
    sw += gd * ((1.f - fy) * top + fy * bot);
    sx += gd * ((1.f - fy) * (sax * v00 + sbx * v01) + fy * (sax * v10 + sbx * v11));
    sy += gd * ((1.f - fx) * (say * v00 + sby * v10) + fx * (say * v01 + sby * v11));
  };
  if (vec) {
    for (int d = 0; d < D; d += 8) {
      float a[8], bq[8], c8[8], e[8];
      load8(v, i00 + d, ya && xa, a);
      load8(v, i00 + K + d, ya && xb, bq);
      load8(v, i00 + row + d, yb && xa, c8);
      load8(v, i00 + row + K + d, yb && xb, e);
      const float4 g0 = *reinterpret_cast<const float4*>(gq + d);
      const float4 g1 = *reinterpret_cast<const float4*>(gq + d + 4);
      const float gd[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) add(gd[k], a[k], bq[k], c8[k], e[k]);
    }
  } else {
    for (int d = 0; d < D; ++d) {
      const float v00 = (ya && xa) ? __bfloat162float(v[i00 + d]) : 0.f;
      const float v01 = (ya && xb) ? __bfloat162float(v[i00 + K + d]) : 0.f;
      const float v10 = (yb && xa) ? __bfloat162float(v[i00 + row + d]) : 0.f;
      const float v11 = (yb && xb) ? __bfloat162float(v[i00 + row + K + d]) : 0.f;
      add(gq[d], v00, v01, v10, v11);
    }
  }
  g_w[s] = sw;
  g_off[2 * s] = fabsf(ox_raw) <= radius ? wgt * sx : 0.f;
  g_off[2 * s + 1] = fabsf(oy_raw) <= radius ? wgt * sy : 0.f;
}

// Value side. Layout of the dynamic shared memory: the tile's accumulators
// [kTileY][kAccRow]; each warp's records of its current 32 samples; then
// kStages stage buffers of buf_floats (16-byte aligned), each holding a slab
// of up to slab_q halo queries: g [slab_q][kChunk], offsets [slab_q * P]
// (x, y) pairs, weights [slab_q * P].
struct ValueTile {
  int b, l, m, d0, dn;       // which value plane and channel chunk
  int y_t, x_t;              // the tile's first cell
  int hy0, hy1, hx0, ncols;  // the halo, clipped to the grid (rows inclusive)
  int slab_rows, nslab;
};

// What the lanes of one tap row need of a sample that lands in the warp's
// band, one 16-byte load: the acc index of (row, x0); the staged query's g
// index times 4, plus bit 0 if (row, x0) and bit 1 if (row, x0+1) is in the
// band; and the two coefficients (w * cy) * cx of (row, x0) and (row, x0+1).
// A sample has two: tap rows y0 and y0+1.
constexpr int kRecordFloats = 8;
__device__ __forceinline__ int4 row_record(int a, int g_index, int taps, float wcy, float fx) {
  return make_int4(a, g_index << 2 | taps, __float_as_int(wcy * (1.f - fx)), __float_as_int(wcy * fx));
}

// acc += coef * g on the taps of one row record that are in the band
__device__ __forceinline__ void add_row(float* acc, int4 rec, float gv, int j) {
  const int a = rec.x + j;
  if (rec.y & 1) acc[a] = __fmaf_rn(__int_as_float(rec.z), gv, acc[a]);
  if (rec.y & 2) acc[a + kChunk] = __fmaf_rn(__int_as_float(rec.w), gv, acc[a + kChunk]);
}

// Stage unit u = (camera c, slab s) into one buffer with cp.async: one
// thread per query, 16-byte copies where the layout allows (vec_g: D % 16
// == 0; vec_ow: P % 4 == 0, with 16-byte aligned bases).
__device__ __forceinline__ void stage_unit(const ValueTile& t, int u, float* buf, int slab_q,
                                           const float* __restrict__ offsets, const float* __restrict__ weights,
                                           const float* __restrict__ g, int C, int L, int H, int W, int M, int D,
                                           int P, bool vec_g, bool vec_ow, float inv_ncols) {
  const int c = u / t.nslab;
  const int sy0 = t.hy0 + (u - c * t.nslab) * t.slab_rows;
  const int nq = min(t.slab_rows, t.hy1 - sy0 + 1) * t.ncols;
  const int K = M * D;
  float* gs = buf;
  float* os = buf + slab_q * kChunk;
  float* ws = os + 2 * slab_q * P;
  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    const int row = div_small(i, t.ncols, inv_ncols);
    const long long q = ((long long)(t.b * C + c) * H + sy0 + row) * W + t.hx0 + i - row * t.ncols;
    const float* gq = g + q * K + (long long)t.m * D + t.d0;
    if (vec_g) {
#pragma unroll
      for (int k = 0; k < kChunk; k += 4) cp_async16(gs + i * kChunk + k, gq + k);
    } else {
      for (int k = 0; k < t.dn; ++k) cp_async4(gs + i * kChunk + k, gq + k);
    }
    // the P samples of the query for (m, l): contiguous in offsets and weights
    const long long s = ((q * M + t.m) * L + t.l) * P;
    if (vec_ow) {
      for (int k = 0; k < 2 * P; k += 4) cp_async16(os + 2 * i * P + k, offsets + 2 * s + k);
      for (int k = 0; k < P; k += 4) cp_async16(ws + i * P + k, weights + s + k);
    } else {
      for (int k = 0; k < P; ++k) {
        cp_async8(os + 2 * (i * P + k), offsets + 2 * (s + k));
        cp_async4(ws + i * P + k, weights + s + k);
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
msda_bwd_value_kernel(const float* __restrict__ offsets,  // [B, C, H, W, M, L, P, 2]
                      const float* __restrict__ weights,  // [B, C, H, W, M, L, P]
                      const float* __restrict__ g,        // [B, C, H, W, K]
                      float* __restrict__ g_value,        // [B, L, H, W, M, D]
                      int C, int L, int H, int W, int M, int D, int P, int radius, int nchunk, int ntx, int nty,
                      int slab_rows, int slab_q, int buf_floats, bool vec_g, bool vec_ow) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;
  // this warp's row records: [32 samples][2 tap rows]
  int4* records = reinterpret_cast<int4*>(smem + kTileY * kAccRow) + 2 * (threadIdx.x & ~31);
  float* stage = smem + kTileY * kAccRow + kWarps * 32 * kRecordFloats;  // buffer i at stage + i * buf_floats

  // blockIdx.x = (((b * M + m) * nchunk + ch) * (nty * ntx) + tile) * L + l
  ValueTile t;
  int r = blockIdx.x;
  t.l = r % L;
  r /= L;
  const int tile = r % (nty * ntx);
  r /= nty * ntx;
  const int ch = r % nchunk;
  r /= nchunk;
  t.m = r % M;
  t.b = r / M;
  t.d0 = ch * kChunk;
  t.dn = min(kChunk, D - t.d0);
  t.y_t = (tile / ntx) * kTileY;
  t.x_t = (tile % ntx) * kTileX;
  t.hy0 = max(0, t.y_t - radius - 1);
  t.hy1 = min(H - 1, t.y_t + kTileY - 1 + radius);
  t.hx0 = max(0, t.x_t - radius - 1);
  t.ncols = min(W - 1, t.x_t + kTileX - 1 + radius) - t.hx0 + 1;
  t.slab_rows = slab_rows;
  t.nslab = (t.hy1 - t.hy0 + slab_rows) / slab_rows;
  const int units = C * t.nslab;
  const float inv_p = 1.f / (float)P, inv_ncols = 1.f / (float)t.ncols;

  for (int i = threadIdx.x; i < kTileY * kAccRow; i += blockDim.x) acc[i] = 0.f;
  for (int u = 0; u < kStages - 1; ++u) {
    if (u < units) {
      stage_unit(t, u, stage + u * buf_floats, slab_q, offsets, weights, g, C, L, H, W, M, D, P, vec_g, vec_ow,
                 inv_ncols);
    }
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;  // 0: tap row y0, 1: tap row y0 + 1
  const int j = lane & 15;     // channel d0 + j (lanes past the chunk's dn fill unused slots)
  const int xb = (threadIdx.x >> 5) * kBandX;  // this warp's band: tile columns [xb, xb + kBandX), every row
  // halo columns (relative to hx0) of queries whose taps can reach the band
  const int c_lo = max(0, t.x_t + xb - radius - 1 - t.hx0);
  const int c_hi = min(t.ncols - 1, t.x_t + xb + kBandX - 1 + radius - t.hx0);
  const bool band_live = t.x_t + xb < W && c_lo <= c_hi;
  const int seg = (c_hi - c_lo + 1) * P;  // staged samples of one halo row that the band scans
  const float inv_seg = 1.f / (float)seg;
  const float rad = (float)radius;

  for (int u = 0; u < units; ++u) {
    cp_async_wait<kStages - 2>();  // this thread's copies of unit u have landed
    __syncthreads();               // everyone's have, and unit u - 1's buffer is free
    if (u + kStages - 1 < units) {
      stage_unit(t, u + kStages - 1, stage + (u + kStages - 1) % kStages * buf_floats, slab_q, offsets, weights, g,
                 C, L, H, W, M, D, P, vec_g, vec_ow, inv_ncols);
    }
    cp_async_commit();

    const float* gs = stage + u % kStages * buf_floats;
    const float2* os = reinterpret_cast<const float2*>(gs + slab_q * kChunk);
    const float* ws = gs + slab_q * (kChunk + 2 * P);
    const int c = u / t.nslab;
    const int sy0 = t.hy0 + (u - c * t.nslab) * t.slab_rows;
    const int k_end = min(t.slab_rows, t.hy1 - sy0 + 1) * seg;
    for (int base = 0; band_live && base < k_end; base += 32) {
      // each lane turns one staged sample into its record
      const int e = base + lane;
      int taps = 0;
      if (e < k_end) {
        const int row = div_small(e, seg, inv_seg);
        const int k = (row * t.ncols + c_lo) * P + e - row * seg;
        const int qi = div_small(k, P, inv_p);
        const int qy = sy0 + row, qx = t.hx0 + qi - row * t.ncols;
        const float2 o = os[k];
        const float ox = fminf(fmaxf(o.x, -rad), rad);
        const float oy = fminf(fmaxf(o.y, -rad), rad);
        const float ix = floorf(ox);
        const float iy = floorf(oy);
        const float fx = ox - ix;
        const float fy = oy - iy;
        const int ty0 = qy + (int)iy - t.y_t;  // tile row of tap row y0
        const int tx0 = qx + (int)ix - t.x_t;  // tile column of tap column x0
        const bool y_a = ty0 >= 0 && ty0 < kTileY, y_b = ty0 >= -1 && ty0 < kTileY - 1;
        const bool x_a = tx0 >= xb && tx0 < xb + kBandX, x_b = tx0 >= xb - 1 && tx0 < xb + kBandX - 1;
        taps = (y_a && x_a) | (y_a && x_b) << 1 | (y_b && x_a) << 2 | (y_b && x_b) << 3;
        if (taps) {
          const float w = ws[k];
          const float w0 = w * (1.f - fy), w1 = w * fy;
          const int a = ty0 * kAccRow + tx0 * kChunk;
          records[2 * lane] = row_record(a, qi * kChunk, taps & 3, w0, fx);
          records[2 * lane + 1] = row_record(a + kAccRow, qi * kChunk, taps >> 2, w1, fx);
        }
      }
      __syncwarp();
      // the hits, in order; lanes are (tap row, channel). Two per step: the
      // second's record and g are loaded before the first is added, and the
      // adds keep their order.
      unsigned mask = __ballot_sync(kFull, taps != 0);
      while (mask) {
        const int first = __ffs(mask) - 1;
        mask &= mask - 1;
        const int4 r1 = records[2 * first + half];
        const float g1 = gs[(r1.y >> 2) + j];
        if (mask) {
          const int second = __ffs(mask) - 1;
          mask &= mask - 1;
          const int4 r2 = records[2 * second + half];
          const float g2 = gs[(r2.y >> 2) + j];
          add_row(acc, r1, g1, j);
          add_row(acc, r2, g2, j);
        } else {
          add_row(acc, r1, g1, j);
        }
      }
      __syncwarp();  // the records are rewritten by the next 32 samples
    }
  }
  __syncthreads();

  // each tile cell inside the grid written once
  for (int i = threadIdx.x; i < kTileY * kTileX * kChunk; i += blockDim.x) {
    const int jj = i % kChunk, xx = (i / kChunk) % kTileX, yy = i / (kChunk * kTileX);
    const int y = t.y_t + yy, x = t.x_t + xx;
    if (jj < t.dn && y < H && x < W) {
      g_value[((((long long)t.b * L + t.l) * H + y) * W + x) * M * (long long)D + (long long)t.m * D + t.d0 + jj] =
          acc[yy * kAccRow + xx * kChunk + jj];
    }
  }
}

int launch_query(const void* value, const void* offsets, const void* weights, const void* g, void* g_offsets,
                 void* g_weights, int B, int C, int L, int H, int W, int M, int D, int P, int radius,
                 cudaStream_t stream) {
  const int threads = 256;
  const bool vec = D % 8 == 0 && reinterpret_cast<size_t>(value) % 16 == 0 && reinterpret_cast<size_t>(g) % 16 == 0;
  const long long num_samples = (long long)B * C * H * W * M * L * P;
  if (num_samples <= 0) return (int)cudaSuccess;
  const long long blocks = (num_samples + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  msda_bwd_query_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(offsets),
      static_cast<const float*>(weights), static_cast<const float*>(g), static_cast<float*>(g_offsets),
      static_cast<float*>(g_weights), C, L, H, W, M, D, P, (float)radius, vec, num_samples);
  return (int)cudaGetLastError();
}

int launch_value(const void* offsets, const void* weights, const void* g, void* g_value, int B, int C, int L, int H,
                 int W, int M, int D, int P, int radius, cudaStream_t stream) {
  const int nchunk = (D + kChunk - 1) / kChunk;
  const int ntx = (W + kTileX - 1) / kTileX, nty = (H + kTileY - 1) / kTileY;
  const long long blocks = (long long)B * M * nchunk * nty * ntx * L;
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // a slab of halo rows: as many as fit in kStageBytes, at least one
  const long long halo_cols = std::min<long long>(W, kTileX + 2LL * radius + 1);
  const long long halo_rows = std::min<long long>(H, kTileY + 2LL * radius + 1);
  const long long q_bytes = (kChunk + 3LL * P) * (long long)sizeof(float);
  const long long slab_rows = std::max<long long>(1, std::min<long long>(halo_rows, kStageBytes / (halo_cols * q_bytes)));
  const long long slab_q = slab_rows * halo_cols;
  const long long buf_floats = (slab_q * (kChunk + 3LL * P) + 3) / 4 * 4;
  const long long smem =
      ((long long)kTileY * kAccRow + kWarps * 32 * kRecordFloats + kStages * buf_floats) * (long long)sizeof(float);
  if (smem > kSmemLimit || slab_q >= (1 << 15) || slab_q * P >= (1 << 24)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(msda_bwd_value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec_g = D % kChunk == 0 && reinterpret_cast<size_t>(g) % 16 == 0;
  const bool vec_ow = P % 4 == 0 && reinterpret_cast<size_t>(offsets) % 16 == 0 &&
                      reinterpret_cast<size_t>(weights) % 16 == 0;
  msda_bwd_value_kernel<<<(unsigned)blocks, kWarps * 32, (size_t)smem, stream>>>(
      static_cast<const float*>(offsets), static_cast<const float*>(weights), static_cast<const float*>(g),
      static_cast<float*>(g_value), C, L, H, W, M, D, P, radius, nchunk, ntx, nty, (int)slab_rows, (int)slab_q,
      (int)buf_floats, vec_g, vec_ow);
  return (int)cudaGetLastError();
}

}  // namespace

// sides: 1 the query side (g_offsets, g_weights), 2 the value side (g_value), 3 both
extern "C" int msda_windowed_bwd_sides_launch(const void* value, const void* offsets, const void* weights,
                                              const void* g, void* g_value, void* g_offsets, void* g_weights, int B,
                                              int C, int L, int H, int W, int M, int D, int P, int radius, int sides,
                                              void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  if (M <= 0 || D <= 0 || radius < 0 || sides < 1 || sides > 3) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sides & 1) {
    const int e = launch_query(value, offsets, weights, g, g_offsets, g_weights, B, C, L, H, W, M, D, P, radius, st);
    if (e != 0) return e;
  }
  if (sides & 2) {
    const int e = launch_value(offsets, weights, g, g_value, B, C, L, H, W, M, D, P, radius, st);
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}

extern "C" int msda_windowed_bwd_launch(const void* value, const void* offsets, const void* weights, const void* g,
                                        void* g_value, void* g_offsets, void* g_weights, int B, int C, int L, int H,
                                        int W, int M, int D, int P, int radius, void* stream) {
  return msda_windowed_bwd_sides_launch(value, offsets, weights, g, g_value, g_offsets, g_weights, B, C, L, H, W, M,
                                        D, P, radius, 3, stream);
}

extern "C" const char* msda_windowed_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
