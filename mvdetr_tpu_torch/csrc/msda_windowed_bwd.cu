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
// - value side (g_value): value-stationary. One thread owns one value cell
//   (b, l, y', x') of head m and up to 16 of its channels. A sample of query
//   (qy, qx) taps rows y0, y0+1 and columns x0, x0+1 with x0 - qx in [-R, R],
//   so only queries with qy in [y'-R-1, y'+R] and qx in [x'-R-1, x'+R] can
//   land on (y', x'). The thread visits exactly those, over every camera c
//   and point p, in a fixed order, and adds the taps that land on its cell.
//   Any radius works; the work per cell grows as (2R+2)^2.
//
// Bound on an H100 SXM: memory. At the flagship shape (B=2, L=C=7, 60x180,
// M=8, D=16, P=4) one call reads value 38.7 MB (bf16), offsets 271 MB,
// weights 135 MB and g 77 MB (f32), and writes g_value 77 MB, g_offsets
// 271 MB and g_weights 135 MB: ~1.0 GB, ~0.30 ms at 3.35 TB/s. The
// arithmetic, ~30 FLOP per (sample, channel) or ~16 GFLOP, is ~0.24 ms at the
// 67 TFLOP/s f32 rate. This first version is far above that bound: the value
// side tests (2R+2)^2 * C * P candidate samples per cell, 25x the taps that
// land, re-reading offsets through L1/L2, and a warp's lanes (32 cells) hit
// at different candidates, so it mostly runs the 16-channel update for one
// or two lanes at a time (PERF.md lists the variants tried).
//
// Interface: a plain C function, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/msda_windowed.py). It launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // channels of one head that a value-side thread accumulates

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

// Value side: one thread per value cell (b, l, y', x'), head m and chunk of
// up to 16 channels. It visits, in a fixed order (c, qy, qx, p), every sample
// of the queries whose taps can land on its cell and adds those that do.
__global__ void msda_bwd_value_kernel(const float* __restrict__ offsets,  // [B, C, H, W, M, L, P, 2]
                                      const float* __restrict__ weights,  // [B, C, H, W, M, L, P]
                                      const float* __restrict__ g,        // [B, C, H, W, K]
                                      float* __restrict__ g_value,        // [B, L, H, W, M, D]
                                      int C, int L, int H, int W, int M, int D, int P, int radius, int nchunk,
                                      long long num_threads) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_threads) return;
  // t = ((((b * L + l) * H + y) * W + x) * M + m) * nchunk + ch
  long long r = t;
  const int ch = (int)(r % nchunk);
  r /= nchunk;
  const int m = (int)(r % M);
  r /= M;
  const int x = (int)(r % W);
  r /= W;
  const int y = (int)(r % H);
  r /= H;
  const int l = (int)(r % L);
  const long long b = r / L;
  const int K = M * D;
  const int d0 = ch * kChunk;
  const int dn = D - d0 < kChunk ? D - d0 : kChunk;
  const float rad = (float)radius;

  float acc[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;

  const int qy_lo = y - radius - 1 > 0 ? y - radius - 1 : 0;
  const int qy_hi = y + radius < H - 1 ? y + radius : H - 1;
  const int qx_lo = x - radius - 1 > 0 ? x - radius - 1 : 0;
  const int qx_hi = x + radius < W - 1 ? x + radius : W - 1;
  for (int c = 0; c < C; ++c) {
    for (int qy = qy_lo; qy <= qy_hi; ++qy) {
      for (int qx = qx_lo; qx <= qx_hi; ++qx) {
        const long long q = ((b * C + c) * H + qy) * W + qx;
        const long long s0 = ((q * M + m) * L + l) * P;
        for (int p = 0; p < P; ++p) {
          const float2 o = reinterpret_cast<const float2*>(offsets)[s0 + p];
          const float ox = fminf(fmaxf(o.x, -rad), rad);
          const float oy = fminf(fmaxf(o.y, -rad), rad);
          const float ix = floorf(ox);
          const float iy = floorf(oy);
          const int tx = x - (qx + (int)ix);
          const int ty = y - (qy + (int)iy);
          if ((unsigned)tx > 1u || (unsigned)ty > 1u) continue;
          const float fx = ox - ix;
          const float fy = oy - iy;
          const float cx = tx ? fx : 1.f - fx;
          const float cy = ty ? fy : 1.f - fy;
          const float coef = (weights[s0 + p] * cy) * cx;
          const float* gq = g + q * K + (long long)m * D + d0;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            if (j < dn) acc[j] += coef * gq[j];
          }
        }
      }
    }
  }
  float* out = g_value + ((((b * L + l) * H + y) * W + x) * M + m) * (long long)D + d0;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < dn) out[j] = acc[j];
  }
}

}  // namespace

extern "C" int msda_windowed_bwd_launch(const void* value, const void* offsets, const void* weights, const void* g,
                                        void* g_value, void* g_offsets, void* g_weights, int B, int C, int L, int H,
                                        int W, int M, int D, int P, int radius, void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  if (M <= 0 || D <= 0 || radius < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const bool vec = D % 8 == 0 && reinterpret_cast<size_t>(value) % 16 == 0 && reinterpret_cast<size_t>(g) % 16 == 0;
  const long long num_samples = (long long)B * C * H * W * M * L * P;
  if (num_samples > 0) {
    const long long blocks = (num_samples + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    msda_bwd_query_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(offsets),
        static_cast<const float*>(weights), static_cast<const float*>(g), static_cast<float*>(g_offsets),
        static_cast<float*>(g_weights), C, L, H, W, M, D, P, (float)radius, vec, num_samples);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int nchunk = (D + kChunk - 1) / kChunk;
  const long long num_threads = (long long)B * L * H * W * M * nchunk;
  if (num_threads > 0) {
    const long long blocks = (num_threads + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    msda_bwd_value_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(offsets), static_cast<const float*>(weights), static_cast<const float*>(g),
        static_cast<float*>(g_value), C, L, H, W, M, D, P, radius, nchunk, num_threads);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* msda_windowed_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
