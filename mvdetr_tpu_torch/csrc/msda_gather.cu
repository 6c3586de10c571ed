// Gather-mode deformable attention, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs gather mode
// (mvdetr_tpu/ops/msda.py::ms_deform_attn_same_shape) as a plain XLA gather.
// Added for the attention layer of --attn_mode gather and --world_feat aio
// (mvdetr_tpu_torch/ops/msda.py::_GatherAttnFn), whose plain PyTorch path
// builds a zero-padded 2x2 patch table of the value, copies one 128-byte
// row a sample out of it with index_select (4.3 GB at the cells' shape) and
// contracts each corner with a batched gemv, forward and again backward.
//
// The function (the plain path's arithmetic, which is JAX's; T is the value
// dtype, f32 or bf16, and T(.) rounds to it). For each (b, q, m) and each
// of its L*P samples, in (l, p) order:
//   x = fmaf(loc_x, W, -0.5f), y = fmaf(loc_y, H, -0.5f)   (one rounding, as
//       XLA's fused multiply-add: ops/msda.py::fma emulates it in f64)
//   x0 = floor(x), wx1 = x - x0, wx0 = 1 - wx1 (and y likewise); the
//   corners, in the order (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1), each
//   masked on its own where it lies outside the H x W map.
// Forward, per corner c: cw = T(T(wy*wx) * w), acc_c = sum over the samples
// of cw * tap_c in f32, and out = T(T(T(T(acc_0) + T(acc_1)) + T(acc_2)) +
// T(acc_3)), the corners summed in T from zero.
// Backward, with g the output's cotangent in T, per sample and inside corner:
//   dot = T(<tap, g>), an f32 sum over D;
//   g_w = T(g_w + T(dot * T(wy*wx)));  t = T(dot * w) in f32;
//   gx += (+-wy) * t, gy += (+-wx) * t, in f32 (the signs of d/dx, d/dy);
// then g_loc = (gx * W, gy * H) in f32 and g_wgt = g_w in T. In the same
// pass, the value gradient's inputs (B3, csrc/warp_bwd.cu, launched by the
// caller): sx, sy [B*M*L, Q*P] = the samples' x, y level-major, and gs
// [B*M*L, Q*P, D] = T(w * g), each sample's cotangent times its weight.
// Every step is rounded as the plain path rounds it (__f*_rn, no FMA
// contraction but in the f32 corner sums, whose bf16 products are exact),
// so only the order of those f32 sums differs from the plain path's matmul.
//
// Bound on an H100 SXM: memory. At the cells' shape (B=2, L=7 maps of
// 60x180, Q=75,600, M=8, D=16, P=4: 33.9 M samples, bf16) the forward reads
// the value 38.7 MB, the locations 271 MB and the weights 68 MB and writes
// 39 MB: 416 MB, 0.124 ms at 3.35 TB/s. The backward reads those and g, and
// writes g_loc 271 MB, g_wgt 68 MB, sx and sy 271 MB and gs 1084 MB: 2.11
// GB, 0.63 ms. Each sample also reads four 32-byte taps, 4.3 GB a pass,
// which the value's 38.7 MB (under the 50 MB L2) serves from L2 and L1.
//
// Design (B1's, csrc/msda_windowed_fwd.cu, at unclamped coordinates). A
// group of G lanes owns one (query, head): lane j holds the channels of
// chunks j, j + G, ... of 8 (one 16-byte bf16 load, two in f32), G the
// power of two at or above D / 8, at most 32. A block holds 256 / G
// consecutive queries of one head; blockIdx.x = tile * M + m, so the M
// heads' blocks of a tile run together and read each query's contiguous
// locations and weights between them, and neighbouring queries, which are
// neighbouring cells of one map and sample neighbouring cells, share tap
// lines in L1. A group loads its 4 samples of a level as two float4 of
// locations and one load of weights where P = 4 (one sample at a time for
// any other P). Each lane computes the coordinates itself; a corner outside
// the map loads nothing. The backward reduces a dot over the group's lanes
// with an xor butterfly, whose every step adds two values commutatively, so
// every lane holds the same bits. Each output element has one writer and a
// fixed order of sums: no atomics, and two launches give the same bits.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/msda.py, which checks shapes,
// dtypes and contiguity). They launch on the caller's stream, allocate
// nothing, check the shape and alignment they are given, and return the
// first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16_t = __nv_bfloat16;

constexpr int kThreads = 256;   // a block's threads
constexpr int kChunk = 8;       // channels a lane holds in one chunk
constexpr int kMaxLanes = 32;   // lanes a (query, head) group
constexpr int kMaxChunks = 4;   // chunks a lane: D <= 8 * 32 * 4
constexpr int kF32 = 0, kBF16 = 1;

struct Shape {
  long long bq;  // B * Q
  int q, m, l, h, w, d, p;
  int lanes;     // G, a power of two
  int log_lanes;
  int groups;    // (query, head) groups a block: kThreads / G
  int chunks;    // chunks of 8 channels a lane holds, at most kMaxChunks
};

// ---- T <-> f32 -------------------------------------------------------------

__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16_t>(bf16_t v) { return __bfloat162float(v); }

// round an f32 value to T (round to nearest even, as PyTorch casts) and back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16_t>(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16_t from_f32<bf16_t>(float v) { return __float2bfloat16_rn(v); }

// 8 consecutive channels (16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16_t* p, float* f) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) f[2 * k] = lo_bf16(w[k]), f[2 * k + 1] = hi_bf16(w[k]);
}

// 8 f32 values that T holds exactly, stored as T
__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(bf16_t* p, const float* f) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = (__float_as_uint(f[2 * k]) >> 16) | (__float_as_uint(f[2 * k + 1]) & 0xffff0000u);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// 4 consecutive weights (aligned to 4 elements) as f32
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16_t* p, float* f) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  f[0] = lo_bf16(r.x), f[1] = hi_bf16(r.x), f[2] = lo_bf16(r.y), f[3] = hi_bf16(r.y);
}

// ---- one sample's corners --------------------------------------------------

// The bilinear corners of pixel coordinates (x, y) on an h x w map, in JAX's
// order: whether each lies inside the map, its cell (y * w + x), and its
// weights wy, wx. The comparisons are the plain path's, in f32, so a NaN or
// huge coordinate lies outside.
struct Corners {
  bool in[4];
  int cell[4];
  float wy[4], wx[4];
};

__device__ __forceinline__ Corners corners(float x, float y, int h, int w) {
  Corners c;
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx1 = __fsub_rn(x, x0), wy1 = __fsub_rn(y, y0);
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const float xs[4] = {x0, x1, x0, x1}, ys[4] = {y0, y0, y1, y1};
  const float wxs[4] = {wx0, wx1, wx0, wx1}, wys[4] = {wy0, wy0, wy1, wy1};
  const float xmax = (float)(w - 1), ymax = (float)(h - 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.in[k] = xs[k] >= 0.f && xs[k] <= xmax && ys[k] >= 0.f && ys[k] <= ymax;
    c.cell[k] = c.in[k] ? (int)ys[k] * w + (int)xs[k] : 0;
    c.wy[k] = wys[k];
    c.wx[k] = wxs[k];
  }
  return c;
}

// The group of a thread and its place: the (query, head) it owns, its lane.
struct Place {
  long long bq;  // b * Q + q
  long long gi;  // (b * Q + q) * M + m
  int b, q, m, lane;
  bool valid;
};

__device__ __forceinline__ Place place(const Shape& s) {
  Place t;
  t.m = blockIdx.x % s.m;
  const int group = threadIdx.x >> s.log_lanes;
  t.lane = threadIdx.x & (s.lanes - 1);
  t.bq = (long long)(blockIdx.x / s.m) * s.groups + group;
  t.valid = group < s.groups && t.bq < s.bq;
  t.b = (int)(t.bq / s.q);
  t.q = (int)(t.bq - (long long)t.b * s.q);
  t.gi = t.bq * s.m + t.m;
  return t;
}

// The locations and weights of a group's samples from its sample `first`:
// P = 4 (PT = 4) one level's 4 samples as two float4 and one load of 4
// weights, else one sample.
template <typename T, int PT>
__device__ __forceinline__ void load_samples(const float* gl, const T* gw, int first, float* lx, float* ly,
                                             float* lw) {
  if constexpr (PT == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(gl + first * 2));
    const float4 b = __ldg(reinterpret_cast<const float4*>(gl + first * 2) + 1);
    lx[0] = a.x, ly[0] = a.y, lx[1] = a.z, ly[1] = a.w, lx[2] = b.x, ly[2] = b.y, lx[3] = b.z, ly[3] = b.w;
    load4(gw + first, lw);
  } else {
    const float2 a = __ldg(reinterpret_cast<const float2*>(gl) + first);
    lx[0] = a.x, ly[0] = a.y;
    lw[0] = to_f32(__ldg(gw + first));
  }
}

// ---- forward ---------------------------------------------------------------

template <typename T, int K, int PT>
__global__ void __launch_bounds__(kThreads)
msda_gather_fwd_kernel(const T* __restrict__ value,   // [B, L*H*W, M, D]
                       const float* __restrict__ loc,  // [B, Q, M, L, P, 2]
                       const T* __restrict__ wgt,      // [B, Q, M, L, P]
                       T* __restrict__ out,            // [B, Q, M*D]
                       Shape s) {
  const Place t = place(s);
  const int nchunk = s.d / kChunk;
  if (!t.valid || t.lane >= nchunk) return;
  constexpr int kP = PT ? PT : 1;  // samples loaded at once
  const int P = PT ? PT : s.p;
  const int LP = s.l * P, hw = s.h * s.w, cell_stride = s.m * s.d;
  const float* gl = loc + t.gi * LP * 2;
  const T* gw = wgt + t.gi * LP;
  const T* vb = value + ((long long)t.b * s.l * hw * s.m + t.m) * s.d;  // value[b, 0, m, 0]
  const float fw = (float)s.w, fh = (float)s.h;

  float acc[4][K][kChunk];  // per corner, f32
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int ch = 0; ch < K; ++ch)
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[c][ch][j] = 0.f;

  for (int l = 0; l < s.l; ++l) {
    const T* vl = vb + (long long)l * hw * cell_stride;
    for (int p0 = 0; p0 < P; p0 += kP) {
      float lx[kP], ly[kP], lw[kP];
      load_samples<T, PT>(gl, gw, l * P + p0, lx, ly, lw);
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const Corners c = corners(fmaf(lx[i], fw, -0.5f), fmaf(ly[i], fh, -0.5f), s.h, s.w);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!c.in[k]) continue;
          const float cw = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(c.wy[k], c.wx[k])), lw[i]));
          const T* tap = vl + (long long)c.cell[k] * cell_stride;
#pragma unroll
          for (int ch = 0; ch < K; ++ch) {
            const int chunk = t.lane + ch * s.lanes;
            if (chunk >= nchunk) break;
            float v[kChunk];
            load8(tap + chunk * kChunk, v);
#pragma unroll
            for (int j = 0; j < kChunk; ++j) acc[k][ch][j] = fmaf(cw, v[j], acc[k][ch][j]);
          }
        }
      }
    }
  }

  T* o = out + t.gi * s.d;
#pragma unroll
  for (int ch = 0; ch < K; ++ch) {
    const int chunk = t.lane + ch * s.lanes;
    if (chunk >= nchunk) break;
    float r[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float sum = rnd<T>(acc[0][ch][j]);  // zero + the first corner
#pragma unroll
      for (int k = 1; k < 4; ++k) sum = rnd<T>(__fadd_rn(sum, rnd<T>(acc[k][ch][j])));
      r[j] = sum;
    }
    store8(o + chunk * kChunk, r);
  }
}

// ---- backward --------------------------------------------------------------

template <typename T, int K, int PT>
__global__ void __launch_bounds__(kThreads)
msda_gather_bwd_kernel(const T* __restrict__ value,   // [B, L*H*W, M, D]
                       const float* __restrict__ loc,  // [B, Q, M, L, P, 2]
                       const T* __restrict__ wgt,      // [B, Q, M, L, P]
                       const T* __restrict__ g,        // [B, Q, M*D]
                       float* __restrict__ sx,         // [B*M*L, Q*P], or null with sy and gs
                       float* __restrict__ sy,
                       T* __restrict__ gs,             // [B*M*L, Q*P, D]
                       float* __restrict__ gloc,       // [B, Q, M, L, P, 2], or null with gwgt
                       T* __restrict__ gwgt,           // [B, Q, M, L, P]
                       Shape s) {
  const Place t = place(s);
  if (!t.valid) return;  // the whole group: its lanes share the place
  const int nchunk = s.d / kChunk;
  constexpr int kP = PT ? PT : 1;
  const int P = PT ? PT : s.p;
  const int LP = s.l * P, hw = s.h * s.w, cell_stride = s.m * s.d;
  const float* gl = loc + t.gi * LP * 2;
  const T* gw = wgt + t.gi * LP;
  const T* vb = value + ((long long)t.b * s.l * hw * s.m + t.m) * s.d;
  const float fw = (float)s.w, fh = (float)s.h;
  const bool value_side = gs != nullptr, sample_side = gloc != nullptr;
  // the group's lanes, which the dot's butterfly names
  const unsigned gmask =
      s.lanes == 32 ? 0xffffffffu : ((1u << s.lanes) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(s.lanes - 1));

  float gv[K][kChunk];  // the lane's channels of g, f32 (zero past D)
#pragma unroll
  for (int ch = 0; ch < K; ++ch) {
    const int chunk = t.lane + ch * s.lanes;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) gv[ch][j] = 0.f;
    if (chunk < nchunk) load8(g + t.gi * s.d + chunk * kChunk, gv[ch]);
  }

  for (int l = 0; l < s.l; ++l) {
    const T* vl = vb + (long long)l * hw * cell_stride;
    const long long row = ((long long)t.b * s.m + t.m) * s.l + l;  // B3's map (b, m, l)
    const long long col0 = row * s.q * P + (long long)t.q * P;     // this query's first sample on it
    for (int p0 = 0; p0 < P; p0 += kP) {
      float lx[kP], ly[kP], lw[kP], xs[kP], ys[kP], gxs[kP], gys[kP], gws[kP];
      load_samples<T, PT>(gl, gw, l * P + p0, lx, ly, lw);
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        xs[i] = fmaf(lx[i], fw, -0.5f), ys[i] = fmaf(ly[i], fh, -0.5f);
        if (value_side) {
          T* gsp = gs + (col0 + p0 + i) * s.d;
#pragma unroll
          for (int ch = 0; ch < K; ++ch) {
            const int chunk = t.lane + ch * s.lanes;
            if (chunk >= nchunk) break;
            float r[kChunk];
#pragma unroll
            for (int j = 0; j < kChunk; ++j) r[j] = rnd<T>(__fmul_rn(lw[i], gv[ch][j]));
            store8(gsp + chunk * kChunk, r);
          }
        }
        if (!sample_side) continue;
        const Corners c = corners(xs[i], ys[i], s.h, s.w);
        float gx = 0.f, gy = 0.f, gwv = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!c.in[k]) continue;  // one sample's corner: the group's lanes agree
          const T* tap = vl + (long long)c.cell[k] * cell_stride;
          float part = 0.f;
#pragma unroll
          for (int ch = 0; ch < K; ++ch) {
            const int chunk = t.lane + ch * s.lanes;
            if (chunk >= nchunk) break;
            float v[kChunk];
            load8(tap + chunk * kChunk, v);
#pragma unroll
            for (int j = 0; j < kChunk; ++j) part = fmaf(v[j], gv[ch][j], part);
          }
          for (int off = 1; off < s.lanes; off <<= 1) part = __fadd_rn(part, __shfl_xor_sync(gmask, part, off));
          const float dot = rnd<T>(part);
          gwv = rnd<T>(__fadd_rn(gwv, rnd<T>(__fmul_rn(dot, rnd<T>(__fmul_rn(c.wy[k], c.wx[k]))))));
          const float tt = rnd<T>(__fmul_rn(dot, lw[i]));
          // the signs of d/dx and d/dy of the corner's weight: x0 and y0 corners -, x0+1 and y0+1 corners +
          gx = __fadd_rn(gx, __fmul_rn((k & 1) ? c.wy[k] : -c.wy[k], tt));
          gy = __fadd_rn(gy, __fmul_rn((k & 2) ? c.wx[k] : -c.wx[k], tt));
        }
        gxs[i] = __fmul_rn(gx, fw), gys[i] = __fmul_rn(gy, fh), gws[i] = gwv;
      }
      if (t.lane != 0) continue;  // one writer of the sample-side outputs and the coordinates
      const long long first = t.gi * LP + l * P + p0;
      if constexpr (PT == 4) {
        if (sample_side) {
          float4* o = reinterpret_cast<float4*>(gloc + first * 2);
          o[0] = make_float4(gxs[0], gys[0], gxs[1], gys[1]);
          o[1] = make_float4(gxs[2], gys[2], gxs[3], gys[3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) gwgt[first + i] = from_f32<T>(gws[i]);
        }
        if (value_side) {
          *reinterpret_cast<float4*>(sx + col0) = make_float4(xs[0], xs[1], xs[2], xs[3]);
          *reinterpret_cast<float4*>(sy + col0) = make_float4(ys[0], ys[1], ys[2], ys[3]);
        }
      } else {
        if (sample_side) {
          reinterpret_cast<float2*>(gloc)[first] = make_float2(gxs[0], gys[0]);
          gwgt[first] = from_f32<T>(gws[0]);
        }
        if (value_side) sx[col0 + p0] = xs[0], sy[col0 + p0] = ys[0];
      }
    }
  }
}

// ---- launchers -------------------------------------------------------------

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// G and K of a head of D channels: G the power of two at or above D / 8, at
// most 32; K the chunks a lane then holds
bool plan(int d, int& lanes, int& log_lanes, int& chunks) {
  if (d <= 0 || d % kChunk != 0) return false;
  const int n = d / kChunk;
  lanes = 1, log_lanes = 0;
  while (lanes < n && lanes < kMaxLanes) lanes <<= 1, ++log_lanes;
  chunks = (n + lanes - 1) / lanes;
  return chunks <= kMaxChunks;
}

bool make_shape(long long bq, int q, int m, int l, int h, int w, int d, int p, Shape& s) {
  int lanes, log_lanes, chunks;
  if (bq <= 0 || q <= 0 || bq % q != 0 || m <= 0 || l <= 0 || h <= 0 || w <= 0 || p <= 0 ||
      !plan(d, lanes, log_lanes, chunks)) {
    return false;
  }
  // 32-bit cells of a map and samples of a group
  if ((long long)h * w >= (1LL << 31) || (long long)l * p * 2 >= (1LL << 31)) return false;
  s = Shape{bq, q, m, l, h, w, d, p, lanes, log_lanes, kThreads / lanes, chunks};
  return true;
}

unsigned grid_of(const Shape& s) { return (unsigned)(((s.bq + s.groups - 1) / s.groups) * s.m); }

template <typename T, int K>
cudaError_t launch_fwd_k(const void* value, const float* loc, const void* wgt, void* out, const Shape& s,
                         cudaStream_t st) {
  const T* v = static_cast<const T*>(value);
  const T* w = static_cast<const T*>(wgt);
  T* o = static_cast<T*>(out);
  if (s.p == 4) {
    msda_gather_fwd_kernel<T, K, 4><<<grid_of(s), kThreads, 0, st>>>(v, loc, w, o, s);
  } else {
    msda_gather_fwd_kernel<T, K, 0><<<grid_of(s), kThreads, 0, st>>>(v, loc, w, o, s);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* value, const float* loc, const void* wgt, void* out, const Shape& s,
                       cudaStream_t st) {
  if (s.chunks == 1) return launch_fwd_k<T, 1>(value, loc, wgt, out, s, st);
  if (s.chunks == 2) return launch_fwd_k<T, 2>(value, loc, wgt, out, s, st);
  return launch_fwd_k<T, 4>(value, loc, wgt, out, s, st);
}

template <typename T, int K>
cudaError_t launch_bwd_k(const void* value, const float* loc, const void* wgt, const void* g, float* sx, float* sy,
                         void* gs, float* gloc, void* gwgt, const Shape& s, cudaStream_t st) {
  const T* v = static_cast<const T*>(value);
  const T* w = static_cast<const T*>(wgt);
  const T* gp = static_cast<const T*>(g);
  T* gsp = static_cast<T*>(gs);
  T* gwp = static_cast<T*>(gwgt);
  if (s.p == 4) {
    msda_gather_bwd_kernel<T, K, 4><<<grid_of(s), kThreads, 0, st>>>(v, loc, w, gp, sx, sy, gsp, gloc, gwp, s);
  } else {
    msda_gather_bwd_kernel<T, K, 0><<<grid_of(s), kThreads, 0, st>>>(v, loc, w, gp, sx, sy, gsp, gloc, gwp, s);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* value, const float* loc, const void* wgt, const void* g, float* sx, float* sy,
                       void* gs, float* gloc, void* gwgt, const Shape& s, cudaStream_t st) {
  if (s.chunks == 1) return launch_bwd_k<T, 1>(value, loc, wgt, g, sx, sy, gs, gloc, gwgt, s, st);
  if (s.chunks == 2) return launch_bwd_k<T, 2>(value, loc, wgt, g, sx, sy, gs, gloc, gwgt, s, st);
  return launch_bwd_k<T, 4>(value, loc, wgt, g, sx, sy, gs, gloc, gwgt, s, st);
}

}  // namespace

extern "C" {

// out [B, Q, M*D] (dtype 0 f32, 1 bf16, as value and wgt) from value [B,
// L*H*W, M, D], loc [B, Q, M, L, P, 2] f32 and wgt [B, Q, M, L, P]; bq = B*Q;
// every tensor contiguous and 16-byte aligned, D a multiple of 8 up to 1024.
int msda_gather_fwd_launch(const void* value, const float* loc, const void* wgt, void* out, int dtype, long long bq,
                           int q, int m, int l, int h, int w, int d, int p, void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  Shape s;
  if ((dtype != kF32 && dtype != kBF16) || !make_shape(bq, q, m, l, h, w, d, p, s) || value == nullptr ||
      loc == nullptr || wgt == nullptr || out == nullptr || !aligned16(value) || !aligned16(loc) ||
      !aligned16(wgt) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == kF32 ? launch_fwd<float>(value, loc, wgt, out, s, st)
                                        : launch_fwd<bf16_t>(value, loc, wgt, out, s, st));
}

// The backward of msda_gather_fwd_launch for the cotangent g [B, Q, M*D]
// (value's dtype): with sx, sy, gs non-null the value gradient's B3 inputs
// (sx, sy [B*M*L, Q*P] f32, gs [B*M*L, Q*P, D]); with gloc, gwgt non-null
// the locations' gradient [B, Q, M, L, P, 2] f32 and the weights' [B, Q, M,
// L, P] in the value's dtype. Each group of outputs is all there or all null.
int msda_gather_bwd_launch(const void* value, const float* loc, const void* wgt, const void* g, int dtype,
                           long long bq, int q, int m, int l, int h, int w, int d, int p, float* sx, float* sy,
                           void* gs, float* gloc, void* gwgt, void* stream) {
  (void)cudaGetLastError();
  Shape s;
  const bool value_side = sx != nullptr && sy != nullptr && gs != nullptr;
  const bool sample_side = gloc != nullptr && gwgt != nullptr;
  if ((dtype != kF32 && dtype != kBF16) || !make_shape(bq, q, m, l, h, w, d, p, s) || value == nullptr ||
      loc == nullptr || wgt == nullptr || g == nullptr || !aligned16(value) || !aligned16(loc) || !aligned16(wgt) ||
      !aligned16(g) || !aligned16(sx) || !aligned16(sy) || !aligned16(gs) || !aligned16(gloc) || !aligned16(gwgt) ||
      (!value_side && (sx != nullptr || sy != nullptr || gs != nullptr)) ||
      (!sample_side && (gloc != nullptr || gwgt != nullptr)) || !(value_side || sample_side)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == kF32
                              ? launch_bwd<float>(value, loc, wgt, g, sx, sy, gs, gloc, gwgt, s, st)
                              : launch_bwd<bf16_t>(value, loc, wgt, g, sx, sy, gs, gloc, gwgt, s, st));
}

const char* msda_gather_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
