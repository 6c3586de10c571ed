// BatchNorm2d forward and backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves flax.linen.BatchNorm to XLA,
// which fuses its passes. Added for the port's normalisation layer
// (mvdetr_tpu_torch/models/layers.py::BatchNorm2d), whose plain PyTorch chain
// (a bf16 -> f32 copy, two means, a square, a subtract, a multiply and an add
// that each broadcast a [C] vector over a channels-last map, a cast back, and
// about as many f32 passes of autograd backward) is the largest layer of a
// training step on the card.
//
// The function (the Flax contract, mvdetr_tpu/models/resnet.py:43-44,90):
//   training: mean = E[x], e2 = E[x^2] in f32 over (N, H, W) of each channel,
//             var = max(0, e2 - mean^2) (the one-pass variance);
//   eval:     mean, var = the running statistics;
//   y = (x - mean) * (1/sqrt(var + eps) * weight) + bias, every step of it
//       rounded in f32 as the plain version rounds it (no FMA contraction),
//       then rounded once to y's type;
//   running statistics 0.9 * running + 0.1 * batch (the biased variance),
//   num_batches_tracked + 1, in training unless the caller freezes them.
// The backward is that of the one-pass formula. With S0 = sum(dy) and
// S1 = sum(dy * (x - mean)) over a channel's n elements, r = 1/sqrt(var +
// eps) and mul = r * weight:
//   dbias = S0, dweight = S1 * r,
//   dvar = -S1 * weight * r^3 / 2, de2 = dvar where e2 - mean^2 >= 0 (the
//   clamp passes the gradient there, as torch.clamp does) and 0 elsewhere,
//   dmean = -S0 * mul - 2 * mean * de2,
//   dx = dy * mul + (dmean / n + x * (2 * de2 / n)),
// the per-channel terms in f64, rounded to f32 once each, and dx rounded once
// to x's type. In eval dx = dy * mul. Over a group of ranks (the wrapper's
// data_group) the caller all-reduces the forward's [2, C] means between the
// stats and the apply passes, and the backward's [2, C] sums between the
// sums and the dx passes; n is then the group's total count.
//
// Bound on an H100 SXM: memory. A training call reads x for the statistics,
// then reads x and writes y (6 bytes an element in bf16); its backward reads
// dy and x for the sums, then again for dx, and writes dx (10 bytes). The
// trunk's 20 BatchNorms take 94.0 M elements a camera, 1.316 G a training
// step of 14 cameras: 21.1 GB, 6.3 ms at 3.35 TB/s. An eval call reads x and
// writes y (4 bytes). The per-channel work is a few flops an element.
//
// Design: streaming passes with 16-byte loads, a sum in a fixed order, and no
// float atomics, so a call repeats bitwise. The kernels take channels-last
// dense tensors, which is what the trunk feeds them (the wrapper,
// mvdetr_tpu_torch/ops/batch_norm.py, makes any other input so first): x is
// [R = N*H*W, C]; a thread owns VEC consecutive channels (16 bytes: 8 in
// bf16, 4 in f32, or one where C does not allow it) and a block stacks rpi =
// 256 / (C / VEC) rows, so its loads cover rpi whole rows at once and each
// thread keeps its channels' sums, or its channels' affine terms, in
// registers. x and dy have one dtype; y may have another.
// Kernels, on the caller's stream:
// 1. stats: each block reduces a slab of rows to f32 sums of x and x^2 (a
//    thread's rows in order, then the block's row lanes in order): a
//    [tiles, 2, C] partial.
// 2. finalize: sums the partials tile by tile in f64 (32 strands of tiles,
//    then the strands in order) and divides by the count: [2, C].
// 3. apply: each block computes its channels' mean and mul in its prologue
//    (block 0 also moves the running statistics), then writes y.
// 4. bwd sums: as 1, over dy and x: S0 and S1 with the saved mean.
// 5. the finalize of 2 over them (no division): [2, C].
// 6. dx: the prologue computes each channel's mul and dx terms from the
//    saved statistics and the sums (block 0 writes dweight and dbias from
//    this rank's sums), then writes dx.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/batch_norm.py). They launch on
// the caller's stream, allocate nothing (the caller passes the partials and
// the outputs), check the plan they are given (vec, C / vec within a block,
// 16-byte aligned tensors where vec > 1), and return the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;  // a block's threads: the largest multiple of C / VEC up to this; C / VEC at most this
constexpr int kUnroll = 4;     // loads in flight a thread
constexpr int kF32 = 0, kBF16 = 1;

struct bf16_t {  // a bf16 element as stored
  unsigned short bits;
};

// BYTES (2, 4, 8, 16 or 32, aligned to min(BYTES, 16)) as 32-bit words,
// the lower address in the low half of a word.
template <int BYTES>
__device__ __forceinline__ void load_words(const void* p, unsigned* w) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      w[4 * k] = u.x;
      w[4 * k + 1] = u.y;
      w[4 * k + 2] = u.z;
      w[4 * k + 3] = u.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else if constexpr (BYTES == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
}

template <int BYTES>
__device__ __forceinline__ void store_words(void* p, const unsigned* w) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k)
      reinterpret_cast<uint4*>(p)[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<unsigned*>(p) = w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
  }
}

// VEC consecutive elements of T (float or bf16_t) at p, as f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  unsigned w[(kBytes + 3) / 4];
  load_words<kBytes>(p, w);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if constexpr (sizeof(T) == 4) {
      v[j] = __uint_as_float(w[j]);
    } else {
      v[j] = __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u) : (w[j >> 1] << 16));
    }
  }
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

// v rounded once to T, stored at p.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  unsigned w[(kBytes + 3) / 4];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if constexpr (sizeof(T) == 4) {
      w[j] = __float_as_uint(v[j]);
    } else {
      if (j & 1) {
        w[j >> 1] |= bf16_bits(v[j]) << 16;
      } else {
        w[j >> 1] = bf16_bits(v[j]);
      }
    }
  }
  store_words<kBytes>(p, w);
}

// The statistics that normalise, and the affine map.
struct Affine {
  const float* mean;    // [C]
  const float* second;  // [C]: E[x^2] (second_is_var 0) or the variance (1)
  const float* weight;  // [C]
  const float* bias;    // [C] (the forward's)
  float eps;
  int second_is_var;
};

// Where the apply pass moves the running statistics (mean null: it does not).
struct Running {
  float* mean;
  float* var;
  long long* count;
};

// A channel's terms, each rounded as the plain version rounds it.
struct Terms {
  float mean;
  float var_raw;  // e2 - mean^2 before the clamp (the variance itself in eval)
  float var;
  float r;        // 1 / sqrt(var + eps)
  float mul;      // r * weight
};

__device__ __forceinline__ Terms channel_terms(const Affine& a, int c) {
  Terms t;
  t.mean = a.mean[c];
  if (a.second_is_var) {
    t.var_raw = t.var = a.second[c];
  } else {
    t.var_raw = __fsub_rn(a.second[c], __fmul_rn(t.mean, t.mean));
    t.var = t.var_raw < 0.f ? 0.f : t.var_raw;  // keeps a NaN, as torch.clamp does
  }
  t.r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(t.var, a.eps)));
  t.mul = __fmul_rn(t.r, a.weight[c]);
  return t;
}

__device__ __forceinline__ float affine(float v, float mean, float mul, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(v, mean), mul), bias);
}

__device__ void update_running(const Affine& a, const Running& run, int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const Terms t = channel_terms(a, c);
    run.mean[c] = __fadd_rn(__fmul_rn(run.mean[c], 0.9f), __fmul_rn(t.mean, 0.1f));
    run.var[c] = __fadd_rn(__fmul_rn(run.var[c], 0.9f), __fmul_rn(t.var, 0.1f));
  }
  if (threadIdx.x == 0) *run.count += 1;
}

// The backward's sums and where its parameter gradients go.
struct Grad {
  const float* sums;   // [2, C]: S0, S1 over every rank's batch
  const float* local;  // [2, C]: the same over this rank's batch (dweight, dbias)
  double count;        // elements a channel over every rank
  int batch_stats;     // 1: the statistics were the batch's (they depend on x)
  float* dweight;      // [C]
  float* dbias;        // [C]
};

// dx = dy * mul + (a + x * b); a = b = 0 without batch statistics.
struct DxTerms {
  float mul, a, b;
};

__device__ __forceinline__ DxTerms dx_terms(const Affine& af, const Grad& g, int C, int c) {
  const Terms t = channel_terms(af, c);
  DxTerms d{t.mul, 0.f, 0.f};
  if (g.batch_stats) {
    const double s0 = g.sums[c], s1 = g.sums[C + c], r = t.r;
    const double dvar = -0.5 * s1 * static_cast<double>(af.weight[c]) * r * r * r;
    const double de2 = t.var_raw >= 0.f ? dvar : 0.0;
    const double dmean = -s0 * static_cast<double>(t.mul) - 2.0 * static_cast<double>(t.mean) * de2;
    d.a = static_cast<float>(dmean / g.count);
    d.b = static_cast<float>(2.0 * de2 / g.count);
  }
  return d;
}

__device__ __forceinline__ float dx_of(float v, float d, const DxTerms& t, int batch_stats) {
  const float direct = __fmul_rn(d, t.mul);
  return batch_stats ? __fadd_rn(direct, __fadd_rn(t.a, __fmul_rn(v, t.b))) : direct;
}

__device__ void param_grads(const Affine& af, const Grad& g, int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    g.dweight[c] = __fmul_rn(g.local[C + c], channel_terms(af, c).r);
    g.dbias[c] = g.local[c];
  }
}

// out[o] = sum over k < lanes of red[k * width + o], in order of k.
__device__ __forceinline__ void sum_lanes(const float* red, int lanes, int width, float* out) {
  for (int o = threadIdx.x; o < width; o += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < lanes; ++k) acc += red[k * width + o];
    out[o] = acc;
  }
}

// ---- 1 and 4: per-channel sums into [tiles, 2, C] partials ----
//
// Block t takes rows [t * rows_per_tile, (t + 1) * rows_per_tile); a
// thread owns channels [cg * VEC, cg * VEC + VEC) of rows rl, rl + rpi, ...
// With DY, the sums are S0 = sum(dy) and S1 = sum(dy * (x - mean)); without,
// sum(x) and sum(x^2).

template <typename T, int VEC, bool DY>
__global__ void __launch_bounds__(kThreads) bn_sums_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                                                long long R, int C, long long rows_per_tile,
                                                                const float* __restrict__ mean,
                                                                float* __restrict__ partial) {
  extern __shared__ float red[];  // [rpi][2][C]
  const int cv = C / VEC, rpi = blockDim.x / cv, cg = threadIdx.x % cv, rl = threadIdx.x / cv;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_tile;
  const long long r1 = min(R, r0 + rows_per_tile);
  const long long off = static_cast<long long>(cg) * VEC;
  float s[VEC], q[VEC], m[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
    if constexpr (DY) m[j] = mean[off + j];
  }
  long long r = r0 + rl;
  for (; r + static_cast<long long>(kUnroll - 1) * rpi < r1; r += static_cast<long long>(kUnroll) * rpi) {
    float v[kUnroll][VEC], d[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = (r + static_cast<long long>(u) * rpi) * C + off;
      load_vec<T, VEC>(x + at, v[u]);
      if constexpr (DY) load_vec<T, VEC>(dy + at, d[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if constexpr (DY) {
          s[j] += d[u][j];
          q[j] = fmaf(d[u][j], __fsub_rn(v[u][j], m[j]), q[j]);
        } else {
          s[j] += v[u][j];
          q[j] = fmaf(v[u][j], v[u][j], q[j]);
        }
      }
    }
  }
  for (; r < r1; r += rpi) {
    float v[VEC], d[VEC];
    load_vec<T, VEC>(x + r * C + off, v);
    if constexpr (DY) load_vec<T, VEC>(dy + r * C + off, d);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (DY) {
        s[j] += d[j];
        q[j] = fmaf(d[j], __fsub_rn(v[j], m[j]), q[j]);
      } else {
        s[j] += v[j];
        q[j] = fmaf(v[j], v[j], q[j]);
      }
    }
  }
  float* mine = red + static_cast<long long>(rl) * 2 * C + off;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mine[j] = s[j];
    mine[C + j] = q[j];
  }
  __syncthreads();
  sum_lanes(red, rpi, 2 * C, partial + static_cast<long long>(blockIdx.x) * 2 * C);
}

// ---- 2 and 5: out[o] = (sum over tiles of partial[t, o]) / divisor ----
// A block of 32 x 32 threads takes 32 columns of the [tiles, width] partial:
// strand y adds tiles y, y + 32, ... in f64, then thread (x, 0) adds the 32
// strands in order.
__global__ void __launch_bounds__(1024) bn_finalize_kernel(const float* __restrict__ partial, int tiles, int width,
                                                           double divisor, float* __restrict__ out) {
  __shared__ double strands[32][33];
  const int o = blockIdx.x * 32 + threadIdx.x;
  double acc = 0.0;
  if (o < width) {
#pragma unroll 4
    for (int t = threadIdx.y; t < tiles; t += 32) {
      acc += static_cast<double>(partial[static_cast<long long>(t) * width + o]);
    }
  }
  strands[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && o < width) {
    double total = 0.0;
    for (int k = 0; k < 32; ++k) total += strands[k][threadIdx.x];
    out[o] = static_cast<float>(total / divisor);
  }
}

// ---- 3: y = (x - mean) * mul + bias ----

template <typename TI, typename TO, int VEC>
__global__ void __launch_bounds__(kThreads) bn_apply_rows_kernel(const TI* __restrict__ x, TO* __restrict__ y,
                                                                 long long R, int C, Affine a, Running run) {
  const int cv = C / VEC, rpi = blockDim.x / cv, cg = threadIdx.x % cv, rl = threadIdx.x / cv;
  const long long off = static_cast<long long>(cg) * VEC;
  float m[VEC], mul[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const Terms t = channel_terms(a, static_cast<int>(off) + j);
    m[j] = t.mean;
    mul[j] = t.mul;
    b[j] = a.bias[off + j];
  }
  if (run.mean != nullptr && blockIdx.x == 0) update_running(a, run, C);
  const long long step = static_cast<long long>(gridDim.x) * rpi;
  long long r = static_cast<long long>(blockIdx.x) * rpi + rl;
  for (; r + (kUnroll - 1) * step < R; r += kUnroll * step) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_vec<TI, VEC>(x + (r + u * step) * C + off, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = affine(v[u][j], m[j], mul[j], b[j]);
      store_vec<TO, VEC>(y + (r + u * step) * C + off, o);
    }
  }
  for (; r < R; r += step) {
    float v[VEC], o[VEC];
    load_vec<TI, VEC>(x + r * C + off, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = affine(v[j], m[j], mul[j], b[j]);
    store_vec<TO, VEC>(y + r * C + off, o);
  }
}

// ---- 6: dx, and (block 0) dweight and dbias ----

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) bn_dx_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                                              T* __restrict__ dx, long long R, int C, Affine a,
                                                              Grad g) {
  const int cv = C / VEC, rpi = blockDim.x / cv, cg = threadIdx.x % cv, rl = threadIdx.x / cv;
  const long long off = static_cast<long long>(cg) * VEC;
  if (blockIdx.x == 0) param_grads(a, g, C);
  DxTerms t[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) t[j] = dx_terms(a, g, C, static_cast<int>(off) + j);
  const int batch = g.batch_stats;
  const long long step = static_cast<long long>(gridDim.x) * rpi;
  long long r = static_cast<long long>(blockIdx.x) * rpi + rl;
  for (; r + (kUnroll - 1) * step < R; r += kUnroll * step) {
    float v[kUnroll][VEC], d[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = (r + u * step) * C + off;
      load_vec<T, VEC>(dy + at, d[u]);
      if (batch) {
        load_vec<T, VEC>(x + at, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = dx_of(v[u][j], d[u][j], t[j], batch);
      store_vec<T, VEC>(dx + (r + u * step) * C + off, o);
    }
  }
  for (; r < R; r += step) {
    float v[VEC], d[VEC], o[VEC];
    load_vec<T, VEC>(dy + r * C + off, d);
    if (batch) {
      load_vec<T, VEC>(x + r * C + off, v);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = dx_of(v[j], d[j], t[j], batch);
    store_vec<T, VEC>(dx + r * C + off, o);
  }
}

// ---- host side ----

// Threads of a block: the largest multiple of C / VEC up to kThreads.
int row_threads(int C, int vec) {
  const int cv = C / vec;
  return cv * (kThreads / cv);
}

// The plan a pass over elements of elem bytes may take: VEC 16 / elem or 1.
bool shape_ok(long long R, int C, int vec, int elem) {
  return R > 0 && C > 0 && (vec == 1 || vec == 16 / elem) && C % vec == 0 && C / vec <= kThreads;
}

bool dtype_ok(int d) { return d == kF32 || d == kBF16; }

int elem_bytes(int d) { return d == kF32 ? 4 : 2; }

// 16-byte loads and stores need 16-byte aligned tensors.
bool aligned(int vec, std::initializer_list<const void*> ps) {
  for (const void* p : ps) {
    if (vec > 1 && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

template <typename T, int VEC, bool DY>
cudaError_t launch_sums_v(long long R, int C, const void* x, const void* dy, int tiles, const float* mean,
                          float* partial, cudaStream_t st) {
  const long long rows_per_tile = (R + tiles - 1) / tiles;
  const int threads = row_threads(C, VEC);
  const size_t smem = static_cast<size_t>(threads) * VEC * 2 * sizeof(float);
  bn_sums_rows_kernel<T, VEC, DY><<<tiles, threads, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(dy), R,
                                                                C, rows_per_tile, mean, partial);
  return cudaGetLastError();
}

template <typename T, bool DY>
cudaError_t launch_sums(long long R, int C, int vec, const void* x, const void* dy, int tiles, const float* mean,
                        float* partial, cudaStream_t st) {
  constexpr int kFull = 16 / sizeof(T);
  if (vec == kFull) return launch_sums_v<T, kFull, DY>(R, C, x, dy, tiles, mean, partial, st);
  return launch_sums_v<T, 1, DY>(R, C, x, dy, tiles, mean, partial, st);
}

cudaError_t launch_finalize(const float* partial, int tiles, int width, double divisor, float* out, cudaStream_t st) {
  bn_finalize_kernel<<<(width + 31) / 32, dim3(32, 32), 0, st>>>(partial, tiles, width, divisor, out);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_apply(long long R, int C, int vec, const void* x, void* y, int blocks, const Affine& a,
                         const Running& run, cudaStream_t st) {
  constexpr int kFull = 16 / sizeof(TI);
  const TI* xp = static_cast<const TI*>(x);
  TO* yp = static_cast<TO*>(y);
  if (vec == kFull) {
    bn_apply_rows_kernel<TI, TO, kFull><<<blocks, row_threads(C, kFull), 0, st>>>(xp, yp, R, C, a, run);
  } else {
    bn_apply_rows_kernel<TI, TO, 1><<<blocks, row_threads(C, 1), 0, st>>>(xp, yp, R, C, a, run);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(long long R, int C, int vec, const void* x, const void* dy, void* dx, int blocks,
                      const Affine& a, const Grad& g, cudaStream_t st) {
  constexpr int kFull = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  if (vec == kFull) {
    bn_dx_rows_kernel<T, kFull><<<blocks, row_threads(C, kFull), 0, st>>>(xp, dp, op, R, C, a, g);
  } else {
    bn_dx_rows_kernel<T, 1><<<blocks, row_threads(C, 1), 0, st>>>(xp, dp, op, R, C, a, g);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// stats [2, C] = (E[x], E[x^2]) over the R = N*H*W rows of each channel of x
// [R, C] (dtype 0 f32, 1 bf16; channels-last dense); partial: tiles * 2 * C
// floats.
int bn_stats_launch(const void* x, int dtype, long long R, int C, int vec, int tiles, float* partial, float* stats,
                    void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  if (!dtype_ok(dtype) || !shape_ok(R, C, vec, elem_bytes(dtype)) || !aligned(vec, {x}) || tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kF32 ? launch_sums<float, false>(R, C, vec, x, nullptr, tiles, nullptr, partial, st)
                                  : launch_sums<bf16_t, false>(R, C, vec, x, nullptr, tiles, nullptr, partial, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_finalize(partial, tiles, 2 * C, static_cast<double>(R), stats, st));
}

// y = (x - mean) * (1/sqrt(var + eps) * weight) + bias in y's dtype, with var
// = second (second_is_var) or max(0, second - mean^2); run_mean non-null:
// also the running statistics' update (training only). vec is x's: 16 bytes
// of x or 1.
int bn_apply_launch(const void* x, int x_dtype, void* y, int y_dtype, long long R, int C, int vec, int blocks,
                    const float* mean, const float* second, int second_is_var, const float* weight,
                    const float* bias, float eps, float* run_mean, float* run_var, long long* run_count,
                    void* stream) {
  (void)cudaGetLastError();
  if (!dtype_ok(x_dtype) || !dtype_ok(y_dtype) || !shape_ok(R, C, vec, elem_bytes(x_dtype)) ||
      !aligned(vec, {x, y}) || blocks < 1 ||
      (run_mean != nullptr && (second_is_var || run_var == nullptr || run_count == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Affine a{mean, second, weight, bias, eps, second_is_var};
  const Running run{run_mean, run_var, run_count};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == kF32) {
    err = y_dtype == kF32 ? launch_apply<float, float>(R, C, vec, x, y, blocks, a, run, st)
                          : launch_apply<float, bf16_t>(R, C, vec, x, y, blocks, a, run, st);
  } else {
    err = y_dtype == kF32 ? launch_apply<bf16_t, float>(R, C, vec, x, y, blocks, a, run, st)
                          : launch_apply<bf16_t, bf16_t>(R, C, vec, x, y, blocks, a, run, st);
  }
  return static_cast<int>(err);
}

// sums [2, C] = (sum(dy), sum(dy * (x - mean))) over each channel; x and dy
// [R, C] of one dtype, channels-last dense.
int bn_bwd_sums_launch(const void* x, const void* dy, int dtype, long long R, int C, int vec, int tiles,
                       const float* mean, float* partial, float* sums, void* stream) {
  (void)cudaGetLastError();
  if (!dtype_ok(dtype) || !shape_ok(R, C, vec, elem_bytes(dtype)) || !aligned(vec, {x, dy}) || tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kF32 ? launch_sums<float, true>(R, C, vec, x, dy, tiles, mean, partial, st)
                                  : launch_sums<bf16_t, true>(R, C, vec, x, dy, tiles, mean, partial, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_finalize(partial, tiles, 2 * C, 1.0, sums, st));
}

// dx (x's dtype) from dy, x and the forward's statistics: with batch_stats,
// (E[x], E[x^2]) of the batch, sums [2, C] over every rank's batch and
// count elements a channel over every rank; else (mean, var) fixed; dweight
// and dbias from local, this rank's sums.
int bn_dx_launch(const void* x, const void* dy, void* dx, int dtype, long long R, int C, int vec, int blocks,
                 const float* mean, const float* second, const float* weight, float eps, const float* sums,
                 const float* local, double count, int batch_stats, float* dweight, float* dbias, void* stream) {
  (void)cudaGetLastError();
  if (!dtype_ok(dtype) || !shape_ok(R, C, vec, elem_bytes(dtype)) || !aligned(vec, {x, dy, dx}) || blocks < 1 ||
      (batch_stats && !(count > 0.0)) || dx == nullptr || dweight == nullptr || dbias == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Affine a{mean, second, weight, nullptr, eps, !batch_stats};
  const Grad g{sums, local, count, batch_stats, dweight, dbias};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kF32 ? launch_dx<float>(R, C, vec, x, dy, dx, blocks, a, g, st)
                                  : launch_dx<bf16_t>(R, C, vec, x, dy, dx, blocks, a, g, st);
  return static_cast<int>(err);
}

const char* bn_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
