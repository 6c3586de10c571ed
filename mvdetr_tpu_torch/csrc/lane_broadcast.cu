// The lane broadcast / reduce experiment for Hopper (sm_90a).
//
// Replaces the TPU microbenchmark scripts/exp_vpu_broadcast.py::_bench and its
// six kernel bodies (k_matmul :81, k_repeat :89, k_jnp_repeat :96,
// k_bcast3d :103, r_matmul :125, r_reshape_sum :132), one kernel a body. In
// the windowed attention kernels (B1, B2) each (level, head) weight is
// broadcast over its head's D = 16 channel lanes, and per-channel products
// are summed back over them; the experiment times ways of doing those two
// steps. With LM = L*M heads of all levels, LK = LM * D:
//
//   broadcast  out[t, k] = sum_{i < reps} (x[t, k / D] + i) * f32(v[t, k])    x [T, LM] f32, v [T, LK] bf16
//   tile       out[t, k] = sum_{i < reps} (x[t, k % LM] + i) * f32(v[t, k])   (the TPU body's pltpu.repeat tiles)
//   reduce     out[t, j] = sum_{i < reps} sum_{d < D} (x[t, j * D + d] + i)    x [T, LK] f32 -> [T, LM]
//
// Each repetition is real work: x + i is computed in every repetition, in
// ascending i, and added into an f32 accumulator; reps is a run-time
// argument, and nothing folds (no sum_d x + D i, no reps * x). i is a float
// counter (exact below 2^24, which the wrapper checks). No atomics.
//
// Bound on an H100 SXM: operations. The broadcast does reps * T * (2 LK + LM)
// FLOP on T * (4 LM + 6 LK) bytes: at T = 151,200 and 81 repetitions 22.6
// GFLOP (0.338 ms at 67 TFLOP/s) against 847 MB (0.253 ms at 3.35 TB/s). The
// reduce does reps * T * 2 LK FLOP (21.9 GFLOP, 0.328 ms) on 576 MB; its adds
// are one instruction a FLOP, so at the FP32 instruction rate (132 SMs x 4 warp
// instructions a clock, ~1.98 GHz: ~33.5 T lane instructions/s) it cannot
// take less than 0.655 ms. B1/B2 keep 8 channels a thread (16-byte bf16
// taps), two threads a head; the kernels below are laid out so:
//
//   jnp_repeat    a thread a head: two 16-byte loads of v, one x + i and 16
//                 FMAs a repetition, four 16-byte stores.
//   repeat        the tile: a thread owns the 16 lanes k = j + LM r that
//                 share x[t, j], neighbouring threads on neighbouring j, so
//                 its 16 scalar loads and stores coalesce; one x + i for 16
//                 FMAs as jnp_repeat.
//   bcast3d       the shuffle at B1/B2's layout: 8 lanes a thread (one
//                 16-byte load of v), the head's first thread loads x and
//                 passes x + i to its partner by one __shfl_sync of width 2
//                 a repetition.
//   r_reshape_sum a thread a head sums its 16 lanes in registers (four
//                 16-byte loads; 16 adds for x + i, a tree of 15, one into
//                 the accumulator), no shuffle.
//   matmul        (x + i) @ E on the tensor cores, mma.sync m16n8k4 tf32:
//                 x + i split into hi (its tf32 truncation) and lo (the
//                 exact rest), fed side by side in one product's K rows
//                 (-hi against E = -1, lo against +1), so one product a
//                 head and repetition and 3 instructions a value.
//   r_matmul      (x + i) @ E^T on the tensor cores, mma.sync m16n8k8 tf32,
//                 hi and lo in products of their own (a K step holds one
//                 head's lanes), four accumulator chains.
//
// Measured with mvdetr_tpu_torch/scripts/lane_vs_source.py on an NVIDIA H100
// 80GB HBM3 at 700 W, T = 151,200, 81 repetitions, in turns with the first
// Hopper version (one thread a lane, per-lane x + i; m16n8k8 products with
// separate hi and lo): jnp_repeat 0.497 ms (was 1.557), repeat 0.517
// (1.711), bcast3d 0.589 (2.042), r_reshape_sum 0.815 (5.390), matmul 0.839
// (1.921), r_matmul 2.341 (4.238). At one repetition the broadcasts are
// memory-bound (0.30-0.43 ms), so most of their 81 repetitions hide under
// the memory time; the tensor-core forms stay slower than the lane forms.
// Tried and dropped, each against this source in the same call:
//   - jnp_repeat at two threads a head, each loading x itself: 0.556 ms;
//     with its stores staged in shared memory: no change (0.509 / 0.506);
//   - r_reshape_sum at two threads a head with one xor-shuffle (B2's
//     combine): 0.926 ms (this 0.826);
//   - matmul on m16n8k8 with four heads' hi and lo in K: 0.976 ms (0.859);
//   - r_matmul with two accumulators (hi, lo): 2.61 ms (2.36); on
//     wgmma.m64n8k8 (A from registers, E^T's one-hot tiles in shared memory,
//     one commit group a head): 2.55 ms (2.37). r_matmul with the split
//     taken out (not a result: x + i fed as both parts) takes 1.18 ms, so
//     the split's two extra instructions a value are half its time.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/lane_broadcast.py). They
// launch on the caller's stream, allocate nothing, and return
// cudaGetLastError(), or an error for input they cannot take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kTf32Mask = 0xffffe000u;  // the sign, exponent and 10 mantissa bits of a tf32
constexpr uint32_t kOne = 0x3f800000u, kMinusOne = 0xbf800000u;

enum Variant { kMatmul = 0, kRepeat = 1, kJnpRepeat = 2, kBcast3d = 3, kRMatmul = 4, kRReshapeSum = 5 };

// d = a (16x8, row) * b (8x8, col) + c, tf32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d = a (16x4, row) * b (4x8, col) + c, tf32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_k4(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// a with its 13 low mantissa bits cleared: exact in tf32, and a - tf32_hi(a) is exact in f32.
__device__ __forceinline__ float tf32_hi(float a) { return __uint_as_float(__float_as_uint(a) & kTf32Mask); }

// Eight bf16 (one 16-byte load) as f32, in order.
__device__ __forceinline__ void unpack8(const uint4 w, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    f[2 * r] = __uint_as_float(u[r] << 16);
    f[2 * r + 1] = __uint_as_float(u[r] & 0xffff0000u);
  }
}

// jnp_repeat. A thread per head n = t * LM + j owns its 16 lanes
// out[16 n .. 16 n + 15] (two 16-byte loads of v, four 16-byte stores) and
// computes one x + i a repetition for 16 FMAs.
__global__ void broadcast_head_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ v,
                                      float* __restrict__ out, int reps, long long n_heads) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_heads) return;
  const uint4* vp = reinterpret_cast<const uint4*>(v) + 2 * n;
  float vf[kD], acc[kD];
  unpack8(vp[0], vf);
  unpack8(vp[1], vf + 8);
#pragma unroll
  for (int u = 0; u < kD; ++u) acc[u] = 0.f;
  const float xv = x[n];
  float fi = 0.f;
#pragma unroll 4
  for (int i = 0; i < reps; ++i) {
    const float s = xv + fi;
#pragma unroll
    for (int u = 0; u < kD; ++u) acc[u] = fmaf(s, vf[u], acc[u]);
    fi += 1.f;
  }
  float4* o = reinterpret_cast<float4*>(out) + 4 * n;
#pragma unroll
  for (int r = 0; r < 4; ++r) o[r] = make_float4(acc[4 * r], acc[4 * r + 1], acc[4 * r + 2], acc[4 * r + 3]);
}

// repeat, the tile. A thread per (t, j) owns the 16 lanes k = j + LM r that
// share x[t, j]; a warp's threads sit on neighbouring j, so each of its 16
// (2-byte) loads and (4-byte) stores is coalesced.
__global__ void tile_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ v,
                            float* __restrict__ out, int LM, int reps, long long n_heads) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_heads) return;
  const long long t = n / LM;
  const long long base = t * LM * kD + (n - t * LM);
  const unsigned short* vs = reinterpret_cast<const unsigned short*>(v);
  float vf[kD], acc[kD];
#pragma unroll
  for (int r = 0; r < kD; ++r) {
    vf[r] = __uint_as_float((uint32_t)vs[base + (long long)r * LM] << 16);
    acc[r] = 0.f;
  }
  const float xv = x[n];
  float fi = 0.f;
#pragma unroll 4
  for (int i = 0; i < reps; ++i) {
    const float s = xv + fi;
#pragma unroll
    for (int r = 0; r < kD; ++r) acc[r] = fmaf(s, vf[r], acc[r]);
    fi += 1.f;
  }
#pragma unroll
  for (int r = 0; r < kD; ++r) out[base + (long long)r * LM] = acc[r];
}

// bcast3d, the shuffle at B1/B2's layout: two threads a head, 8 lanes each
// (one 16-byte load of v). The head's first thread loads x; every
// repetition passes x + i to its partner by one __shfl_sync of width 2.
// Every thread of a warp reaches the shuffle (threads past the end compute
// on zeros and store nothing).
__global__ void broadcast_shfl_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ v,
                                      float* __restrict__ out, int reps, long long n_threads) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool ok = n < n_threads;
  float vf[8], acc[8];
  if (ok) {
    unpack8(reinterpret_cast<const uint4*>(v)[n], vf);
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) vf[u] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = 0.f;
  const float xv = ok && (n & 1) == 0 ? x[n >> 1] : 0.f;
  float fi = 0.f;
#pragma unroll 4
  for (int i = 0; i < reps; ++i) {
    const float s = __shfl_sync(kFull, xv + fi, 0, 2);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] = fmaf(s, vf[u], acc[u]);
    fi += 1.f;
  }
  if (ok) {
    float4* o = reinterpret_cast<float4*>(out) + 2 * n;
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// r_reshape_sum. A thread per head n = t * LM + j sums its 16 lanes x[16 n ..]
// (four 16-byte loads) in registers, with no shuffle: a repetition is 16
// adds for x + i, a tree of 15 and one into the accumulator.
__global__ void reduce_head_kernel(const float* __restrict__ x, float* __restrict__ out, int reps,
                                   long long n_heads) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_heads) return;
  const float4* xp = reinterpret_cast<const float4*>(x) + 4 * n;
  float xv[kD];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 w = xp[r];
    xv[4 * r] = w.x, xv[4 * r + 1] = w.y, xv[4 * r + 2] = w.z, xv[4 * r + 3] = w.w;
  }
  float acc = 0.f, fi = 0.f;
#pragma unroll 2
  for (int i = 0; i < reps; ++i) {
    float s[kD];
#pragma unroll
    for (int u = 0; u < kD; ++u) s[u] = xv[u] + fi;
    // one loop a level, each of a constant trip count: nvcc leaves a nest
    // over the levels rolled and turns s[u + w] into predicated moves (4.5x
    // slower)
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] += s[u + 8];
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] += s[u + 4];
#pragma unroll
    for (int u = 0; u < 2; ++u) s[u] += s[u + 2];
    acc += s[0] + s[1];
    fi += 1.f;
  }
  out[n] = acc;
}

// matmul: (x + i) @ E on the tensor cores. x + i is split into two tf32
// parts that sum to it: hi = tf32_hi(x + i) and lo = (x + i) - hi (exact in
// f32; the product drops its low bits, an error of at most 2^-21 of x + i).
// Warp task: rows t0 .. t0+15, heads h0 .. h0+3, their 64 output columns as
// 8 n-tiles of 8. Fragments of m16n8k4 (g = lane / 4, q = lane % 4): A a0
// (g, q), a1 (g+8, q); B b0 (k=q, n=g); C c0 (g, 2q), c1 (g, 2q+1),
// c2 (g+8, 2q), c3 (g+8, 2q+1). The 4 K rows carry the two parts of two
// heads side by side: K row k holds part k & 1 (0 hi, 1 lo) of head k / 2,
// so thread (g, q) feeds part q & 1 of head q / 2 (heads 0-1 of the task)
// or 2 + q / 2 (heads 2-3). The hi part goes in negated against E = -1 and
// the lo part against E = +1, so each of a thread's four values is three
// instructions (add, mask, fma), with no select. A head's 16 columns are two
// n-tiles with equal columns of E, so one product serves both.
__global__ void broadcast_mma_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ v,
                                     float* __restrict__ out, int T, int LM, int reps, long long n_tasks) {
  const long long task = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (task >= n_tasks) return;  // whole warps only
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3, hq = q >> 1;
  const int blocks_per_row = LM / 4;
  const int h0 = (int)(task % blocks_per_row) * 4;
  const long long t0 = (task / blocks_per_row) * 16;
  const int LK = LM * kD;
  const bool ok_lo = t0 + g < T, ok_hi = t0 + g + 8 < T;
  const long long row_lo = (t0 + g) * LM, row_hi = (t0 + g + 8) * LM;

  // [row g, row g+8] x [head hq, head 2 + hq]
  float xa[4];
  xa[0] = ok_lo ? x[row_lo + h0 + hq] : 0.f;
  xa[1] = ok_hi ? x[row_hi + h0 + hq] : 0.f;
  xa[2] = ok_lo ? x[row_lo + h0 + 2 + hq] : 0.f;
  xa[3] = ok_hi ? x[row_hi + h0 + 2 + hq] : 0.f;
  const float keep = (q & 1) ? 1.f : 0.f;
  const uint32_t e = (q & 1) ? kOne : kMinusOne;
  // E's K row q against the columns of the pair's head p: e where head q / 2 is p
  const uint32_t b[2] = {hq == 0 ? e : 0u, hq == 1 ? e : 0u};
  float vv[8][4], acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = h0 * kD + j * 8 + 2 * q;
    const __nv_bfloat162 lo2 = ok_lo ? *reinterpret_cast<const __nv_bfloat162*>(v + (t0 + g) * LK + col)
                                     : __floats2bfloat162_rn(0.f, 0.f);
    const __nv_bfloat162 hi2 = ok_hi ? *reinterpret_cast<const __nv_bfloat162*>(v + (t0 + g + 8) * LK + col)
                                     : __floats2bfloat162_rn(0.f, 0.f);
    vv[j][0] = __low2float(lo2);
    vv[j][1] = __high2float(lo2);
    vv[j][2] = __low2float(hi2);
    vv[j][3] = __high2float(hi2);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  }
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float fi = 0.f;
  for (int i = 0; i < reps; ++i) {
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float s = xa[r] + fi;
      a[r] = __float_as_uint(fmaf(keep, s, -tf32_hi(s)));
    }
#pragma unroll
    for (int hd = 0; hd < 4; ++hd) {
      float d[4];
      mma_k4(d, a[hd < 2 ? 0 : 2], a[hd < 2 ? 1 : 3], b[hd & 1], zero);
#pragma unroll
      for (int j = 2 * hd; j < 2 * hd + 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = fmaf(d[r], vv[j][r], acc[j][r]);
    }
    fi += 1.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = h0 * kD + j * 8 + 2 * q;
    if (ok_lo) *reinterpret_cast<float2*>(out + (t0 + g) * LK + col) = make_float2(acc[j][0], acc[j][1]);
    if (ok_hi) *reinterpret_cast<float2*>(out + (t0 + g + 8) * LK + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// r_matmul: (x + i) @ E^T on the tensor cores, hi and lo as in matmul, each
// in a product of its own (E^T's K rows all belong to one head, so the parts
// cannot share a K step). Warp task: rows t0 .. t0+15, heads h0 .. h0+7, one
// 16x8 output tile. Fragments of m16n8k8: A a0 (g, q), a1 (g+8, q),
// a2 (g, q+4), a3 (g+8, q+4); B b0 (k=q, n=g), b1 (k=q+4, n=g). A head's 16
// lanes fill the K rows of two steps; within a head the order of lanes is
// free, so thread (g, q) holds lanes 4q .. 4q+3 of rows g and g+8 (two
// 16-byte loads a head) and E^T's fragment is b0 = b1 = (g == head). The
// two steps' hi and lo sums run in four accumulators, so consecutive
// products do not wait on each other.
__global__ void reduce_mma_kernel(const float* __restrict__ x, float* __restrict__ out, int T, int LM, int reps,
                                  long long n_tasks) {
  const long long task = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (task >= n_tasks) return;  // whole warps only
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int blocks_per_row = LM / 8;
  const int h0 = (int)(task % blocks_per_row) * 8;
  const long long t0 = (task / blocks_per_row) * 16;
  const int LK = LM * kD;
  const bool ok_lo = t0 + g < T, ok_hi = t0 + g + 8 < T;

  float xr[8][8];  // [head][row g: lanes 4q .. 4q+3, then row g+8: the same lanes]
#pragma unroll
  for (int hd = 0; hd < 8; ++hd) {
    const long long col = (long long)(h0 + hd) * kD + 4 * q;
    const float4 lo = ok_lo ? *reinterpret_cast<const float4*>(x + (t0 + g) * LK + col) : make_float4(0, 0, 0, 0);
    const float4 hi = ok_hi ? *reinterpret_cast<const float4*>(x + (t0 + g + 8) * LK + col) : make_float4(0, 0, 0, 0);
    xr[hd][0] = lo.x, xr[hd][1] = lo.y, xr[hd][2] = lo.z, xr[hd][3] = lo.w;
    xr[hd][4] = hi.x, xr[hd][5] = hi.y, xr[hd][6] = hi.z, xr[hd][7] = hi.w;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float fi = 0.f;
  for (int i = 0; i < reps; ++i) {
    float dh0[4] = {0.f, 0.f, 0.f, 0.f}, dl0[4] = {0.f, 0.f, 0.f, 0.f};
    float dh1[4] = {0.f, 0.f, 0.f, 0.f}, dl1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int hd = 0; hd < 8; ++hd) {
      const uint32_t b = g == hd ? kOne : 0u;
      uint32_t ah[8], al[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float s = xr[hd][u] + fi;
        const float hi = tf32_hi(s);
        ah[u] = __float_as_uint(hi);
        al[u] = __float_as_uint(s - hi);
      }
      // step 1: K rows q, q+4 = lanes 4q, 4q+1; step 2: lanes 4q+2, 4q+3
      mma_k8(dh0, ah[0], ah[4], ah[1], ah[5], b, b, dh0);
      mma_k8(dl0, al[0], al[4], al[1], al[5], b, b, dl0);
      mma_k8(dh1, ah[2], ah[6], ah[3], ah[7], b, b, dh1);
      mma_k8(dl1, al[2], al[6], al[3], al[7], b, b, dl1);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] += (dh0[r] + dl0[r]) + (dh1[r] + dl1[r]);
    fi += 1.f;
  }
  const int col = h0 + 2 * q;
  if (ok_lo) *reinterpret_cast<float2*>(out + (t0 + g) * LM + col) = make_float2(acc[0], acc[1]);
  if (ok_hi) *reinterpret_cast<float2*>(out + (t0 + g + 8) * LM + col) = make_float2(acc[2], acc[3]);
}

bool grid_of(long long threads_total, int threads, unsigned* blocks) {
  const long long b = (threads_total + threads - 1) / threads;
  if (b > 0x7fffffffLL) return false;
  *blocks = (unsigned)b;
  return true;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// variant: 0 matmul, 1 repeat (tile), 2 jnp_repeat, 3 bcast3d. LM % 8 == 0;
// x, v and out 16-byte aligned.
extern "C" int lane_broadcast_launch(const void* x, const void* v, void* out, int T, int LM, int reps, int variant,
                                     void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  if (T <= 0) return (int)cudaSuccess;
  if (LM <= 0 || LM % 8 != 0 || reps < 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(v) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  const auto* xf = static_cast<const float*>(x);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* of = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  const long long heads = (long long)T * LM;
  unsigned blocks;
  if (variant == kMatmul) {
    const long long tasks = (long long)((T + 15) / 16) * (LM / 4);
    if (!grid_of(tasks * 32, 128, &blocks)) return (int)cudaErrorInvalidConfiguration;
    broadcast_mma_kernel<<<blocks, 128, 0, s>>>(xf, vb, of, T, LM, reps, tasks);
  } else if (variant == kJnpRepeat) {
    if (!grid_of(heads, 256, &blocks)) return (int)cudaErrorInvalidConfiguration;
    broadcast_head_kernel<<<blocks, 256, 0, s>>>(xf, vb, of, reps, heads);
  } else if (variant == kRepeat) {
    if (!grid_of(heads, 256, &blocks)) return (int)cudaErrorInvalidConfiguration;
    tile_kernel<<<blocks, 256, 0, s>>>(xf, vb, of, LM, reps, heads);
  } else if (variant == kBcast3d) {
    if (!grid_of(2 * heads, 256, &blocks)) return (int)cudaErrorInvalidConfiguration;
    broadcast_shfl_kernel<<<blocks, 256, 0, s>>>(xf, vb, of, reps, 2 * heads);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// variant: 4 r_matmul, 5 r_reshape_sum. x [T, LM * 16], out [T, LM], LM % 8 == 0;
// x and out 16-byte aligned.
extern "C" int lane_reduce_launch(const void* x, void* out, int T, int LM, int reps, int variant, void* stream) {
  (void)cudaGetLastError();
  if (T <= 0) return (int)cudaSuccess;
  if (LM <= 0 || LM % 8 != 0 || reps < 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  const long long heads = (long long)T * LM;
  unsigned blocks;
  if (variant == kRMatmul) {
    const long long tasks = (long long)((T + 15) / 16) * (LM / 8);
    if (!grid_of(tasks * 32, 128, &blocks)) return (int)cudaErrorInvalidConfiguration;
    reduce_mma_kernel<<<blocks, 128, 0, s>>>(xf, of, T, LM, reps, tasks);
  } else if (variant == kRReshapeSum) {
    if (!grid_of(heads, 256, &blocks)) return (int)cudaErrorInvalidConfiguration;
    reduce_head_kernel<<<blocks, 256, 0, s>>>(xf, of, reps, heads);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lane_broadcast_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
