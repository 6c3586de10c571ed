// The lane broadcast / reduce experiment for Hopper (sm_90a).
//
// Replaces the TPU microbenchmark scripts/exp_vpu_broadcast.py::_bench and its
// six kernel bodies (k_matmul :81, k_repeat :89, k_jnp_repeat :96,
// k_bcast3d :103, r_matmul :125, r_reshape_sum :132). In the windowed
// attention kernels each (level, head) weight is broadcast over its head's
// D = 16 channel lanes, and per-channel products are summed back over them;
// the experiment times ways of doing those two steps. With LM = L*M heads of
// all levels, LK = LM * D, and i recomputed in every repetition:
//
//   broadcast  out[t, k] = sum_{i < reps} (x[t, k / D] + i) * f32(v[t, k])    x [T, LM] f32, v [T, LK] bf16
//   tile       out[t, k] = sum_{i < reps} (x[t, k % LM] + i) * f32(v[t, k])   (the TPU body's pltpu.repeat tiles)
//   reduce     out[t, j] = sum_{i < reps} sum_{d < D} (x[t, j * D + d] + i)    x [T, LK] f32 -> [T, LM]
//
// Each repetition is real work, taken in ascending i and added into an f32
// accumulator; reps is a run-time argument, so no repetition can be folded
// into another. i is carried as a float counter (exact below 2^24, which the
// wrapper checks), so no repetition pays an integer-to-float conversion.
// Every variant loads its inputs from device memory once, into registers,
// and lowers one TPU body the Hopper way:
//
//   matmul        (x + i) @ E on the tensor cores: mma.sync m16n8k8 in tf32,
//                 written in PTX, with E's 0/1 fragments made in registers.
//                 E is block diagonal, so a warp takes 16 rows and 8 heads
//                 (K = 8) for 64 output columns. x + i is split into a tf32
//                 high part and the tf32 rounding of the rest: two MMAs per
//                 tile give x + i to within f32 rounding (E is exact in tf32).
//   jnp_repeat    one thread per output lane; each lane loads x[t, k / D] itself.
//   bcast3d       one thread per output lane; the first lane of each 16-lane
//                 head group loads x, and every repetition broadcasts x + i to
//                 the group with __shfl_sync(..., width 16).
//   repeat        the tile: one thread per output lane, loading x[t, k % LM].
//   r_matmul      (x + i) @ E^T on the tensor cores, as matmul: a warp takes
//                 16 rows and 8 heads (K = 128 in 16 steps of 8), tf32 hi/lo
//                 split; each repetition's product starts from zero and is
//                 added into the f32 accumulator.
//   r_reshape_sum one thread per input lane; a 16-lane __shfl_xor_sync
//                 butterfly (8, 4, 2, 1) sums each head's lanes.
//
// Bound on an H100 SXM: operations. Per launch the broadcast does
// reps * T * (2 * LK + LM) FLOP on T * (4 LM + 6 LK) bytes; at T = 151,200
// and 81 repetitions that is 22.6 GFLOP (0.338 ms at 67 TFLOP/s) against
// 847 MB (0.253 ms at 3.35 TB/s). The reduce does reps * T * 2 * LK FLOP
// (21.9 GFLOP, 0.328 ms) on 576 MB. A simple kernel that is right: the
// per-lane forms do the head's x + i once in every lane (16 times the
// bound's count), and the tensor-core forms add the tf32 split.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/lane_broadcast.py). They
// launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 16;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kMatmul = 0, kRepeat = 1, kJnpRepeat = 2, kBcast3d = 3, kRMatmul = 4, kRReshapeSum = 5 };

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// d = a (16x8, row) * b (8x8, col) + c, tf32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]), "f"(c[2]),
        "f"(c[3]));
}

// x + i as a tf32 high part and the tf32 rounding of the rest.
__device__ __forceinline__ void split_tf32(const float (&x)[4], float fi, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float a = x[r] + fi;
    hi[r] = to_tf32(a);
    lo[r] = to_tf32(a - __uint_as_float(hi[r]));
  }
}

// One thread per output lane n = t * LK + k (LK a multiple of 32, so a warp
// never straddles the end and the 16-lane groups are whole heads).
template <int kVariant>
__global__ void broadcast_lanes_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ v,
                                       float* __restrict__ out, int LM, int reps, long long n_total) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_total) return;  // whole warps only
  const int LK = LM * kD;
  const long long t = n / LK;
  const int k = (int)(n - t * LK);
  const float vf = __bfloat162float(v[n]);
  float acc = 0.f;
  if (kVariant == kBcast3d) {
    const float xv = (threadIdx.x & (kD - 1)) == 0 ? x[t * LM + k / kD] : 0.f;
    float fi = 0.f;
    for (int i = 0; i < reps; ++i, fi += 1.f) {
      const float s = __shfl_sync(kFull, xv + fi, 0, kD);
      acc = fmaf(s, vf, acc);
    }
  } else {
    const float xv = x[t * LM + (kVariant == kRepeat ? k % LM : k / kD)];
    float fi = 0.f;
    for (int i = 0; i < reps; ++i, fi += 1.f) acc = fmaf(xv + fi, vf, acc);
  }
  out[n] = acc;
}

// Tensor-core broadcast. Warp task: rows t0 .. t0+15, heads h0 .. h0+7
// (K = 8), half `half` of their 128 output columns (8 n-tiles of 8).
// Fragment layout of m16n8k8 (g = lane / 4, q = lane % 4): A a0 (g, q),
// a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4); B b0 (k=q, n=g), b1 (k=q+4, n=g);
// C c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1).
__global__ void broadcast_mma_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ v,
                                     float* __restrict__ out, int T, int LM, int reps, long long n_tasks) {
  const long long task = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (task >= n_tasks) return;  // whole warps only
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int half = (int)(task & 1);
  const int blocks_per_row = LM / 8;
  const int h0 = (int)((task >> 1) % blocks_per_row) * 8;
  const long long t0 = ((task >> 1) / blocks_per_row) * 16;
  const int LK = LM * kD;
  const bool ok_lo = t0 + g < T, ok_hi = t0 + g + 8 < T;

  float xa[4];
  xa[0] = ok_lo ? x[(t0 + g) * LM + h0 + q] : 0.f;
  xa[1] = ok_hi ? x[(t0 + g + 8) * LM + h0 + q] : 0.f;
  xa[2] = ok_lo ? x[(t0 + g) * LM + h0 + q + 4] : 0.f;
  xa[3] = ok_hi ? x[(t0 + g + 8) * LM + h0 + q + 4] : 0.f;

  float vv[8][4], acc[8][4];
  uint32_t b0[8], b1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int tile = half * 8 + j;       // n-tile among the block's 16
    const int head = tile >> 1;          // its head, relative to h0: E's only 1 in this tile's rows
    b0[j] = q == head ? 0x3f800000u : 0u;  // 1.0f is exact in tf32
    b1[j] = q + 4 == head ? 0x3f800000u : 0u;
    const int col = h0 * kD + tile * 8 + 2 * q;
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
  for (int i = 0; i < reps; ++i, fi += 1.f) {
    uint32_t hi[4], lo[4];
    split_tf32(xa, fi, hi, lo);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d[4];
      mma_tf32(d, hi, b0[j], b1[j], zero);
      mma_tf32(d, lo, b0[j], b1[j], d);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = fmaf(d[r], vv[j][r], acc[j][r]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = h0 * kD + (half * 8 + j) * 8 + 2 * q;
    if (ok_lo) *reinterpret_cast<float2*>(out + (t0 + g) * LK + col) = make_float2(acc[j][0], acc[j][1]);
    if (ok_hi) *reinterpret_cast<float2*>(out + (t0 + g + 8) * LK + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// One thread per input lane; a head's 16 lanes are one aligned 16-lane group.
__global__ void reduce_shuffle_kernel(const float* __restrict__ x, float* __restrict__ out, int reps,
                                      long long n_total) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_total) return;  // whole warps only
  const float xv = x[n];
  float acc = 0.f;
  float fi = 0.f;
  for (int i = 0; i < reps; ++i, fi += 1.f) {
    float s = xv + fi;
    s += __shfl_xor_sync(kFull, s, 8, kD);
    s += __shfl_xor_sync(kFull, s, 4, kD);
    s += __shfl_xor_sync(kFull, s, 2, kD);
    s += __shfl_xor_sync(kFull, s, 1, kD);
    acc += s;
  }
  if ((threadIdx.x & (kD - 1)) == 0) out[n / kD] = acc;
}

// Tensor-core reduce. Warp task: rows t0 .. t0+15, heads h0 .. h0+7: one
// 16x8 output tile over K = 128 input lanes in 16 steps of 8. Step s covers
// lanes h0*16 + 8s .. +7, all of head h0 + s/2, so E^T's fragment is
// b0 = b1 = (g == s/2).
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

  float xa[16][4];
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const int col = h0 * kD + 8 * s + q;
    xa[s][0] = ok_lo ? x[(t0 + g) * LK + col] : 0.f;
    xa[s][1] = ok_hi ? x[(t0 + g + 8) * LK + col] : 0.f;
    xa[s][2] = ok_lo ? x[(t0 + g) * LK + col + 4] : 0.f;
    xa[s][3] = ok_hi ? x[(t0 + g + 8) * LK + col + 4] : 0.f;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float fi = 0.f;
  for (int i = 0; i < reps; ++i, fi += 1.f) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const uint32_t b = g == (s >> 1) ? 0x3f800000u : 0u;
      uint32_t hi[4], lo[4];
      split_tf32(xa[s], fi, hi, lo);
      mma_tf32(d, hi, b, b, d);
      mma_tf32(d, lo, b, b, d);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] += d[r];
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

}  // namespace

// variant: 0 matmul, 1 repeat (tile), 2 jnp_repeat, 3 bcast3d. LM % 8 == 0.
extern "C" int lane_broadcast_launch(const void* x, const void* v, void* out, int T, int LM, int reps, int variant,
                                     void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  if (T <= 0) return (int)cudaSuccess;
  if (LM <= 0 || LM % 8 != 0 || reps < 0) return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* of = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks;
  if (variant == kMatmul) {
    const long long tasks = (long long)((T + 15) / 16) * (LM / 8) * 2;
    if (!grid_of(tasks * 32, 128, &blocks)) return (int)cudaErrorInvalidConfiguration;
    broadcast_mma_kernel<<<blocks, 128, 0, s>>>(xf, vb, of, T, LM, reps, tasks);
    return (int)cudaGetLastError();
  }
  const long long n = (long long)T * LM * kD;
  if (!grid_of(n, 256, &blocks)) return (int)cudaErrorInvalidConfiguration;
  if (variant == kRepeat) {
    broadcast_lanes_kernel<kRepeat><<<blocks, 256, 0, s>>>(xf, vb, of, LM, reps, n);
  } else if (variant == kJnpRepeat) {
    broadcast_lanes_kernel<kJnpRepeat><<<blocks, 256, 0, s>>>(xf, vb, of, LM, reps, n);
  } else if (variant == kBcast3d) {
    broadcast_lanes_kernel<kBcast3d><<<blocks, 256, 0, s>>>(xf, vb, of, LM, reps, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// variant: 4 r_matmul, 5 r_reshape_sum. x [T, LM * 16], out [T, LM], LM % 8 == 0.
extern "C" int lane_reduce_launch(const void* x, void* out, int T, int LM, int reps, int variant, void* stream) {
  (void)cudaGetLastError();
  if (T <= 0) return (int)cudaSuccess;
  if (LM <= 0 || LM % 8 != 0 || reps < 0) return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks;
  if (variant == kRMatmul) {
    const long long tasks = (long long)((T + 15) / 16) * (LM / 8);
    if (!grid_of(tasks * 32, 128, &blocks)) return (int)cudaErrorInvalidConfiguration;
    reduce_mma_kernel<<<blocks, 128, 0, s>>>(xf, of, T, LM, reps, tasks);
  } else if (variant == kRReshapeSum) {
    const long long n = (long long)T * LM * kD;
    if (!grid_of(n, 256, &blocks)) return (int)cudaErrorInvalidConfiguration;
    reduce_shuffle_kernel<<<blocks, 256, 0, s>>>(xf, of, reps, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lane_broadcast_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
