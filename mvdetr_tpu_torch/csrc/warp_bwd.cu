// Bilinear-warp backward (gradient with respect to the sampled map) for Hopper (sm_90a).
//
// Replaces the TPU kernel mvdetr_tpu/ops/pallas/warp_bwd.py::_kernel
// (launched from warp_bwd_pallas). For samples taken at source pixel
// coordinates (sx, sy) [B, Q] with cotangents g [B, Q, C], it computes
//
//   grad[b, i, j, c] = sum_q R[q, i] * C[q, j] * g[b, q, c]
//
// where R and C are the separable bilinear weights of floor(sy) and floor(sx):
// each query has four taps (y0 + ty, x0 + tx), ty, tx in {0, 1}, with weights
// ry = ty ? wy1 : 1 - wy1 and cx = tx ? wx1 : 1 - wx1. Taps outside the
// H x W source vanish. The roundings are those of the plain version
// (mvdetr_tpu_torch/ops/sampling.py::bilinear_scatter_matmul): ry and cx are
// rounded to g's type, the product ry * g is rounded to g's type, each term
// cx * (ry * g) is summed in f32, and the sum is rounded to g's type once.
//
// The TPU kernel keeps a [W, H*C] accumulator in VMEM and contracts one-hot
// matrices on the MXU; that shape exists for the TPU. Here the sum is a
// gather over a sorted list, with no float atomics, so it is deterministic:
//
// 1. warp_bwd_keys_launch: one thread per (b, q, tap) writes the destination
//    cell b*H*W + y*W + x of the tap, or B*H*W for a tap outside the source.
// 2. The caller sorts the keys with a stable sort (index plumbing, not the
//    function): entries of one destination cell become one segment, in query
//    order.
// 3. warp_bwd_gather_launch: one warp per destination cell finds its segment
//    by binary search and walks it in order; lane k owns channels k, k+32, ...
//    and keeps their sums in registers.
//
// Bound on an H100 SXM: memory. On the flagship path (g [14, 43200, 128]
// bf16 -> grad [14, 90, 160, 128]) one call must read g 155 MB and the
// coordinates 4.8 MB and write 51.6 MB: ~0.063 ms at 3.35 TB/s. The
// arithmetic, 3 FLOP per (query, tap, channel) or 0.93 GFLOP, is far below.
// This first version reads each row of g once per tap (four times), and the
// sort and the keys add ~40 MB of traffic.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/warp.py). They launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPerLane = 8;  // channels per lane in one pass: 256 channels per warp

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) { return __bfloat162float(__float2bfloat16(v)); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__global__ void warp_bwd_keys_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                                     int* __restrict__ keys, int B, int H, int W, int Q, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long bq = i >> 2;
  const int tap = (int)(i & 3);
  const int b = (int)(bq / Q);
  const float xx = floorf(sx[bq]) + (float)(tap & 1);
  const float yy = floorf(sy[bq]) + (float)(tap >> 1);
  // float compares, as the plain version's one-hot compares: NaN and far-out
  // coordinates match no cell
  const bool inside = xx >= 0.f && xx <= (float)(W - 1) && yy >= 0.f && yy <= (float)(H - 1);
  keys[i] = inside ? (b * H + (int)yy) * W + (int)xx : B * H * W;
}

__device__ __forceinline__ long long lower_bound(const int* __restrict__ keys, long long n, int key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void warp_bwd_gather_kernel(const T* __restrict__ g,                 // [B, Q, C]
                                       const float* __restrict__ sx,            // [B, Q]
                                       const float* __restrict__ sy,            // [B, Q]
                                       const int* __restrict__ sorted_keys,     // [4*B*Q]
                                       const long long* __restrict__ order,     // [4*B*Q] entry (b*Q+q)*4+tap
                                       T* __restrict__ out,                     // [B, H, W, C]
                                       int C, long long num_cells, long long n) {
  const long long cell = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (cell >= num_cells) return;
  const long long lo = lower_bound(sorted_keys, n, (int)cell);
  const long long hi = lower_bound(sorted_keys, n, (int)cell + 1);
  for (int c0 = 0; c0 < C; c0 += 32 * kPerLane) {
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    for (long long s = lo; s < hi; ++s) {
      const long long e = order[s];
      const long long bq = e >> 2;
      const int tap = (int)(e & 3);
      const float x = sx[bq];
      const float y = sy[bq];
      const float wx1 = x - floorf(x);
      const float wy1 = y - floorf(y);
      const float ry = round_to<T>((tap >> 1) ? wy1 : 1.f - wy1);
      const float cx = round_to<T>((tap & 1) ? wx1 : 1.f - wx1);
      const T* gq = g + bq * C;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < C) acc[k] += cx * round_to<T>(ry * to_float(gq[c]));
      }
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < C) out[cell * C + c] = from_float<T>(acc[k]);
    }
  }
}

}  // namespace

extern "C" int warp_bwd_keys_launch(const void* sx, const void* sy, void* keys, int B, int Q, int H, int W,
                                    void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  const long long n = 4LL * B * Q;
  if (n == 0) return (int)cudaSuccess;
  if ((long long)B * H * W >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  warp_bwd_keys_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(sx), static_cast<const float*>(sy), static_cast<int*>(keys), B, H, W, Q, n);
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16 (g and out)
extern "C" int warp_bwd_gather_launch(const void* g, const void* sx, const void* sy, const void* sorted_keys,
                                      const void* order, void* out, int B, int Q, int H, int W, int C, int dtype,
                                      void* stream) {
  (void)cudaGetLastError();
  const long long num_cells = (long long)B * H * W;
  const long long n = 4LL * B * Q;
  if (num_cells == 0 || C == 0) return (int)cudaSuccess;
  const int threads = 256;  // 8 warps, one destination cell each
  const long long blocks = (num_cells * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (dtype == 0) {
    warp_bwd_gather_kernel<float><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(g), static_cast<const float*>(sx), static_cast<const float*>(sy),
        static_cast<const int*>(sorted_keys), static_cast<const long long*>(order), static_cast<float*>(out), C,
        num_cells, n);
  } else if (dtype == 1) {
    warp_bwd_gather_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(sx), static_cast<const float*>(sy),
        static_cast<const int*>(sorted_keys), static_cast<const long long*>(order),
        static_cast<__nv_bfloat16*>(out), C, num_cells, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* warp_bwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
