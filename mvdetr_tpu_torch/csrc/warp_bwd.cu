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
// H x W source vanish, by float compares (NaN and far-out coordinates match
// no cell). The roundings are those of the plain version
// (mvdetr_tpu_torch/ops/sampling.py::bilinear_scatter_matmul): ry and cx are
// rounded to g's type, the product ry * g is rounded to g's type, each term
// cx * (ry * g) is summed in f32, and the sum is rounded to g's type once.
//
// The TPU kernel keeps a [W, H*C] accumulator in VMEM and contracts one-hot
// matrices on the MXU; that shape exists for the TPU. Here the sum is a
// gather over a sorted list of (cell, entry) pairs, with no float atomics:
// each cell adds its terms in ascending (b, q, tap) order, so the result
// does not change from run to run.
//
// Bound on an H100 SXM: memory. On the flagship path (g [14, 43200, 128]
// bf16 -> grad [14, 90, 160, 128]) one call must read g 155 MB and the
// coordinates 4.8 MB and write 51.6 MB: ~0.063 ms at 3.35 TB/s. The
// arithmetic, 3 FLOP per (query, tap, channel) or 0.93 GFLOP, is far below.
//
// The first design (a keys pass, a stable torch.sort, one warp per cell)
// took ~0.88 ms there (0.74 ms of device time). What held it: each warp
// found its segment with two binary searches over all 2.42 M sorted keys
// (~2 x 21 dependent loads, also for the 61% of cells that get no tap), then
// walked the segment one entry at a time, each a chain of three dependent
// loads (order, coordinates, a g row read as 2-byte scalars); and the sort
// took full 32-bit keys with int64 indices. This design, four kernels on the
// caller's stream (warp_bwd_launch):
//
// 1. keys: one thread per entry e = (b*Q + q)*4 + tap writes its destination
//    cell b*H*W + y*W + x, or the sentinel B*H*W for a tap outside, and e.
// 2. sort: CUB's radix sort (stable) of the pairs over the low end_bit bits
//    only, end_bit = bit_length(B*H*W), the sentinel included: 18 bits and
//    3 digit passes at the flagship, with int32 values.
// 3. starts: a boundary pass, one thread per sorted position s, writes
//    start[k] = s for every k in (key[s-1], key[s]], so a cell's segment is
//    [start[k], start[k+1]) with no search; a range longer than a warp (a
//    run of empty cells) is written by the whole warp.
// 4. gather: one warp per cell, in cell order. An empty cell writes zeros.
//    Otherwise the warp reads 32 consecutive sorted entries in one coalesced
//    load; each lane turns its entry into a record (g row, ry, cx) in shared
//    memory, which every lane then reads at once (a broadcast, one load in
//    place of three shuffles). The warp walks the records in order, kUnroll
//    at a time: their g rows are loaded before any is added, and each lane
//    adds its channels' terms in order. A lane owns 4 channels (8 bytes of
//    bf16, 16 of f32) when C % 4 == 0 and g is aligned, else one; C wider
//    than a warp's channels takes more passes over the segment. In bf16 two
//    products are rounded by one conversion (cvt.rn.bf16x2.f32).
//
// What holds the gather now (altered copies timed on an H100): its 1.79 M
// g-row reads from L2, 458 MB, four per query (without them it takes under
// half its time). Tiles of cells per block for L1 reuse, more loads in
// flight (in registers, or by cp.async into shared memory), and one warp
// per 2x2 tile of cells (a 16-bit sort, but four times longer walks) were
// all slower.
//
// f32 arithmetic is written with explicit intrinsics (the first design's
// SASS: FMUL, then FFMA into the sum), so the bits equal the first design's;
// in bf16 each term is exact in f32, so they would whatever the contraction.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/warp.py). They launch on the
// caller's stream, allocate nothing (the caller passes the scratch buffers
// and the sort's temporary storage, sized by warp_bwd_temp_bytes), and
// return the first CUDA error.

// CUB's kernels get this namespace, so that traces and build logs tell them from torch.sort's
#define CUB_WRAPPED_NAMESPACE warp_bwd_cub
#define THRUST_WRAPPED_NAMESPACE warp_bwd_cub
#include <cub/device/device_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps a block, one cell each in the gather
constexpr int kUnroll = 4;     // g rows in flight per warp: 8 and 16 were slower (registers)
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) { return __bfloat162float(__float2bfloat16(v)); }

// A lane's V channels of one g row: loaded raw, unpacked to f32, and the
// sums stored back in T.
template <typename T, int V>
struct Lane;

template <>
struct Lane<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint2*>(p); }
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[4]) {
    const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16(a[0]), __float2bfloat16(a[1]));
    const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16(a[2]), __float2bfloat16(a[3]));
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

template <>
struct Lane<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

template <>
struct Lane<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw zero() { return __float2bfloat16(0.f); }
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return *p; }
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[1]) { v[0] = __bfloat162float(r); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[1]) { *p = __float2bfloat16(a[0]); }
};

template <>
struct Lane<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw zero() { return 0.f; }
  static __device__ __forceinline__ Raw load(const float* p) { return *p; }
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[1]) { v[0] = r; }
  static __device__ __forceinline__ void store(float* p, const float (&a)[1]) { *p = a[0]; }
};

__global__ void __launch_bounds__(kThreads) warp_bwd_keys_kernel(const float* __restrict__ sx,
                                                                  const float* __restrict__ sy,
                                                                  unsigned* __restrict__ keys, int* __restrict__ order,
                                                                  int B, int H, int W, int Q, int n) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int i = (int)t;
  const int bq = i >> 2;
  const int tap = i & 3;
  const int b = bq / Q;
  const float xx = floorf(sx[bq]) + (float)(tap & 1);
  const float yy = floorf(sy[bq]) + (float)(tap >> 1);
  // float compares, as the plain version's one-hot compares: NaN and far-out
  // coordinates match no cell
  const bool inside = xx >= 0.f && xx <= (float)(W - 1) && yy >= 0.f && yy <= (float)(H - 1);
  keys[i] = inside ? (unsigned)((b * H + (int)yy) * W + (int)xx) : (unsigned)(B * H * W);
  order[i] = i;
}

// start[k] = the first sorted position whose key is >= k, for k in [0, num_cells].
// Thread s in [0, n] writes s over (key[s-1], key[s]] (key[-1] = -1,
// key[n] = num_cells), so every k is written once. Every thread of a warp
// takes part in the ballot.
__global__ void __launch_bounds__(kThreads) warp_bwd_starts_kernel(const unsigned* __restrict__ sorted_keys,
                                                                    int* __restrict__ start, int n, int num_cells) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int s = (int)min(t, (long long)n);
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = -1;  // the range [lo, hi] this thread writes
  if (t <= n) {
    lo = (s == 0 ? -1 : (int)sorted_keys[s - 1]) + 1;
    hi = s == n ? num_cells : (int)sorted_keys[s];
  }
  const int len = hi - lo + 1;
  if (len > 0 && len <= 32) {
    for (int k = lo; k <= hi; ++k) start[k] = s;
  }
  unsigned wide = __ballot_sync(kFull, len > 32);
  while (wide) {
    const int src = __ffs(wide) - 1;
    wide &= wide - 1;
    const int wlo = __shfl_sync(kFull, lo, src);
    const int whi = __shfl_sync(kFull, hi, src);
    const int ws = __shfl_sync(kFull, s, src);
    for (int k = wlo + lane; k <= whi; k += 32) start[k] = ws;
  }
}

// The products r * g of a lane's V channels, each rounded to T (bf16: two
// at a time by one cvt.rn.bf16x2.f32).
template <typename T, int V>
__device__ __forceinline__ void scaled_rounded(float r, const float (&gv)[V], float (&p)[V]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && V % 2 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(r, gv[v]), __fmul_rn(r, gv[v + 1]));
      const unsigned u = *reinterpret_cast<const unsigned*>(&h);
      p[v] = __uint_as_float(u << 16);
      p[v + 1] = __uint_as_float(u & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = round_to<T>(__fmul_rn(r, gv[v]));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) warp_bwd_gather_kernel(const T* __restrict__ g,        // [B, Q, C]
                                                                    const float* __restrict__ sx,  // [B, Q]
                                                                    const float* __restrict__ sy,  // [B, Q]
                                                                    const int* __restrict__ order,  // sorted entries
                                                                    const int* __restrict__ start,  // [num_cells + 1]
                                                                    T* __restrict__ out,            // [B, H, W, C]
                                                                    int C, int num_cells) {
  using L = Lane<T, V>;
  // a batch's entries as (g row, ry, cx), read back by every lane at once (a broadcast)
  __shared__ int4 batch[kThreads / 32][32];
  const int cell = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (cell >= num_cells) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  int4* rec = batch[threadIdx.x >> 5];
  const int lo = start[cell];
  const int hi = start[cell + 1];
  T* dst = out + (long long)cell * C;
  for (int c0 = 0; c0 < C; c0 += 32 * V) {
    const int c = c0 + lane * V;
    const bool active = c < C;  // V = 4 only when C % 4 == 0: a lane's vector is whole or outside
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int base = lo; base < hi; base += 32) {
      const int cnt = min(32, hi - base);
      if (lane < cnt) {
        const int e = order[base + lane];
        const int row = e >> 2;
        const int tap = e & 3;
        const float x = sx[row];
        const float y = sy[row];
        const float wx1 = x - floorf(x);
        const float wy1 = y - floorf(y);
        rec[lane] = make_int4(row, __float_as_int(round_to<T>((tap >> 1) ? wy1 : 1.f - wy1)),
                              __float_as_int(round_to<T>((tap & 1) ? wx1 : 1.f - wx1)), 0);
      }
      __syncwarp();
      for (int t0 = 0; t0 < cnt; t0 += kUnroll) {  // t0 + u < 32: kUnroll divides 32
        typename L::Raw raw[kUnroll];
        float r[kUnroll], w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int4 e = rec[t0 + u];
          r[u] = __int_as_float(e.y);
          w[u] = __int_as_float(e.z);
          raw[u] = (active && t0 + u < cnt) ? L::load(g + (long long)e.x * C + c) : L::zero();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u < cnt) {  // the same for the whole warp
            float gv[V], p[V];
            L::unpack(raw[u], gv);
            scaled_rounded<T, V>(r[u], gv, p);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = __fmaf_rn(w[u], p[v], acc[v]);
          }
        }
      }
      __syncwarp();  // every lane has read the batch before the next one is written
    }
    if (active) L::store(dst + c, acc);
  }
}

template <typename T>
void launch_gather(const void* g, const void* sx, const void* sy, const int* order, const int* start, void* out,
                   int C, int num_cells, bool vec4, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((num_cells + kThreads / 32 - 1) / (kThreads / 32));
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  const float* fx = static_cast<const float*>(sx);
  const float* fy = static_cast<const float*>(sy);
  if (vec4) {
    warp_bwd_gather_kernel<T, 4><<<blocks, kThreads, 0, stream>>>(gt, fx, fy, order, start, ot, C, num_cells);
  } else {
    warp_bwd_gather_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(gt, fx, fy, order, start, ot, C, num_cells);
  }
}

bool sizes_ok(int B, int Q, int H, int W, int end_bit) {
  const long long n = 4LL * B * Q;
  const long long num_cells = (long long)B * H * W;
  return B >= 0 && Q >= 0 && H > 0 && W > 0 && n < 0x7fffffffLL && num_cells < 0x7fffffffLL && end_bit >= 1 &&
         end_bit <= 32 && (num_cells >> end_bit) == 0;
}

}  // namespace

// Bytes of temporary storage the sort needs for n pairs of end_bit-bit keys.
extern "C" int warp_bwd_temp_bytes(int n, int end_bit, size_t* bytes) {
  (void)cudaGetLastError();
  *bytes = 0;
  return (int)CUB_NS_QUALIFIER::DeviceRadixSort::SortPairs(
      nullptr, *bytes, static_cast<const unsigned*>(nullptr), static_cast<unsigned*>(nullptr),
      static_cast<const int*>(nullptr), static_cast<int*>(nullptr), n, 0, end_bit);
}

// keys, keys_sorted, order, order_sorted: 4*B*Q each (unsigned / int32);
// start: B*H*W + 1 int32; temp: temp_bytes from warp_bwd_temp_bytes(4*B*Q,
// end_bit). end_bit must cover the sentinel B*H*W. dtype: 0 = f32, 1 = bf16
// (g and out).
extern "C" int warp_bwd_launch(const void* g, const void* sx, const void* sy, void* out, void* keys,
                               void* keys_sorted, void* order, void* order_sorted, void* start, void* temp,
                               size_t temp_bytes, int B, int Q, int H, int W, int C, int dtype, int end_bit,
                               void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  if (!sizes_ok(B, Q, H, W, end_bit) || C < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int n = 4 * B * Q;
  const int num_cells = B * H * W;
  if (num_cells == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* k_in = static_cast<unsigned*>(keys);
  unsigned* k_out = static_cast<unsigned*>(keys_sorted);
  int* o_in = static_cast<int*>(order);
  int* o_out = static_cast<int*>(order_sorted);
  int* starts = static_cast<int*>(start);
  cudaError_t err = cudaSuccess;
  if (n > 0) {
    warp_bwd_keys_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(sx), static_cast<const float*>(sy), k_in, o_in, B, H, W, Q, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    size_t bytes = temp_bytes;
    err = CUB_NS_QUALIFIER::DeviceRadixSort::SortPairs(temp, bytes, k_in, k_out, o_in, o_out, n, 0, end_bit, st);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  warp_bwd_starts_kernel<<<(unsigned)(((long long)n + kThreads) / kThreads), kThreads, 0, st>>>(k_out, starts, n,
                                                                                                num_cells);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t align = (dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16)) * 4;
  const bool vec4 =
      C % 4 == 0 && reinterpret_cast<size_t>(g) % align == 0 && reinterpret_cast<size_t>(out) % align == 0;
  if (dtype == 0) {
    launch_gather<float>(g, sx, sy, o_out, starts, out, C, num_cells, vec4, st);
  } else {
    launch_gather<__nv_bfloat16>(g, sx, sy, o_out, starts, out, C, num_cells, vec4, st);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* warp_bwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
