// Windowed deformable-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mvdetr_tpu/ops/pallas/msda_kernel.py::_kernel
// (launched from msda_windowed_pallas_prepped). It computes, for every query
// (b, c, y, x) and channel (m, d) of K = M*D,
//
//   out[b,c,y,x,m*D+d] = sum_{l,p} w[b,c,y,x,m,l,p]
//                        * bilinear(value[b,l,:,:,m,d], x + clamp(ox,+-R), y + clamp(oy,+-R))
//
// with zero outside the H x W grid and the sum kept in f32. The TPU kernel
// sums (2R+1)^2 shifted windows with hat weights through selection matmuls
// and 128-lane padding, which exist only for Mosaic and VMEM. For a clamped
// offset that sum is exactly a 4-tap bilinear gather, so this kernel gathers
// the 4 taps directly: 4 instead of 81 taps per sample at R = 4, and any
// radius, any W and any K <= 1024 without padding.
//
// Bound on an H100 SXM: memory. At the flagship shape (B=2, L=C=7, 60x180,
// M=8, D=16, P=4) one call reads offsets 271 MB and weights 135 MB (f32) and
// value 38.7 MB (bf16), and writes 77 MB of f32 output: ~522 MB, ~0.156 ms at
// 3.35 TB/s. The arithmetic, 10 FLOP per (query, channel, sample) or 5.4
// GFLOP, takes ~0.08 ms at the 67 TFLOP/s f32 rate.
//
// Design. One block serves `qpb` consecutive queries (qpb = 256 / K, at least
// 1), with K threads per query: thread t owns channel (m = t / D, d = t % D).
// The block first copies its queries' offsets (M*L*P*2 f32) and weights
// (M*L*P f32) into shared memory with coalesced loads, since consecutive
// queries are contiguous in both arrays; every offset and weight byte is read
// from device memory once. Each thread then loops over (l, p): it clamps the
// offset to +-R, splits it into floor and fraction (from the offset itself, not
// from x + ox, so the fractions equal the TPU kernel's hat weights), reads up to
// 4 bf16 taps masked at the grid edge, and accumulates in f32. The 16 lanes of
// one head read 32 contiguous bytes per tap; the value tensor (38.7 MB at the
// flagship) is re-read by neighbouring queries and is served from the 50 MB
// L2. Each thread writes its f32 result once, 128 contiguous floats per query.
//
// Interface: a plain C function, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/msda_windowed.py). It launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void msda_windowed_fwd_kernel(const __nv_bfloat16* __restrict__ value,  // [B, L, H, W, K]
                                         const float* __restrict__ offsets,        // [B, C, H, W, M, L, P, 2]
                                         const float* __restrict__ weights,        // [B, C, H, W, M, L, P]
                                         float* __restrict__ out,                  // [B, C, H, W, K]
                                         int C, int L, int H, int W, int M, int D, int P, float radius,
                                         int qpb, long long num_queries) {
  extern __shared__ float smem[];
  const int K = M * D;
  const int mlp = M * L * P;
  const long long q0 = (long long)blockIdx.x * qpb;
  const long long left = num_queries - q0;
  const int nq = left < qpb ? (int)left : qpb;

  float* s_off = smem;                   // [qpb, M*L*P*2]
  float* s_w = smem + (size_t)qpb * mlp * 2;  // [qpb, M*L*P]
  const float* g_off = offsets + q0 * mlp * 2;
  const float* g_w = weights + q0 * mlp;
  for (int i = threadIdx.x; i < nq * mlp * 2; i += blockDim.x) s_off[i] = g_off[i];
  for (int i = threadIdx.x; i < nq * mlp; i += blockDim.x) s_w[i] = g_w[i];
  __syncthreads();

  const int qi = threadIdx.x / K;
  if (qi >= nq) return;
  const int t = threadIdx.x - qi * K;
  const int m = t / D;
  const long long q = q0 + qi;  // ((b * C + c) * H + y) * W + x
  const int x = (int)(q % W);
  const int y = (int)((q / W) % H);
  const long long b = q / ((long long)W * H * C);

  const float* so = s_off + (size_t)qi * mlp * 2 + (size_t)m * L * P * 2;
  const float* sw = s_w + (size_t)qi * mlp + (size_t)m * L * P;
  const long long row = (long long)W * K;
  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const __nv_bfloat16* v = value + (b * L + l) * H * row + t;
    for (int p = 0; p < P; ++p) {
      const int s = l * P + p;
      const float ox = fminf(fmaxf(so[2 * s], -radius), radius);
      const float oy = fminf(fmaxf(so[2 * s + 1], -radius), radius);
      const float wgt = sw[s];
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
      const long long base = (long long)y0 * row + (long long)x0 * K;
      float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
      if (ya && xa) v00 = __bfloat162float(v[base]);
      if (ya && xb) v01 = __bfloat162float(v[base + K]);
      if (yb && xa) v10 = __bfloat162float(v[base + row]);
      if (yb && xb) v11 = __bfloat162float(v[base + row + K]);
      const float top = (1.f - fx) * v00 + fx * v01;
      const float bot = (1.f - fx) * v10 + fx * v11;
      acc += wgt * ((1.f - fy) * top + fy * bot);
    }
  }
  out[q * K + t] = acc;
}

}  // namespace

extern "C" int msda_windowed_fwd_launch(const void* value, const void* offsets, const void* weights, void* out,
                                        int B, int C, int L, int H, int W, int M, int D, int P, int radius,
                                        void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  const int K = M * D;
  if (K <= 0 || K > 1024 || radius < 0) return (int)cudaErrorInvalidValue;
  const long long num_queries = (long long)B * C * H * W;
  if (num_queries == 0) return (int)cudaSuccess;
  int qpb = 256 / K;
  if (qpb < 1) qpb = 1;
  const size_t smem = (size_t)qpb * M * L * P * 3 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(msda_windowed_fwd_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (num_queries + qpb - 1) / qpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  msda_windowed_fwd_kernel<<<(unsigned)blocks, qpb * K, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(offsets),
      static_cast<const float*>(weights), static_cast<float*>(out), C, L, H, W, M, D, P, (float)radius, qpb,
      num_queries);
  return (int)cudaGetLastError();
}

extern "C" const char* msda_windowed_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
