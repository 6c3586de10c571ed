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
// Arithmetic, per channel: the offset is clamped to +-R before floorf, the
// fraction comes from the clamped offset itself (not from x + ox), taps
// outside the grid are 0, and
//   acc += w * ((1-fy)*((1-fx)*v00 + fx*v01) + fy*((1-fx)*v10 + fx*v11))
// in (l, p) order. Every tiling below gives each channel exactly these
// operations in this order, so every plan gives the same bits.
//
// Bound on an H100 SXM: memory. At the flagship shape (B=2, L=C=7, 60x180,
// M=8, D=16, P=4) one call reads offsets 271 MB and weights 135 MB (f32) and
// value 38.7 MB (bf16), and writes 77 MB of f32 output: ~522 MB, ~0.156 ms at
// 3.35 TB/s. The arithmetic, 10 FLOP per (query, channel, sample) or 5.4
// GFLOP, takes ~0.08 ms at the 67 TFLOP/s f32 rate. So the offsets and
// weights must stream at close to full bandwidth, and the value gathers
// (4 taps x 28 samples per query and channel) must be served on chip.
//
// Design. A block owns a tile of tile_y x tile_x queries of one (b, c) and
// one head m; blocks of the same tile and the other heads are adjacent in
// the grid, so together they read each query's offsets and weights as one
// contiguous run. A thread owns one query and VEC consecutive channels of
// the head (VEC = 8 when D % 8 == 0: one 16-byte load per tap, so a warp
// serves 16 (query, head) pairs; else 4, 2 or 1 channels with 8-, 4- or
// 2-byte loads), with VEC f32 accumulators. It walks the levels l in order
// and loads its P offset pairs and P weights of level l+1 (two and one
// 16-byte loads for P = 4) into registers while it gathers level l, so the
// 406 MB of offsets and weights stream behind the gathers with no shared
// memory and no barrier. Taps are read through L1, with edge tests, at
// 32-bit offsets from the query's own cell; the P = 4 samples are unrolled
// (a generic loop otherwise). Each thread writes its VEC outputs once. No
// atomics.
//
// What holds it, on an H100 80GB HBM3 at 700 W (PERF.md, measured with
// mvdetr_tpu_torch/scripts/msda_vs_source.py): ~0.68 ms at the flagship
// shape, ~4.4x the bound, against ~2.13 ms for the one thread per channel
// with scalar taps that it replaced, with the same bits. Two things, about
// equally: instruction issue (each sample costs a thread the f32 blend, 7
// operations a channel, and the bf16 unpacking, 4 a channel, before clamps,
// edge tests and addresses: a copy of this source with no tap load still
// takes ~0.46 ms), and L1 wavefronts, one per (query, head, tap), since a
// head's 32 bytes of a cell share no 128-byte line with another query's
// taps in the [B, L, H, W, M, D] layout. At large R the taps spread wider,
// so a tile of twice the queries shares more lines. Staging the tile's
// value halo, or its offsets, in shared memory with cp.async, and one
// thread per head (two 16-byte loads a tap) were each slower on the card,
// at R = 4 and R = 16.
//
// Row halo (the BEV-row-sharded path, mvdetr_tpu_torch/ops/msda_sharded.py,
// as the TPU kernel's row_halo mode): the value holds Hv = H + 2R rows for the
// H query rows, its first and last R rows real rows of the neighbouring
// shards. A query at row y then reads value row y + row_org (row_org = R; 0
// without a halo, Hv = H) and a tap's row is tested against Hv, not H; the
// columns keep their zero padding. Nothing else changes, so a halo of zero
// rows gives the zero-padded call's bits.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/msda_windowed.py, whose
// _fwd_plan chooses VEC and the tile; the launcher checks the plan again).
// They launch on the caller's stream, allocate nothing, and return a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// threads per block: a thread owns VEC channels of one query's head, so a
// narrow VEC on a wide head may need up to 1024 for one query
template <int VEC> constexpr int max_threads() { return VEC <= 2 ? 1024 : 256; }

// VEC bf16 values as one load
template <int VEC> struct Raw;
template <> struct Raw<8> { using T = uint4; };
template <> struct Raw<4> { using T = uint2; };
template <> struct Raw<2> { using T = unsigned; };
template <> struct Raw<1> { using T = unsigned short; };

// bf16 -> f32 is exact: the bf16 bits in the high half of the f32 word
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <int VEC>
__device__ __forceinline__ void unpack(const typename Raw<VEC>::T& r, float* f) {
  if constexpr (VEC == 8) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = lo_bf16(w[k]);
      f[2 * k + 1] = hi_bf16(w[k]);
    }
  } else if constexpr (VEC == 4) {
    f[0] = lo_bf16(r.x);
    f[1] = hi_bf16(r.x);
    f[2] = lo_bf16(r.y);
    f[3] = hi_bf16(r.y);
  } else if constexpr (VEC == 2) {
    f[0] = lo_bf16(r);
    f[1] = hi_bf16(r);
  } else {
    f[0] = lo_bf16((unsigned)r);
  }
}

// VEC channels of a tap, or zeros for a tap outside the grid
template <int VEC>
__device__ __forceinline__ typename Raw<VEC>::T ldg_or_zero(const __nv_bfloat16* p, bool inside) {
  typename Raw<VEC>::T r{};
  if (inside) r = __ldg(reinterpret_cast<const typename Raw<VEC>::T*>(p));
  return r;
}

// PT = 4: P is 4 and the offsets and weights are 16-byte aligned, so a
// level's samples of a (query, head) are two and one float4 loads; PT = 0:
// any P, scalar loads.
template <int VEC, int PT>
__global__ void __launch_bounds__(max_threads<VEC>())
msda_windowed_fwd_kernel(const __nv_bfloat16* __restrict__ value,  // [B, L, H, W, K]
                         const float* __restrict__ offsets,        // [B, C, H, W, M, L, P, 2]
                         const float* __restrict__ weights,        // [B, C, H, W, M, L, P]
                         float* __restrict__ out,                  // [B, C, H, W, K]
                         int C, int L, int H, int Hv, int row_org, int W, int M, int D, int P, int radius,
                         int tile_y, int tile_x, int ntx, int nty) {
  // blockIdx.x = ((bc * nty + ty) * ntx + tx) * M + m, bc = b * C + c
  int r = blockIdx.x;
  const int m = r % M;
  r /= M;
  const int tx = r % ntx;
  r /= ntx;
  const int ty = r % nty;
  const int bc = r / nty;
  const int b = bc / C;

  const int K = M * D;
  const int nchunk = D / VEC;
  const int qi = threadIdx.x / nchunk;  // the thread's query in the tile, channels [chunk * VEC, +VEC) of head m
  const int chunk = threadIdx.x - qi * nchunk;
  const int ly = qi / tile_x;
  const int y = ty * tile_y + ly, x = tx * tile_x + qi - ly * tile_x;
  if (y >= H || x >= W) return;
  const float rad = (float)radius;
  const int row32 = W * K;  // the launcher checks (R + 1) * (W + 1) * K < 2^31

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  // one sample of a level: its 4 taps through L1, at 32-bit offsets from
  // `own`, the query's own cell of the level's value plane, blended into the
  // VEC accumulators
  auto sample = [&](const __nv_bfloat16* own, float oxr, float oyr, float wgt) {
    const float ox = fminf(fmaxf(oxr, -rad), rad);
    const float oy = fminf(fmaxf(oyr, -rad), rad);
    const float ix = floorf(ox);
    const float iy = floorf(oy);
    const float fx = ox - ix;
    const float fy = oy - iy;
    const int x0 = x + (int)ix;
    const int y0 = y + (int)iy;
    const bool xa = (unsigned)x0 < (unsigned)W;
    const bool xb = (unsigned)(x0 + 1) < (unsigned)W;
    const bool ya = (unsigned)(y0 + row_org) < (unsigned)Hv;
    const bool yb = (unsigned)(y0 + row_org + 1) < (unsigned)Hv;
    const __nv_bfloat16* p = own + ((int)iy * W + (int)ix) * K;
    float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
    unpack<VEC>(ldg_or_zero<VEC>(p, ya && xa), v00);
    unpack<VEC>(ldg_or_zero<VEC>(p + K, ya && xb), v01);
    unpack<VEC>(ldg_or_zero<VEC>(p + row32, yb && xa), v10);
    unpack<VEC>(ldg_or_zero<VEC>(p + row32 + K, yb && xb), v11);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float top = (1.f - fx) * v00[k] + fx * v01[k];
      const float bot = (1.f - fx) * v10[k] + fx * v11[k];
      acc[k] += wgt * ((1.f - fy) * top + fy * bot);
    }
  };

  const long long q = ((long long)bc * H + y) * W + x;
  const float* og = offsets + (q * M + m) * L * P * 2;  // the (query, head)'s samples, level-major
  const float* wg = weights + (q * M + m) * L * P;
  // the thread's own cell of level l's value plane (Hv rows, the query's at y + row_org), its channels of head m
  auto own_cell = [&](int l) {
    return value + ((((long long)b * L + l) * Hv + y + row_org) * W + x) * K + (long long)m * D + chunk * VEC;
  };
  if constexpr (PT == 4) {
    float4 o01 = make_float4(0.f, 0.f, 0.f, 0.f), o23 = o01, w4 = o01;
    if (L > 0) {
      o01 = __ldg(reinterpret_cast<const float4*>(og));
      o23 = __ldg(reinterpret_cast<const float4*>(og + 4));
      w4 = __ldg(reinterpret_cast<const float4*>(wg));
    }
    for (int l = 0; l < L; ++l) {
      float4 n01 = o01, n23 = o23, nw = w4;
      if (l + 1 < L) {  // level l+1's samples in flight while level l gathers
        n01 = __ldg(reinterpret_cast<const float4*>(og + 8 * (l + 1)));
        n23 = __ldg(reinterpret_cast<const float4*>(og + 8 * (l + 1) + 4));
        nw = __ldg(reinterpret_cast<const float4*>(wg + 4 * (l + 1)));
      }
      const __nv_bfloat16* own = own_cell(l);
      sample(own, o01.x, o01.y, w4.x);
      sample(own, o01.z, o01.w, w4.y);
      sample(own, o23.x, o23.y, w4.z);
      sample(own, o23.z, o23.w, w4.w);
      o01 = n01;
      o23 = n23;
      w4 = nw;
    }
  } else {
    for (int l = 0; l < L; ++l) {
      const __nv_bfloat16* own = own_cell(l);
      for (int p = 0; p < P; ++p) {
        const int s = l * P + p;
        sample(own, __ldg(og + 2 * s), __ldg(og + 2 * s + 1), __ldg(wg + s));
      }
    }
  }

  float* o = out + q * K + (long long)m * D + chunk * VEC;
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(o)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else if constexpr (VEC == 4) {
    reinterpret_cast<float4*>(o)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if constexpr (VEC == 2) {
    reinterpret_cast<float2*>(o)[0] = make_float2(acc[0], acc[1]);
  } else {
    o[0] = acc[0];
  }
}

using KernelFn = void (*)(const __nv_bfloat16*, const float*, const float*, float*, int, int, int, int, int, int,
                          int, int, int, int, int, int, int, int);

KernelFn pick_kernel(int vec, bool p4) {
  switch (vec) {
    case 8: return p4 ? msda_windowed_fwd_kernel<8, 4> : msda_windowed_fwd_kernel<8, 0>;
    case 4: return p4 ? msda_windowed_fwd_kernel<4, 4> : msda_windowed_fwd_kernel<4, 0>;
    case 2: return p4 ? msda_windowed_fwd_kernel<2, 4> : msda_windowed_fwd_kernel<2, 0>;
    default: return p4 ? msda_windowed_fwd_kernel<1, 4> : msda_windowed_fwd_kernel<1, 0>;
  }
}

}  // namespace

// Launch with the plan of _fwd_plan (ops/msda_windowed.py): VEC channels
// per thread (8, 4, 2 or 1) and a tile of tile_y x tile_x queries per block.
// row_halo 1: the value has H + 2 * radius rows, the halo's (see above); 0:
// H rows, zero-padded. Returns cudaErrorInvalidValue on a plan or shape the
// kernel cannot take.
extern "C" int msda_windowed_fwd_halo_launch(const void* value, const void* offsets, const void* weights, void* out,
                                             int B, int C, int L, int H, int W, int M, int D, int P, int radius,
                                             int row_halo, int vec, int tile_y, int tile_x, void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  const long long K = (long long)M * D;
  if (B < 0 || C < 0 || L < 0 || H < 0 || W < 0 || M <= 0 || D <= 0 || P < 0 || radius < 0 || K > 1024 ||
      (radius + 1LL) * (W + 1LL) * K >= (1LL << 31) || (row_halo != 0 && row_halo != 1) ||
      H + 2LL * radius > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int row_org = row_halo ? radius : 0;
  const int Hv = H + 2 * row_org;
  if ((vec != 1 && vec != 2 && vec != 4 && vec != 8) || D % vec != 0 || tile_y < 1 || tile_x < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long threads = (long long)tile_y * tile_x * (D / vec);
  if (threads > (vec <= 2 ? 1024 : 256)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(value) % (2 * vec) != 0 ||
      reinterpret_cast<size_t>(out) % (vec == 1 ? 4 : vec == 2 ? 8 : 16) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ntx = (W + tile_x - 1) / tile_x, nty = (H + tile_y - 1) / tile_y;
  const long long blocks = (long long)B * C * nty * ntx * M;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool p4 = P == 4 && reinterpret_cast<size_t>(offsets) % 16 == 0 && reinterpret_cast<size_t>(weights) % 16 == 0;
  pick_kernel(vec, p4)<<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(offsets),
      static_cast<const float*>(weights), static_cast<float*>(out), C, L, H, Hv, row_org, W, M, D, P, radius, tile_y,
      tile_x, (int)ntx, (int)nty);
  return (int)cudaGetLastError();
}

// The zero-padded call (no halo), as before the halo mode: the entry that
// earlier revisions of this source export (scripts/msda_vs_source.py).
extern "C" int msda_windowed_fwd_launch(const void* value, const void* offsets, const void* weights, void* out,
                                        int B, int C, int L, int H, int W, int M, int D, int P, int radius, int vec,
                                        int tile_y, int tile_x, void* stream) {
  return msda_windowed_fwd_halo_launch(value, offsets, weights, out, B, C, L, H, W, M, D, P, radius, 0, vec, tile_y,
                                       tile_x, stream);
}

extern "C" const char* msda_windowed_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
