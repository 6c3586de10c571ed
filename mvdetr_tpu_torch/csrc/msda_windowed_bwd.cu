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
// taken from the clamped offset itself (as the forward does), the four
// taps v00 = value[y0, x0], v01 = value[y0, x0+1], v10, v11 (zero outside
// the grid) and their dot products with g over the head's channels,
// Gab = sum_d g_d vab_d:
//
//   g_w  = (1-fy)((1-fx)G00 + fx G01) + fy((1-fx)G10 + fx G11)
//   g_ox = w [|ox_raw| <= R] ((1-fy)(sa G00 + sb G01) + fy(sa G10 + sb G11))
//   g_oy = w [|oy_raw| <= R] ((1-fx)(sa' G00 + sb' G10) + fx(sa' G01 + sb' G11))
//   g_value[tap] += (w * cy) * cx * g          for each of the four taps,
//
// with the TPU kernel's hat slopes sa = slope(ox - ix), sb = slope(ox - ix - 1),
// slope(t) = -sign(t) for |t| < 1 and 0 otherwise, t computed in f32. These
// are the TPU kernel's 81-shift hat sums written as 4 taps: for a fraction in
// (0, 1) the slopes are -1 and +1 (g_ox ~ G01 - G00), an integer offset gets
// a zero offset cotangent, and a fraction below f32 resolution next to 1 (the
// radial init's cos(pi/2) ~ 1e-16 components) keeps only one slope, exactly
// as on the TPU. Products and sums stay f32 (the TPU kernel at its default
// bf16 kernel dtype rounds g and v*g to bf16; see ROADMAP C.3).
//
// Determinism: no float atomics. Two kernels on the caller's stream:
//
// - query side (g_offsets, g_weights): B1's structure, mirrored, with the
//   plan of B1's _fwd_plan (ops/msda_windowed.py; the launcher checks it
//   again). A block owns a tile of tile_y x tile_x queries of one (b, c) and
//   one head m, heads adjacent in the grid, so together they read each
//   query's offsets and weights as one contiguous run. A thread owns one
//   query and VEC consecutive channels of the head (VEC = 8 when D % 8 == 0:
//   one 16-byte load per tap; else 4, 2 or 1 channels). It loads its VEC
//   channels of g once into registers and walks the levels in order, with
//   level l+1's offsets and weights (two and one float4 at P = 4) streaming
//   into registers while level l gathers. At P = 4 a level's 16 tap loads
//   are issued before any sum is combined. The shadow stack's P = 1
//   pseudo-levels (ops/msda_warped.py) go in groups of 4 as B1's do: a
//   group's samples are one level's two and one float4, its 16 tap loads
//   (each sample on its own plane) go out together, the next group's
//   samples stream in meanwhile, and its cotangents leave as float4 /
//   float2; unaligned pointers and the last L mod 4 pseudo-levels take
//   scalar accesses in the same kernel, and the C cameras' blocks of a tile
//   run together (B1's block order for this body). Other P take one sample
//   at a time. Per sample the thread forms the TPU kernel's dot products first
//   (msda_kernel_bwd.py:117-119): Gab over its channels, one FMA per tap and
//   channel, in channel order. The D / VEC lanes of the (query, head) then
//   combine their partial Gab in a fixed order: a shuffle butterfly when
//   they are a power of two <= 32 (adjacent in one warp; every lane ends
//   with the same bits), else through shared memory, summed by the first
//   lane in lane order. From the four sums, ~30 scalar operations give a
//   sample's three cotangents. Where the butterfly left the sums in two or
//   more lanes, lanes 0 and 1 each take two of a level's four samples (one
//   instruction stream on each lane's own inputs) and write a float4 of
//   g_offsets and a float2 of g_weights; else the first lane takes all four
//   and writes two float4 of g_offsets and one of g_weights (scalars at
//   other P). The block index is decoded once in 32 bits; taps are read
//   through L1 at 32-bit byte offsets from the query's own cell (the plan
//   requires 2(R+1)(W+1)K < 2^31).
// - value side (g_value): one block per (b, head m, chunk of 16 channels,
//   value tile of kTileY x kTileX cells, group of G value planes), the
//   planes fastest so that the blocks reading the same g run together; G
//   (value_levels) is 1 at the flagship's P = 4 and 4 over the shadow
//   stack's P = 1, and the block has a group of kWarps warps
//   for each of its planes, which all share one staging of g. A sample of query
//   (qy, qx) taps rows y0, y0+1 and columns x0, x0+1 with x0 - qx in [-R, R],
//   so only the tile's halo, queries with qy in [y_t-R-1, y_t+kTileY-1+R]
//   (and likewise in x, clipped to the grid), can land on it. For each
//   camera c in order, the block stages the halo in slabs of query rows with
//   cp.async into a ring of stage buffers: each query's 16 channels of g
//   once and its P offset pairs and weights for (m, l) of each of the G
//   planes (contiguous in memory), so each offset is read from device memory
//   about twice (the halo ratio) instead of once per candidate cell. The tile's accumulators live in shared memory, start at
//   zero and are written to g_value once.
//
//   Each warp owns a band of kBandX tile columns of its plane, every row of
//   them. It scans the staged samples whose taps can reach its band, 32 at
//   a time: each lane turns one sample into a record (tap position, which
//   of the four taps fall in the band, the four coefficients (w * cy) * cx,
//   with cy, cx from the clamped offset as above) in the warp's slot of
//   shared memory, and a ballot collects the samples that land. The warp then takes
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
// 67 TFLOP/s f32 rate. The value side alone moves 0.56 GB (0.17 ms), the
// query side 0.93 GB (0.28 ms). On an H100 80GB HBM3 at 700 W the value side
// takes ~2.8 ms at that shape (the value-stationary thread per cell took
// ~14 ms): about half of it is the per-hit update, which costs ~7
// shared-memory wavefronts (record, g, two read-modify-writes), and most of
// the rest is staging ~2.5 GB of halos through L2; occupancy (7 blocks per
// SM, by registers and shared memory) decides the sizes above. The query
// side takes ~0.9 ms (~3.2x its bound; the one thread per sample it
// replaced, with 64-bit index decoding, g read once per sample and 22 FLOP
// per (sample, channel), ~1.65 ms). Two things hold it: instruction issue
// (~200 warp instructions per warp and sample: tap addresses and masks,
// bf16 unpacking, the dot products, clamps, slopes and cotangents) and L1
// wavefronts, one per (query, head, tap) as in B1, since a head's 32 bytes
// of a cell share no 128-byte line with another query's taps. Evict-first
// cache hints, the outputs staged in shared memory for full-sector writes,
// and a register cap for 6 blocks per SM were each slower on the card.
// Over the shadow stack (B=2, L=56, C=7, P=1; bound 0.601 ms the query
// side, 0.451 the value side) the query side takes ~3.0 ms (the one-sample
// loop it replaced ~16.0: its taps, read from 56 planes camera after
// camera, waited on device memory; the P = 4 body over 14 planes took ~1.8)
// and the value side ~6.4 (one plane a block ~9.1). There a stage unit of
// one plane carried one sample a halo query, a 32-sample batch a warp
// between two barriers: with 4 planes a block and stage buffers of 14 KiB
// (3 halo rows) a warp scans 3 rows of its plane a unit, at 2 blocks of 16
// warps an SM (2, 8 planes, 6 or 28 KiB, or 3 buffers: 7.9-9.8 ms).
// PERF.md has the measurements.
//
// Row halo (the BEV-row-sharded path, mvdetr_tpu_torch/ops/msda_sharded.py,
// as the TPU kernel's row_halo mode, msda_kernel_bwd.py:236-239): the value
// holds Hv = H + 2R rows for the H query rows, its first and last R rows real
// rows of the neighbouring shards. The query side reads value row y + row_org
// for query row y (row_org = R; 0 without a halo, Hv = H) and tests a tap's
// row against Hv, as B1 does. The value side tiles all Hv rows and writes
// g_value over them, halo rows included (the exchange sends their gradient
// back to the shard they came from): a tile at value rows [y_t, y_t + kTileY)
// takes the queries with qy in [y_t - row_org - R - 1, y_t - row_org +
// kTileY - 1 + R], clipped to the H query rows, and a tap of query row qy
// lands on value row qy + iy + row_org. Order, atomics and conventions are
// as above.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (mvdetr_tpu_torch/ops/msda_windowed.py, whose
// _query_plan gives the query side B1's plan). They launch on the caller's
// stream, allocate nothing, and return a cudaError_t.

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
constexpr int kStageBytes = 6 * 1024;           // aim for one stage buffer (a slab of halo rows), one plane a block
constexpr int kStageBytesLevels = 14 * 1024;    // the same with G > 1 planes a block
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

// query side: B1's threads per block, load widths and bf16 unpacking

// a thread owns VEC channels of one query's head, so a narrow VEC on a wide
// head may need up to 1024 threads for one query
template <int VEC> __host__ __device__ constexpr int max_threads() { return VEC <= 2 ? 1024 : 256; }

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
__device__ __forceinline__ typename Raw<VEC>::T ldg_or_zero(const char* p, bool inside) {
  typename Raw<VEC>::T r{};
  if (inside) r = __ldg(reinterpret_cast<const typename Raw<VEC>::T*>(p));
  return r;
}

// VEC f32 channels of g
template <int VEC>
__device__ __forceinline__ void load_g(const float* p, float* f) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + k));
      f[k] = t.x;
      f[k + 1] = t.y;
      f[k + 2] = t.z;
      f[k + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    f[0] = t.x;
    f[1] = t.y;
  } else {
    f[0] = __ldg(p);
  }
}

// four consecutive floats: one 16-byte access where `vec` (the pointer is
// 16-byte aligned), else four scalar ones
__device__ __forceinline__ float4 ld4(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}
__device__ __forceinline__ void st4(float* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}
__device__ __forceinline__ void st2(float* p, float2 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = v;
  } else {
    p[0] = v.x;
    p[1] = v.y;
  }
}

// sum_k g[k] * tap[k] over the thread's VEC channels, in channel order
template <int VEC>
__device__ __forceinline__ float tap_dot(const float* gv, const typename Raw<VEC>::T& r) {
  float t[VEC];
  unpack<VEC>(r, t);
  float s = gv[0] * t[0];
#pragma unroll
  for (int k = 1; k < VEC; ++k) s = __fmaf_rn(gv[k], t[k], s);
  return s;
}

// The N partial sums s of this lane (four tap sums per sample) combined over
// the nchunk lanes of its (query, head), in a fixed order. SHFL: a shuffle
// butterfly over the whole warp, whose lanes all take part (xor by st <
// nchunk stays inside the (query, head); a + b == b + a, so every lane ends
// with the same bits); else through `part` (a float4 per thread of the
// block), summed by the first lane (chunk 0) in lane order. Either way
// chunk 0 holds the totals.
template <int N, bool SHFL>
__device__ __forceinline__ void combine(float* s, int nchunk, int chunk, float4* part) {
  if constexpr (SHFL) {
    for (int st = 1; st < nchunk; st <<= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] += __shfl_xor_sync(kFull, s[i], st);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      part[threadIdx.x] = make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
      __syncthreads();
      if (chunk == 0) {
        for (int k = 1; k < nchunk; ++k) {
          const float4 t = part[threadIdx.x + k];
          s[i] += t.x;
          s[i + 1] += t.y;
          s[i + 2] += t.z;
          s[i + 3] += t.w;
        }
      }
      __syncthreads();  // part is rewritten next
    }
  }
}

// The query side's and B1's bodies (the plan's `body`): a (query, head)'s
// L * P samples are contiguous, level-major, so 4 consecutive samples are two
// float4 of offsets and one of weights. kBodyPoints4: P is 4 and the
// pointers are 16-byte aligned; a group is one level, whose 4 samples read
// one value plane. kBodyGroups: P is 1 (the shadow stack's pseudo-levels); a
// group is 4 consecutive pseudo-levels, each sample on its own plane; a
// thread whose pointers are not 16-byte aligned makes scalar accesses, and
// the last L mod 4 samples go one at a time. kBodyGeneric: any P, one sample
// at a time, scalar loads and stores.
constexpr int kBodyGeneric = 0, kBodyGroups = 1, kBodyPoints4 = 4;

// The (query tile, camera) of a block of the query side or B1, blockIdx.x =
// r * M + m. Cameras outside the tile, r = ((b * C + c) * nty + ty) * ntx +
// tx; or, for the level groups, inside it, r = ((b * nty + ty) * ntx + tx) *
// C + c: the C cameras' blocks of a tile, which read the same taps of the
// same L value planes, run together while those planes' rows are in L2 (a
// shadow stack's value is ~6x the L2).
template <bool CAMS_INSIDE>
__device__ __forceinline__ void block_tile(int r, int C, int ntx, int nty, int& tx, int& ty, int& b, int& bc) {
  if constexpr (CAMS_INSIDE) {
    const int c = r % C;
    r /= C;
    tx = r % ntx;
    r /= ntx;
    ty = r % nty;
    b = r / nty;
    bc = b * C + c;
  } else {
    tx = r % ntx;
    r /= ntx;
    ty = r % nty;
    bc = r / nty;
    b = bc / C;
  }
}

// Query side. PT (the body) kBodyPoints4 or kBodyGroups: a group's 16 tap
// loads are issued before any sum is combined, the next group's samples are
// in flight while it gathers, and its cotangents leave as float4 / float2
// stores; kBodyGeneric: one sample at a time.
// SHFL: the nchunk = D / VEC lanes of a (query, head) are a power of two <=
// 32, the block is whole warps, and they combine by shuffles; else through
// shared memory.
template <int VEC, int PT, bool SHFL>
__global__ void __launch_bounds__(max_threads<VEC>())
msda_bwd_query_kernel(const __nv_bfloat16* __restrict__ value,  // [B, L, H, W, K]
                      const float* __restrict__ offsets,        // [B, C, H, W, M, L, P, 2]
                      const float* __restrict__ weights,        // [B, C, H, W, M, L, P]
                      const float* __restrict__ g,              // [B, C, H, W, K]
                      float* __restrict__ g_off, float* __restrict__ g_w, int C, int L, int H, int Hv, int row_org,
                      int W, int M, int D, int P, int radius, int tile_y, int tile_x, int ntx, int nty) {
  __shared__ float4 part[SHFL ? 1 : max_threads<VEC>()];
  const int m = blockIdx.x % M;
  int tx, ty, b, bc;
  block_tile<PT == kBodyGroups>(blockIdx.x / M, C, ntx, nty, tx, ty, b, bc);

  const int K = M * D;
  const int nchunk = D / VEC;
  const int qi = threadIdx.x / nchunk;  // the thread's query in the tile, channels [chunk * VEC, +VEC) of head m
  const int chunk = threadIdx.x - qi * nchunk;
  const int ly = qi / tile_x;
  int y = ty * tile_y + ly, x = tx * tile_x + qi - ly * tile_x;
  const bool live = y < H && x < W;
  y = min(y, H - 1);  // a thread past the grid stays for the shuffles and barriers, on a cell inside it,
  x = min(x, W - 1);  // and writes nothing
  const float rad = (float)radius;

  const long long q = ((long long)bc * H + y) * W + x;
  float gv[VEC];
  load_g<VEC>(g + q * K + (long long)m * D + chunk * VEC, gv);

  // one sample's four partial tap sums s[0..3] (taps 00, 01, 10, 11): the
  // taps through L1, at 32-bit byte offsets from `own`, the query's own
  // cell of the level's value plane
  const int k2 = 2 * K, r2 = 2 * W * K;  // a cell and a row, in bytes; the launcher checks 2 (R+1)(W+1)K < 2^31
  auto tap_sums = [&](const char* own, float oxr, float oyr, float* s) {
    const float ox = fminf(fmaxf(oxr, -rad), rad);
    const float oy = fminf(fmaxf(oyr, -rad), rad);
    const float ix = floorf(ox);
    const float iy = floorf(oy);
    const int x0 = x + (int)ix;
    const int y0 = y + (int)iy;
    const bool xa = (unsigned)x0 < (unsigned)W;
    const bool xb = (unsigned)(x0 + 1) < (unsigned)W;
    const bool ya = (unsigned)(y0 + row_org) < (unsigned)Hv;
    const bool yb = (unsigned)(y0 + row_org + 1) < (unsigned)Hv;
    const char* p = own + ((int)iy * r2 + (int)ix * k2);
    s[0] = tap_dot<VEC>(gv, ldg_or_zero<VEC>(p, ya && xa));
    s[1] = tap_dot<VEC>(gv, ldg_or_zero<VEC>(p + k2, ya && xb));
    s[2] = tap_dot<VEC>(gv, ldg_or_zero<VEC>(p + r2, yb && xa));
    s[3] = tap_dot<VEC>(gv, ldg_or_zero<VEC>(p + r2 + k2, yb && xb));
  };
  // a sample's cotangents g_w, g_ox, g_oy from its combined tap sums
  auto cotangents = [&](float oxr, float oyr, float wgt, const float* s, float& cw, float& cox, float& coy) {
    const float ox = fminf(fmaxf(oxr, -rad), rad);
    const float oy = fminf(fmaxf(oyr, -rad), rad);
    const float ix = floorf(ox);
    const float iy = floorf(oy);
    const float fx = ox - ix;
    const float fy = oy - iy;
    const float sax = hat_slope(ox - ix), sbx = hat_slope(ox - (ix + 1.f));
    const float say = hat_slope(oy - iy), sby = hat_slope(oy - (iy + 1.f));
    cw = (1.f - fy) * ((1.f - fx) * s[0] + fx * s[1]) + fy * ((1.f - fx) * s[2] + fx * s[3]);
    const float sx = (1.f - fy) * (sax * s[0] + sbx * s[1]) + fy * (sax * s[2] + sbx * s[3]);
    const float sy = (1.f - fx) * (say * s[0] + sby * s[2]) + fx * (say * s[1] + sby * s[3]);
    cox = fabsf(oxr) <= rad ? wgt * sx : 0.f;
    coy = fabsf(oyr) <= rad ? wgt * sy : 0.f;
  };

  const long long s0 = (q * M + m) * L * P;  // the (query, head)'s first sample, samples level-major
  const float* og = offsets + 2 * s0;
  const float* wg = weights + s0;
  float* go = g_off + 2 * s0;
  float* gw = g_w + s0;
  const bool writer = live && chunk == 0;
  // the thread's own cell of level l's value plane (Hv rows, the query's at y + row_org), its channels of head m
  auto own_cell = [&](int l) {
    return reinterpret_cast<const char*>(value + ((((long long)b * L + l) * Hv + y + row_org) * W + x) * K +
                                         (long long)m * D + chunk * VEC);
  };
  // sample i of plane `own` alone: scalar loads, its combine and scalar stores
  auto one_sample = [&](const char* own, int i) {
    const float oxr = __ldg(og + 2 * i), oyr = __ldg(og + 2 * i + 1);
    float s[4];
    tap_sums(own, oxr, oyr, s);
    combine<4, SHFL>(s, nchunk, chunk, part);
    if (writer) {
      float cw, cox, coy;
      cotangents(oxr, oyr, __ldg(wg + i), s, cw, cox, coy);
      gw[i] = cw;
      go[2 * i] = cox;
      go[2 * i + 1] = coy;
    }
  };
  if constexpr (PT == kBodyPoints4) {
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
      const char* own = own_cell(l);
      float s[16];
      tap_sums(own, o01.x, o01.y, s);
      tap_sums(own, o01.z, o01.w, s + 4);
      tap_sums(own, o23.x, o23.y, s + 8);
      tap_sums(own, o23.z, o23.w, s + 12);
      combine<16, SHFL>(s, nchunk, chunk, part);
      if (SHFL && nchunk >= 2) {
        // every lane holds the sums: chunks 0 and 1 take samples 0-1 and 2-3,
        // one instruction stream on each lane's own inputs
        const bool hi = chunk & 1;
        const float4 oo = hi ? o23 : o01;
        const float wa = hi ? w4.z : w4.x, wb = hi ? w4.w : w4.y;
        float t[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) t[i] = hi ? s[8 + i] : s[i];
        float2 cw;
        float4 co;
        cotangents(oo.x, oo.y, wa, t, cw.x, co.x, co.y);
        cotangents(oo.z, oo.w, wb, t + 4, cw.y, co.z, co.w);
        if (live && chunk < 2) {
          reinterpret_cast<float4*>(go)[2 * l + chunk] = co;
          reinterpret_cast<float2*>(gw)[2 * l + chunk] = cw;
        }
      } else if (writer) {
        float4 cw, c01, c23;
        cotangents(o01.x, o01.y, w4.x, s, cw.x, c01.x, c01.y);
        cotangents(o01.z, o01.w, w4.y, s + 4, cw.y, c01.z, c01.w);
        cotangents(o23.x, o23.y, w4.z, s + 8, cw.z, c23.x, c23.y);
        cotangents(o23.z, o23.w, w4.w, s + 12, cw.w, c23.z, c23.w);
        reinterpret_cast<float4*>(gw)[l] = cw;
        reinterpret_cast<float4*>(go)[2 * l] = c01;
        reinterpret_cast<float4*>(go)[2 * l + 1] = c23;
      }
      o01 = n01;
      o23 = n23;
      w4 = nw;
    }
  } else if constexpr (PT == kBodyGroups) {
    // groups of 4 pseudo-levels, P = 1: sample i reads plane i. The P = 4
    // body's combine and cotangents again: one code for both took the
    // flagship's query side from 0.87 to 1.1 ms (PERF.md, B2).
    const int ngroups = L >> 2;
    const bool vec = ((reinterpret_cast<size_t>(og) | reinterpret_cast<size_t>(wg) | reinterpret_cast<size_t>(go) |
                       reinterpret_cast<size_t>(gw)) & 15) == 0;
    const long long plane = 2LL * Hv * W * K;  // bytes from one value plane to the next
    float4 o01 = make_float4(0.f, 0.f, 0.f, 0.f), o23 = o01, w4 = o01;
    if (ngroups > 0) {
      o01 = ld4(og, vec);
      o23 = ld4(og + 4, vec);
      w4 = ld4(wg, vec);
    }
    for (int l = 0; l < ngroups; ++l) {
      float4 n01 = o01, n23 = o23, nw = w4;
      if (l + 1 < ngroups) {  // group l+1's samples in flight while group l gathers
        n01 = ld4(og + 8 * (l + 1), vec);
        n23 = ld4(og + 8 * (l + 1) + 4, vec);
        nw = ld4(wg + 4 * (l + 1), vec);
      }
      const char* own = own_cell(4 * l);
      float s[16];
      tap_sums(own, o01.x, o01.y, s);
      tap_sums(own + plane, o01.z, o01.w, s + 4);
      tap_sums(own + 2 * plane, o23.x, o23.y, s + 8);
      tap_sums(own + 3 * plane, o23.z, o23.w, s + 12);
      combine<16, SHFL>(s, nchunk, chunk, part);
      if (SHFL && nchunk >= 2) {  // as above
        const bool hi = chunk & 1;
        const float4 oo = hi ? o23 : o01;
        const float wa = hi ? w4.z : w4.x, wb = hi ? w4.w : w4.y;
        float t[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) t[i] = hi ? s[8 + i] : s[i];
        float2 cw;
        float4 co;
        cotangents(oo.x, oo.y, wa, t, cw.x, co.x, co.y);
        cotangents(oo.z, oo.w, wb, t + 4, cw.y, co.z, co.w);
        if (live && chunk < 2) {
          st4(go + 8 * l + 4 * chunk, co, vec);
          st2(gw + 4 * l + 2 * chunk, cw, vec);
        }
      } else if (writer) {
        float4 cw, c01, c23;
        cotangents(o01.x, o01.y, w4.x, s, cw.x, c01.x, c01.y);
        cotangents(o01.z, o01.w, w4.y, s + 4, cw.y, c01.z, c01.w);
        cotangents(o23.x, o23.y, w4.z, s + 8, cw.z, c23.x, c23.y);
        cotangents(o23.z, o23.w, w4.w, s + 12, cw.w, c23.z, c23.w);
        st4(gw + 4 * l, cw, vec);
        st4(go + 8 * l, c01, vec);
        st4(go + 8 * l + 4, c23, vec);
      }
      o01 = n01;
      o23 = n23;
      w4 = nw;
    }
    for (int i = 4 * ngroups; i < L; ++i) one_sample(own_cell(i), i);  // the last L mod 4 pseudo-levels
  } else {
    for (int l = 0; l < L; ++l) {
      const char* own = own_cell(l);
      for (int p = 0; p < P; ++p) one_sample(own, l * P + p);
    }
  }
}

// Value side, G value planes (pseudo-levels) per block. Layout of the
// dynamic shared memory: the tile's accumulators [G][kTileY][kAccRow]; each
// warp's records of its current 32 samples; then kStages stage buffers of
// buf_floats (16-byte aligned), each holding a slab of up to slab_q halo
// queries: g [slab_q][kChunk], offsets [slab_q][G * P] (x, y) pairs, weights
// [slab_q][G * P] (a query's samples of the G levels, as contiguous as in
// device memory).
struct ValueTile {
  int b, l, nl, m, d0, dn;   // value planes [l, l + nl) and the channel chunk
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
// == 0; vec_ow: G * P and L * P multiples of 4, with 16-byte aligned bases).
template <int G>
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
  float* ws = os + 2 * slab_q * G * P;
  const int n = G == 1 ? P : t.nl * P;  // a query's samples of the block's levels
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
    // the query's samples for (m, levels l .. l + nl): contiguous in offsets and weights
    const long long s = ((q * M + t.m) * L + t.l) * P;
    if (vec_ow) {
      for (int k = 0; k < 2 * n; k += 4) cp_async16(os + 2 * i * G * P + k, offsets + 2 * s + k);
      for (int k = 0; k < n; k += 4) cp_async16(ws + i * G * P + k, weights + s + k);
    } else {
      for (int k = 0; k < n; ++k) {
        cp_async8(os + 2 * (i * G * P + k), offsets + 2 * (s + k));
        cp_async4(ws + i * G * P + k, weights + s + k);
      }
    }
  }
}

// G groups of kWarps warps per block, one a value plane: warp w adds plane
// w / kWarps's samples on band w % kWarps.
template <int G>
__device__ __forceinline__ void value_body(const float* __restrict__ offsets,  // [B, C, H, W, M, L, P, 2]
                                           const float* __restrict__ weights,  // [B, C, H, W, M, L, P]
                                           const float* __restrict__ g,        // [B, C, H, W, K]
                                           float* __restrict__ g_value,        // [B, L, Hv, W, M, D]
                                           int C, int L, int H, int Hv, int row_org, int W, int M, int D, int P,
                                           int radius, int nchunk, int ntx, int nty, int nlg, int slab_rows,
                                           int slab_q, int buf_floats, bool vec_g, bool vec_ow) {
  extern __shared__ __align__(16) float smem[];
  const int lv = G == 1 ? 0 : (threadIdx.x >> 5) / kWarps;  // this warp's plane of the block's G
  float* acc = smem + lv * (kTileY * kAccRow);
  // this warp's row records: [32 samples][2 tap rows]
  int4* records = reinterpret_cast<int4*>(smem + G * kTileY * kAccRow) + 2 * (threadIdx.x & ~31);
  float* stage = smem + G * (kTileY * kAccRow + kWarps * 32 * kRecordFloats);  // buffer i at stage + i * buf_floats

  // blockIdx.x = (((b * M + m) * nchunk + ch) * (nty * ntx) + tile) * nlg + lg: planes [lg * G, +G)
  ValueTile t;
  int r = blockIdx.x;
  t.l = (r % nlg) * G;
  t.nl = min(G, L - t.l);
  r /= nlg;
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
  // the tile's value rows [y_t, y_t + kTileY) are query rows [y_t - row_org, ...)
  t.hy0 = max(0, t.y_t - row_org - radius - 1);
  t.hy1 = min(H - 1, t.y_t - row_org + kTileY - 1 + radius);
  t.hx0 = max(0, t.x_t - radius - 1);
  t.ncols = min(W - 1, t.x_t + kTileX - 1 + radius) - t.hx0 + 1;
  t.slab_rows = slab_rows;
  t.nslab = max(0, t.hy1 - t.hy0 + slab_rows) / slab_rows;
  const int units = C * t.nslab;
  const float inv_p = 1.f / (float)P, inv_ncols = 1.f / (float)t.ncols;

  for (int i = threadIdx.x; i < G * kTileY * kAccRow; i += blockDim.x) smem[i] = 0.f;
  for (int u = 0; u < kStages - 1; ++u) {
    if (u < units) {
      stage_unit<G>(t, u, stage + u * buf_floats, slab_q, offsets, weights, g, C, L, H, W, M, D, P, vec_g, vec_ow,
                 inv_ncols);
    }
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;  // 0: tap row y0, 1: tap row y0 + 1
  const int j = lane & 15;     // channel d0 + j (lanes past the chunk's dn fill unused slots)
  const int xb = (threadIdx.x >> 5) % kWarps * kBandX;  // this warp's band: tile columns [xb, xb + kBandX), every row
  // halo columns (relative to hx0) of queries whose taps can reach the band
  const int c_lo = max(0, t.x_t + xb - radius - 1 - t.hx0);
  const int c_hi = min(t.ncols - 1, t.x_t + xb + kBandX - 1 + radius - t.hx0);
  const bool band_live = (G == 1 || lv < t.nl) && t.x_t + xb < W && c_lo <= c_hi;
  const int seg = (c_hi - c_lo + 1) * P;  // staged samples of one halo row that the band scans
  const float inv_seg = 1.f / (float)seg;
  const float rad = (float)radius;

  for (int u = 0; u < units; ++u) {
    cp_async_wait<kStages - 2>();  // this thread's copies of unit u have landed
    __syncthreads();               // everyone's have, and unit u - 1's buffer is free
    if (u + kStages - 1 < units) {
      stage_unit<G>(t, u + kStages - 1, stage + (u + kStages - 1) % kStages * buf_floats, slab_q, offsets, weights, g,
                 C, L, H, W, M, D, P, vec_g, vec_ow, inv_ncols);
    }
    cp_async_commit();

    const float* gs = stage + u % kStages * buf_floats;
    const float2* os = reinterpret_cast<const float2*>(gs + slab_q * kChunk);
    const float* ws = gs + slab_q * (kChunk + 2 * G * P);
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
        const int ks = k + (qi * (G - 1) + lv) * P;  // the staged sample: query qi, plane lv, point k - qi * P
        const float2 o = os[ks];
        const float ox = fminf(fmaxf(o.x, -rad), rad);
        const float oy = fminf(fmaxf(o.y, -rad), rad);
        const float ix = floorf(ox);
        const float iy = floorf(oy);
        const float fx = ox - ix;
        const float fy = oy - iy;
        const int ty0 = qy + (int)iy + row_org - t.y_t;  // tile row of tap row y0
        const int tx0 = qx + (int)ix - t.x_t;  // tile column of tap column x0
        const bool y_a = ty0 >= 0 && ty0 < kTileY, y_b = ty0 >= -1 && ty0 < kTileY - 1;
        const bool x_a = tx0 >= xb && tx0 < xb + kBandX, x_b = tx0 >= xb - 1 && tx0 < xb + kBandX - 1;
        taps = (y_a && x_a) | (y_a && x_b) << 1 | (y_b && x_a) << 2 | (y_b && x_b) << 3;
        if (taps) {
          const float w = ws[ks];
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

  // each tile cell of each plane inside the grid written once
  for (int i = threadIdx.x; i < G * kTileY * kTileX * kChunk; i += blockDim.x) {
    const int jj = i % kChunk, xx = (i / kChunk) % kTileX, yy = i / (kChunk * kTileX) % kTileY;
    const int j = i / (kChunk * kTileX * kTileY);
    const int y = t.y_t + yy, x = t.x_t + xx;
    if ((G == 1 || j < t.nl) && jj < t.dn && y < Hv && x < W) {
      g_value[((((long long)t.b * L + t.l + j) * Hv + y) * W + x) * M * (long long)D + (long long)t.m * D + t.d0 +
              jj] = smem[(j * kTileY + yy) * kAccRow + xx * kChunk + jj];
    }
  }
}

#define VALUE_KERNEL_ARGS                                                                                       \
  const float *__restrict__ offsets, const float *__restrict__ weights, const float *__restrict__ g,              \
      float *__restrict__ g_value, int C, int L, int H, int Hv, int row_org, int W, int M, int D, int P, int radius, \
      int nchunk, int ntx, int nty, int nlg, int slab_rows, int slab_q, int buf_floats, bool vec_g, bool vec_ow
#define VALUE_BODY_ARGS                                                                                       \
  offsets, weights, g, g_value, C, L, H, Hv, row_org, W, M, D, P, radius, nchunk, ntx, nty, nlg, slab_rows, slab_q, \
      buf_floats, vec_g, vec_ow

// One plane a block: 4 warps, 70 registers, 7 blocks an SM (by registers
// and shared memory).
__global__ void __launch_bounds__(kWarps * 32) msda_bwd_value_kernel(VALUE_KERNEL_ARGS) {
  value_body<1>(VALUE_BODY_ARGS);
}
// G > 1 planes a block: registers capped so that 8 / G blocks of 4G warps
// fit an SM.
template <int G>
__global__ void __launch_bounds__(kWarps * 32 * G, 8 / G) msda_bwd_value_levels_kernel(VALUE_KERNEL_ARGS) {
  value_body<G>(VALUE_BODY_ARGS);
}

using QueryFn = void (*)(const __nv_bfloat16*, const float*, const float*, const float*, float*, float*, int, int,
                        int, int, int, int, int, int, int, int, int, int, int, int);

template <int VEC, bool SHFL>
QueryFn pick_query(int body) {
  if (body == kBodyPoints4) return msda_bwd_query_kernel<VEC, kBodyPoints4, SHFL>;
  if (body == kBodyGroups) return msda_bwd_query_kernel<VEC, kBodyGroups, SHFL>;
  return msda_bwd_query_kernel<VEC, kBodyGeneric, SHFL>;
}
template <int VEC>
QueryFn pick_query(int body, bool shfl) {
  return shfl ? pick_query<VEC, true>(body) : pick_query<VEC, false>(body);
}

// whether the query side's body can take P samples a level at these
// pointers: kBodyPoints4 needs P = 4 and 16-byte aligned samples and
// cotangents, kBodyGroups P = 1
bool body_fits(int body, int P, const void* offsets, const void* weights, const void* g_offsets,
               const void* g_weights) {
  const size_t align = reinterpret_cast<size_t>(offsets) | reinterpret_cast<size_t>(weights) |
                       reinterpret_cast<size_t>(g_offsets) | reinterpret_cast<size_t>(g_weights);
  return body == kBodyGeneric || (body == kBodyGroups && P == 1) || (body == kBodyPoints4 && P == 4 && align % 16 == 0);
}

// the query side with the plan of _query_plan: VEC channels per thread (8, 4,
// 2 or 1), a tile of tile_y x tile_x queries per block, and the body
int launch_query(const void* value, const void* offsets, const void* weights, const void* g, void* g_offsets,
                 void* g_weights, int B, int C, int L, int H, int row_org, int W, int M, int D, int P, int radius,
                 int vec, int tile_y, int tile_x, int body, cudaStream_t stream) {
  const long long K = (long long)M * D;
  if (B < 0 || C < 0 || L < 0 || H < 0 || W < 0 || P < 0 || K > 1024 ||
      2LL * (radius + 1LL) * (W + 1LL) * K >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((vec != 1 && vec != 2 && vec != 4 && vec != 8) || D % vec != 0 || tile_y < 1 || tile_x < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long threads = (long long)tile_y * tile_x * (D / vec);
  if (threads > (vec <= 2 ? 1024 : 256)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(value) % (2 * vec) != 0 || reinterpret_cast<size_t>(g) % std::min(16, 4 * vec) != 0 ||
      !body_fits(body, P, offsets, weights, g_offsets, g_weights)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ntx = (W + tile_x - 1) / tile_x, nty = (H + tile_y - 1) / tile_y;
  const long long blocks = (long long)B * C * nty * ntx * M;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int nchunk = D / vec;
  const bool shfl = nchunk <= 32 && (nchunk & (nchunk - 1)) == 0 && threads % 32 == 0;
  QueryFn fn = vec == 8 ? pick_query<8>(body, shfl)
               : vec == 4 ? pick_query<4>(body, shfl)
               : vec == 2 ? pick_query<2>(body, shfl)
                          : pick_query<1>(body, shfl);
  fn<<<(unsigned)blocks, (unsigned)threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(offsets),
      static_cast<const float*>(weights), static_cast<const float*>(g), static_cast<float*>(g_offsets),
      static_cast<float*>(g_weights), C, L, H, H + 2 * row_org, row_org, W, M, D, P, radius, tile_y, tile_x, (int)ntx,
      (int)nty);
  return (int)cudaGetLastError();
}

// The value side's shared memory at G planes per block, or -1 past what a
// block may use; also the slab of halo rows and the stage buffer's floats.
long long value_smem(int G, int H, int W, int P, int radius, long long* slab_rows, long long* slab_q,
                     long long* buf_floats) {
  // a slab of halo rows: as many as fit in the stage's bytes, at least one
  const long long stage_bytes = G == 1 ? kStageBytes : kStageBytesLevels;
  const long long halo_cols = std::max<long long>(1, std::min<long long>(W, kTileX + 2LL * radius + 1));
  const long long halo_rows = std::min<long long>(H, kTileY + 2LL * radius + 1);
  const long long q_floats = kChunk + 3LL * P * G;  // a staged query: g, then its G levels' samples
  *slab_rows = std::max<long long>(1, std::min<long long>(halo_rows, stage_bytes / (halo_cols * q_floats * 4)));
  *slab_q = *slab_rows * halo_cols;
  *buf_floats = (*slab_q * q_floats + 3) / 4 * 4;
  const long long smem =
      (G * ((long long)kTileY * kAccRow + kWarps * 32 * kRecordFloats) + kStages * *buf_floats) * (long long)4;
  return smem > kSmemLimit || *slab_q >= (1 << 15) || *slab_q * P * G >= (1 << 24) ? -1 : smem;
}

template <int G>
int launch_value_levels(const float* offsets, const float* weights, const float* g, float* g_value, int B, int C,
                        int L, int H, int row_org, int W, int M, int D, int P, int radius, cudaStream_t stream) {
  const int Hv = H + 2 * row_org;  // the value's rows, each written once
  const int nchunk = (D + kChunk - 1) / kChunk;
  const int ntx = (W + kTileX - 1) / kTileX, nty = (Hv + kTileY - 1) / kTileY;
  const int nlg = (L + G - 1) / G;  // blocks of G planes along L, the last one ragged
  const long long blocks = (long long)B * M * nchunk * nty * ntx * nlg;
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  long long slab_rows, slab_q, buf_floats;
  const long long smem = value_smem(G, H, W, P, radius, &slab_rows, &slab_q, &buf_floats);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  auto* kernel = msda_bwd_value_kernel;
  if constexpr (G > 1) kernel = msda_bwd_value_levels_kernel<G>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec_g = D % kChunk == 0 && reinterpret_cast<size_t>(g) % 16 == 0;
  const bool vec_ow = (G * P) % 4 == 0 && (L * P) % 4 == 0 && reinterpret_cast<size_t>(offsets) % 16 == 0 &&
                      reinterpret_cast<size_t>(weights) % 16 == 0;
  kernel<<<(unsigned)blocks, kWarps * 32 * G, (size_t)smem, stream>>>(
      offsets, weights, g, g_value, C, L, H, Hv, row_org, W, M, D, P, radius, nchunk, ntx, nty, nlg, (int)slab_rows,
      (int)slab_q, (int)buf_floats, vec_g, vec_ow);
  return (int)cudaGetLastError();
}

// The value side's planes per block: `levels` (1 or 4) as given, or with
// levels 0 the kernel's own choice, 4 where 4 planes' samples make up no
// more than the flagship's P = 4 of one plane (P = 1, L >= 4) and fit a
// block's shared memory (one staging of g for 4 planes, PERF.md §6),
// else 1. Every count gives the same bits. -1 where the count does not fit.
int value_levels(int H, int W, int L, int P, int radius, int levels, long long* smem) {
  long long slab_rows, slab_q, buf_floats;
  if (levels == 0) {
    levels = P == 1 && L >= 4 && value_smem(4, H, W, P, radius, &slab_rows, &slab_q, &buf_floats) >= 0 ? 4 : 1;
  }
  if (levels != 1 && levels != 4) return -1;
  *smem = value_smem(levels, H, W, P, radius, &slab_rows, &slab_q, &buf_floats);
  return *smem < 0 ? -1 : levels;
}

// the value side at value_levels' planes per block
int launch_value(const void* offsets, const void* weights, const void* g, void* g_value, int B, int C, int L, int H,
                 int row_org, int W, int M, int D, int P, int radius, int levels, cudaStream_t stream) {
  const auto* o = static_cast<const float*>(offsets);
  const auto* w = static_cast<const float*>(weights);
  const auto* gg = static_cast<const float*>(g);
  auto* gv = static_cast<float*>(g_value);
  long long smem;
  switch (value_levels(H, W, L, P, radius, levels, &smem)) {
    case 1: return launch_value_levels<1>(o, w, gg, gv, B, C, L, H, row_org, W, M, D, P, radius, stream);
    case 4: return launch_value_levels<4>(o, w, gg, gv, B, C, L, H, row_org, W, M, D, P, radius, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// sides: 1 the query side (g_offsets, g_weights), 2 the value side (g_value),
// 3 both. row_halo 1: the value (and g_value) has H + 2 * radius rows, the
// halo's (see above); 0: H rows, zero-padded. vec, tile_y, tile_x, body: the
// query side's plan (_query_plan), checked again when the query side runs;
// levels: the value side's planes per block, 0 for value_levels' choice
// (1 or 4 to time another). Returns
// cudaErrorInvalidValue on a plan or shape the kernels cannot take.
extern "C" int msda_windowed_bwd_halo_sides_launch(const void* value, const void* offsets, const void* weights,
                                                   const void* g, void* g_value, void* g_offsets, void* g_weights,
                                                   int B, int C, int L, int H, int W, int M, int D, int P, int radius,
                                                   int row_halo, int vec, int tile_y, int tile_x, int body,
                                                   int levels, int sides, void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  if (M <= 0 || D <= 0 || radius < 0 || sides < 1 || sides > 3 || (row_halo != 0 && row_halo != 1) ||
      H < 0 || H + 2LL * radius > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int row_org = row_halo ? radius : 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sides & 1) {
    const int e = launch_query(value, offsets, weights, g, g_offsets, g_weights, B, C, L, H, row_org, W, M, D, P,
                               radius, vec, tile_y, tile_x, body, st);
    if (e != 0) return e;
  }
  if (sides & 2) {
    const int e = launch_value(offsets, weights, g, g_value, B, C, L, H, row_org, W, M, D, P, radius, levels, st);
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}

// The zero-padded call (no halo), as before the halo mode: the entries that
// earlier revisions of this source export (scripts/msda_vs_source.py).
extern "C" int msda_windowed_bwd_sides_launch(const void* value, const void* offsets, const void* weights,
                                              const void* g, void* g_value, void* g_offsets, void* g_weights, int B,
                                              int C, int L, int H, int W, int M, int D, int P, int radius, int vec,
                                              int tile_y, int tile_x, int body, int levels, int sides, void* stream) {
  return msda_windowed_bwd_halo_sides_launch(value, offsets, weights, g, g_value, g_offsets, g_weights, B, C, L, H, W,
                                             M, D, P, radius, 0, vec, tile_y, tile_x, body, levels, sides, stream);
}

extern "C" int msda_windowed_bwd_launch(const void* value, const void* offsets, const void* weights, const void* g,
                                        void* g_value, void* g_offsets, void* g_weights, int B, int C, int L, int H,
                                        int W, int M, int D, int P, int radius, int vec, int tile_y, int tile_x,
                                        int body, int levels, void* stream) {
  return msda_windowed_bwd_sides_launch(value, offsets, weights, g, g_value, g_offsets, g_weights, B, C, L, H, W, M,
                                        D, P, radius, vec, tile_y, tile_x, body, levels, 3, stream);
}

// The value side's planes per block at a shape, for `levels` as the launch
// takes it, with its dynamic shared memory in *smem; -1 where it does not
// fit a block.
extern "C" int msda_windowed_bwd_value_levels(int H, int W, int L, int P, int radius, int levels, long long* smem) {
  *smem = -1;
  if (radius < 0 || P < 0) return -1;
  return value_levels(H, W, L, P, radius, levels, smem);
}

extern "C" const char* msda_windowed_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
