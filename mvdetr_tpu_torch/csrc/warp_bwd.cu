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
// matrices on the MXU; that shape exists for the TPU. Here each cell gathers
// its taps from sorted lists, with no float atomics: each cell adds its terms
// in ascending (b, q, tap) order, so the result does not change from run to
// run. A cell receives at most one tap of any sample, so any schedule that
// visits a cell's taps in ascending q gives the same bits.
//
// Bound on an H100 SXM: memory. On the flagship path (g [14, 43200, 128]
// bf16 -> grad [14, 90, 160, 128]) one call must read g 155 MB and the
// coordinates 4.8 MB and write 51.6 MB: ~0.063 ms at 3.35 TB/s. In gather
// mode (g [112, 302400, 16] bf16 -> 112 maps of 60 x 180) 1393.5 MB: ~0.416
// ms. The arithmetic, 3 FLOP per (query, tap, channel), is far below.
//
// The second design sorted one key per (sample, tap) entry by its
// cell and walked each cell with one warp, a lane owning 4 channels. At
// gather mode's C = 16 that left 28 of 32 lanes idle through ~107 entries a
// cell, and sorted 135.5 M keys over 21 bits. This design, four kernels on
// the caller's stream (warp_bwd_launch):
//
// 1. keys: one thread per sample i = b*Q + q writes the base cell of its
//    taps on a per-map (H + 1) x (W + 1) grid, (floor(sy) + 1, floor(sx) +
//    1), so that a base on row or column -1 still reaches its inside taps
//    and never wraps into the next map, or the sentinel (H + 1) * (W + 1)
//    when all four taps fall outside; i; and its fractions (wx1, wy1) =
//    (sx - floor(sx), sy - floor(sy)).
// 2. sort: CUB's radix sort (stable) of the pairs over the low end_bit
//    bits, end_bit = bit_length((H + 1) * (W + 1)): 14 bits and 2 digit
//    passes at gather's and the flagship's maps, with int32 values. Maps
//    are not in the key: the sort is stable and the samples come map after
//    map, so a base cell's samples stay in (b, q) order, and the bin (base,
//    b) = base * B + b rises along the sorted list.
// 3. index: one thread per sorted position s writes start[k] = s for every
//    bin k in (bin[s-1], bin[s]], so the bin's segment is [start[k],
//    start[k+1]) with no search (a range longer than a warp is written by
//    the whole warp), and the fractions of the sample at s (one 8-byte
//    read out of order), so that the walk reads them in sorted order and
//    chases no coordinates.
// 4. walk: cell (y, x) of map b draws tap (ty, tx) from the bin (y + 1 -
//    ty, x + 1 - tx, b), each list in sample order; the walk merges a cell's
//    four lists a run of records at a time into shared memory, then adds
//    them with U g rows in flight. A lane owns 4 channels (8 bytes of bf16,
//    16 of f32) when C % 4 == 0 and g and out are aligned, else one. The C
//    entry picks the body (warp_bwd_body):
//    - Narrow, when 4 lanes cover C (gather's and aio's C = 16): a warp
//      takes 8 consecutive cells, a group of 4 lanes a cell. In the merge a
//      lane holds its list's next 8 rows in registers (reloaded every 8
//      steps, so no step waits on a load); the smallest head by two
//      shuffles; 32 records (g row, sorted position, tap) a cell a round.
//      In the walk the group adds its cell's records, 4 channels a lane,
//      each tap's weights from the fractions at the record's position.
//    - Wide, else (C = 128): a warp takes one cell and merges with every
//      lane: each list's next 32 rows go to shared memory, and a candidate's
//      rank is its index plus the rows below it in the other three windows
//      (binary searches; exact for the 32 smallest, which all lie in the
//      windows); records are (g row, ry, cx). C wider than 32 lanes takes
//      more passes, each merging anew.
//    In bf16 two products are rounded by one conversion (cvt.rn.bf16x2.f32).
//
// Where the time goes at gather's coordinates (an H100, altered copies timed
// against this source): ~3.3 ms of device time, keys 0.25, sort 0.57, index
// 0.40, walk 2.05. The merge is about half the walk (a walk that merged
// nothing took 1.0 ms), the g-row loads a sixth. Tried and slower: merging
// a cell a lane (32 cells a warp, no shuffles: each step then waited on the
// loads of four lists), a merge reading its lists' next rows from memory
// step by step (2.36 ms), maps in the sort key (21 bits, 3 passes: the index
// pass gained less than the sort lost), and at C = 128 records whose weights
// the walk loads (7-22%).
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

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;     // cells a warp in the narrow walk, a group of 4 lanes each
constexpr int kWindow = 8;   // rows of a list a lane holds in the narrow merge: 4 and 16 were slower
constexpr int kBatch = 32;   // records a cell stages a round in the walk
// g rows in flight a lane: in the narrow body by g's type (f32, bf16; f32's
// 16-byte rows gained from 8, bf16's lost), in the wide body (8 was slower)
constexpr int kNarrowUnroll[2] = {8, 4};
constexpr int kWideUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MAX;  // the head of an exhausted list: larger than any sample

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

// The float compares of the plain version's one-hot matrices: is tap
// coordinate f0 + t (t = 0, 1) inside [0, n - 1] for either t?
__device__ __forceinline__ bool any_tap_inside(float f0, int n) {
  const float x1 = f0 + 1.f;
  return (f0 >= 0.f && f0 <= (float)(n - 1)) || (x1 >= 0.f && x1 <= (float)(n - 1));
}

__global__ void __launch_bounds__(kThreads) warp_bwd_keys_kernel(const float* __restrict__ sx,
                                                                  const float* __restrict__ sy,
                                                                  unsigned* __restrict__ keys, int* __restrict__ order,
                                                                  float2* __restrict__ frac, int H, int W, int n) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int i = (int)t;
  const float x = sx[i];
  const float y = sy[i];
  const float fx = floorf(x);
  const float fy = floorf(y);
  // inside: fx in [-1, W - 1] and fy in [-1, H - 1], integers, so the casts are exact
  const bool inside = any_tap_inside(fx, W) && any_tap_inside(fy, H);
  keys[i] = inside ? (unsigned)(((int)fy + 1) * (W + 1) + (int)fx + 1) : (unsigned)((H + 1) * (W + 1));
  order[i] = i;
  frac[i] = make_float2(x - fx, y - fy);
}

// The bin (base cell, map) of the sample `row` keyed `key`: base * B + b,
// or num_bins for the sentinel.
__device__ __forceinline__ int bin_of(unsigned key, int row, int Q, int B, unsigned sentinel, int num_bins) {
  return key == sentinel ? num_bins : (int)key * B + row / Q;
}

// start[k] = the first sorted position whose bin is >= k, for k in
// [0, num_bins]: thread s in [0, n] writes s over (bin[s-1], bin[s]]
// (bin[-1] = -1, bin[n] = num_bins), so every k is written once; every
// thread of a warp takes part in the ballot. And rec[s] = frac[row], the
// fractions (wx1, wy1) of the sample at sorted position s, for the samples
// with a tap inside: one 8-byte read out of order, in place of two 4-byte
// ones of its coordinates.
__global__ void __launch_bounds__(kThreads) warp_bwd_index_kernel(const unsigned* __restrict__ sorted_keys,
                                                                   const int* __restrict__ sorted_order,
                                                                   const float2* __restrict__ frac,
                                                                   int* __restrict__ start, float2* __restrict__ rec,
                                                                   int n, int Q, int B, unsigned sentinel,
                                                                   int num_bins) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int s = (int)min(t, (long long)n);
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = -1;  // the range [lo, hi] this thread writes
  if (t <= n) {
    lo = (s == 0 ? -1 : bin_of(sorted_keys[s - 1], sorted_order[s - 1], Q, B, sentinel, num_bins)) + 1;
    if (s == n) {
      hi = num_bins;
    } else {
      const unsigned key = sorted_keys[s];
      const int row = sorted_order[s];
      hi = bin_of(key, row, Q, B, sentinel, num_bins);
      if (key != sentinel) rec[s] = frac[row];
    }
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

// Adds the U terms whose g rows (raw, loaded by the caller, U in flight) and
// weights ry = r, cx = w are given to acc, in order; terms t0 + u >= n are
// none.
template <typename T, int V, int U>
__device__ __forceinline__ void add_terms(const typename Lane<T, V>::Raw (&raw)[U], const float (&r)[U],
                                          const float (&w)[U], int t0, int n, float (&acc)[V]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (t0 + u < n) {
      float gv[V], p[V];
      Lane<T, V>::unpack(raw[u], gv);
      scaled_rounded<T, V>(r[u], gv, p);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = __fmaf_rn(w[u], p[v], acc[v]);
    }
  }
}

// The bin of tap (ty, tx) of a cell: its base cell (y - ty, x - tx) on the
// map's (H + 1) x (W + 1) grid, and the map b.
__device__ __forceinline__ int tap_bin(int cell, int ty, int tx, int H, int W, int B) {
  const int b = cell / (H * W);
  const int yx = cell - b * (H * W);
  const int y = yx / W;
  const int x = yx - y * W;
  return ((y + 1 - ty) * (W + 1) + (x + 1 - tx)) * B + b;
}

// The narrow body (4 lanes a cell, V channels a lane: C <= 4 V; U g rows in
// flight). A warp takes kTile cells; a group of 4 lanes merges and walks
// each, a lane a list (tap) in the merge and 4 channels a lane in the walk.
// Merge: each lane holds the next kWindow rows of its list in registers,
// reloaded every kWindow steps (no list gives more in that many), so a
// step waits on no load: the smallest head by two shuffles (the lists hold
// distinct samples, so it is one lane's), whose lane stages the record (g
// row, sorted position, tap) and shifts its window; kBatch records a cell a
// round. Walk: the group adds its cell's records, each tap's weights from
// the fractions at the record's position.
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads) warp_bwd_walk_kernel(const T* __restrict__ g,          // [B, Q, C]
                                                                  const int* __restrict__ order,   // sorted samples
                                                                  const float2* __restrict__ rec,  // their fractions
                                                                  const int* __restrict__ start,   // [num_bins + 1]
                                                                  T* __restrict__ out,             // [B, H, W, C]
                                                                  int C, int H, int W, int B, int num_cells) {
  static_assert(kBatch % U == 0 && kBatch % kWindow == 0, "whole loads and windows a round");
  // one spare slot a cell, so the 8 cells' records at one step fall in distinct banks
  __shared__ int4 batch[kWarps][kTile][kBatch + 1];
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kTile;
  if (first >= num_cells) return;  // the whole warp
  int4(*staged)[kBatch + 1] = batch[threadIdx.x >> 5];
  const int m = lane >> 2;  // the group's cell, first + m
  const int tap = lane & 3;
  int pos = 0, end = 0;  // this lane's list: tap of cell first + m
  if (first + m < num_cells) {
    const int bin = tap_bin(first + m, tap >> 1, tap & 1, H, W, B);
    pos = start[bin];
    end = start[bin + 1];
  }
  int left = end - pos;  // the cell's entries, summed over its group
  left += __shfl_xor_sync(kFull, left, 1);
  left += __shfl_xor_sync(kFull, left, 2);
  const int c = tap * V;
  const bool active = c < C;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  int win[kWindow];  // rows at positions pos, pos + 1, ... (kNone past the list)
  for (;;) {
    const int cnt = min(left, kBatch);  // the group's records this round
    const int steps = __reduce_max_sync(kFull, cnt);
    if (steps == 0) break;
    for (int t = 0; t < steps; ++t) {
      if (t % kWindow == 0) {
#pragma unroll
        for (int i = 0; i < kWindow; ++i) win[i] = pos + i < end ? order[pos + i] : kNone;
      }
      int head = win[0];
      head = min(head, __shfl_xor_sync(kFull, head, 1));
      head = min(head, __shfl_xor_sync(kFull, head, 2));
      if (win[0] == head && head != kNone) {
        staged[m][t] = make_int4(head, pos, tap, 0);
        ++pos;
#pragma unroll
        for (int i = 0; i + 1 < kWindow; ++i) win[i] = win[i + 1];
        win[kWindow - 1] = kNone;
      }
    }
    left -= cnt;
    __syncwarp();
    for (int t0 = 0; t0 < steps; t0 += U) {
      typename Lane<T, V>::Raw raw[U];
      float r[U], w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int4 e = staged[m][t0 + u];  // past cnt: another round's record, or none
        const bool live = t0 + u < cnt;
        const float2 f = live ? rec[e.y] : make_float2(0.f, 0.f);
        r[u] = round_to<T>((e.z >> 1) ? f.y : 1.f - f.y);
        w[u] = round_to<T>((e.z & 1) ? f.x : 1.f - f.x);
        raw[u] = (active && live) ? Lane<T, V>::load(g + (long long)e.x * C + c) : Lane<T, V>::zero();
      }
      add_terms<T, V, U>(raw, r, w, t0, cnt, acc);
    }
    __syncwarp();  // every lane has read the records before the next round writes them
  }
  if (active && first + m < num_cells) Lane<T, V>::store(out + (long long)(first + m) * C + c, acc);
}

// The elements of sorted w[0, len) below v (len <= 32).
__device__ __forceinline__ int count_below(const int* w, int len, int v) {
  int k = 0;
#pragma unroll
  for (int step = 32; step > 0; step >>= 1) {
    if (k + step <= len && w[k + step - 1] < v) k += step;
  }
  return k;
}

// The wide body (32 lanes a cell, V channels a lane): a warp takes one cell
// and merges its four lists with every lane: each list's next 32 rows go to
// shared memory, each candidate's rank is its index plus the rows below it in
// the other three windows (exact for the 32 smallest, which all lie in the
// windows), and the candidates of rank < 32 are that round's records (g row,
// ry, cx), walked with kWideUnroll g rows in flight. C wider than 32 V takes
// more passes, each merging anew.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) warp_bwd_wide_walk_kernel(const T* __restrict__ g,         // [B, Q, C]
                                                                       const int* __restrict__ order,  // samples
                                                                       const float2* __restrict__ rec,
                                                                       const int* __restrict__ start,
                                                                       T* __restrict__ out,  // [B, H, W, C]
                                                                       int C, int H, int W, int B, int num_cells) {
  constexpr int U = kWideUnroll;
  __shared__ int windows[kWarps][4][kBatch];
  __shared__ int4 batch[kWarps][kBatch];
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cell >= num_cells) return;  // the whole warp
  int(*win)[kBatch] = windows[threadIdx.x >> 5];
  int4* staged = batch[threadIdx.x >> 5];
  int lo = 0, hi = 0;
  if (lane < 4) {
    const int bin = tap_bin(cell, lane >> 1, lane & 1, H, W, B);
    lo = start[bin];
    hi = start[bin + 1];
  }
  int first[4], end[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    first[k] = __shfl_sync(kFull, lo, k);
    end[k] = __shfl_sync(kFull, hi, k);
  }
  for (int c0 = 0; c0 < C; c0 += 32 * V) {
    const int c = c0 + lane * V;
    const bool active = c < C;  // V = 4 only when C % 4 == 0: a lane's vector is whole or outside
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    int pos[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) pos[k] = first[k];
    for (;;) {
      int len[4], left = 0;
      int4 cand[4];  // (g row, ry, cx) of tap k at position pos[k] + lane
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        len[k] = min(kBatch, end[k] - pos[k]);
        left += end[k] - pos[k];
        if (lane < len[k]) {
          const int s = pos[k] + lane;
          const float2 f = rec[s];
          cand[k] = make_int4(order[s], __float_as_int(round_to<T>((k >> 1) ? f.y : 1.f - f.y)),
                              __float_as_int(round_to<T>((k & 1) ? f.x : 1.f - f.x)), 0);
          win[k][lane] = cand[k].x;
        }
      }
      if (left == 0) break;
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int rank = kBatch;
        if (lane < len[k]) {
          rank = lane;
#pragma unroll
          for (int o = 1; o < 4; ++o) rank += count_below(win[(k + o) & 3], len[(k + o) & 3], cand[k].x);
          if (rank < kBatch) staged[rank] = cand[k];
        }
        pos[k] += __popc(__ballot_sync(kFull, rank < kBatch));
      }
      __syncwarp();
      const int n = min(left, kBatch);
      for (int t0 = 0; t0 < n; t0 += U) {  // t0 + u < kBatch: U divides it
        typename Lane<T, V>::Raw raw[U];
        float r[U], w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int4 e = staged[t0 + u];
          r[u] = __int_as_float(e.y);
          w[u] = __int_as_float(e.z);
          raw[u] = (active && t0 + u < n) ? Lane<T, V>::load(g + (long long)e.x * C + c) : Lane<T, V>::zero();
        }
        add_terms<T, V, U>(raw, r, w, t0, n, acc);
      }
      __syncwarp();  // every lane has read the windows and records before the next round writes them
    }
    if (active) Lane<T, V>::store(out + (long long)cell * C + c, acc);
  }
}

struct Body {
  int lanes, vec;
};

// The walk's body for C channels of g and out (dtype 0 = f32, 1 = bf16): 4
// channels a lane when C % 4 == 0 and both are aligned to 4 elements, else
// one; the narrow body (4 lanes a cell) when 4 lanes cover C, else the wide
// body (32 lanes a cell).
Body choose_body(int C, int dtype, const void* g, const void* out) {
  const size_t align = (dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16)) * 4;
  const int vec = C % 4 == 0 && reinterpret_cast<size_t>(g) % align == 0 && reinterpret_cast<size_t>(out) % align == 0
                      ? 4
                      : 1;
  return {C <= 4 * vec ? 4 : 32, vec};
}

template <typename T, int V>
void launch_walk(int lanes, const T* g, const int* order, const float2* rec, const int* start, T* out, int C, int H,
                 int W, int B, int num_cells, cudaStream_t st) {
  if (lanes == 4) {
    constexpr int U = kNarrowUnroll[std::is_same<T, float>::value ? 0 : 1];
    warp_bwd_walk_kernel<T, V, U><<<(unsigned)((num_cells + kWarps * kTile - 1) / (kWarps * kTile)), kThreads, 0,
                                    st>>>(g, order, rec, start, out, C, H, W, B, num_cells);
  } else {
    warp_bwd_wide_walk_kernel<T, V><<<(unsigned)((num_cells + kWarps - 1) / kWarps), kThreads, 0, st>>>(
        g, order, rec, start, out, C, H, W, B, num_cells);
  }
}

template <typename T>
void launch_walk(Body body, const void* g, const int* order, const float2* rec, const int* start, void* out, int C,
                 int H, int W, int B, int num_cells, cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (body.vec == 4) {
    launch_walk<T, 4>(body.lanes, gt, order, rec, start, ot, C, H, W, B, num_cells, st);
  } else {
    launch_walk<T, 1>(body.lanes, gt, order, rec, start, ot, C, H, W, B, num_cells, st);
  }
}

// Samples, cells and bins (with the sentinel's) in int32; the grid's
// coordinates exact in f32; end_bit covering the sentinel (H + 1) * (W + 1).
bool sizes_ok(int B, int Q, int H, int W, int end_bit) {
  const long long grid = ((long long)H + 1) * ((long long)W + 1);
  return B >= 0 && Q >= 0 && H > 0 && W > 0 && H < (1 << 24) && W < (1 << 24) &&
         (long long)B * Q < 0x7fffffffLL && (long long)B * H * W < 0x7fffffffLL && grid * B < 0x7fffffffLL &&
         end_bit >= 1 && end_bit <= 32 && (grid >> end_bit) == 0;
}

}  // namespace

extern "C" int warp_bwd_temp_bytes(int n, int end_bit, size_t* bytes) {
  (void)cudaGetLastError();
  *bytes = 0;
  return (int)CUB_NS_QUALIFIER::DeviceRadixSort::SortPairs(
      nullptr, *bytes, static_cast<const unsigned*>(nullptr), static_cast<unsigned*>(nullptr),
      static_cast<const int*>(nullptr), static_cast<int*>(nullptr), n, 0, end_bit);
}

// The walk's body for these arguments of warp_bwd_launch: lanes a cell (4,
// 8, 16 or 32) and channels a lane (4 or 1).
extern "C" int warp_bwd_body(int C, int dtype, const void* g, const void* out, int* lanes, int* vec) {
  if (C <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Body body = choose_body(C, dtype, g, out);
  *lanes = body.lanes;
  *vec = body.vec;
  return (int)cudaSuccess;
}

// keys, keys_sorted, order, order_sorted: B*Q each (unsigned / int32); rec:
// 2*B*Q float2 (the fractions in input order, then sorted); start: B*(H+1)*(W+1) + 1 int32; temp: temp_bytes from
// warp_bwd_temp_bytes(B*Q, end_bit). end_bit must cover the sentinel
// (H+1)*(W+1). dtype: 0 = f32, 1 = bf16 (g and out).
extern "C" int warp_bwd_launch(const void* g, const void* sx, const void* sy, void* out, void* keys,
                               void* keys_sorted, void* order, void* order_sorted, void* rec, void* start, void* temp,
                               size_t temp_bytes, int B, int Q, int H, int W, int C, int dtype, int end_bit,
                               void* stream) {
  (void)cudaGetLastError();  // start from a clean error state: report only this launch
  if (!sizes_ok(B, Q, H, W, end_bit) || C < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int n = B * Q;
  const int num_cells = B * H * W;
  if (num_cells == 0 || C == 0) return (int)cudaSuccess;
  const unsigned sentinel = (unsigned)((H + 1) * (W + 1));
  const int num_bins = (int)sentinel * B;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* k_in = static_cast<unsigned*>(keys);
  unsigned* k_out = static_cast<unsigned*>(keys_sorted);
  int* o_in = static_cast<int*>(order);
  int* o_out = static_cast<int*>(order_sorted);
  float2* frac = static_cast<float2*>(rec);  // the fractions in input order, then in sorted order
  int* starts = static_cast<int*>(start);
  const float* fx = static_cast<const float*>(sx);
  const float* fy = static_cast<const float*>(sy);
  cudaError_t err = cudaSuccess;
  if (n > 0) {
    warp_bwd_keys_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(fx, fy, k_in, o_in, frac, H,
                                                                                         W, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    size_t bytes = temp_bytes;
    err = CUB_NS_QUALIFIER::DeviceRadixSort::SortPairs(temp, bytes, k_in, k_out, o_in, o_out, n, 0, end_bit, st);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  warp_bwd_index_kernel<<<(unsigned)(((long long)n + kThreads) / kThreads), kThreads, 0, st>>>(
      k_out, o_out, frac, starts, frac + n, n, Q, B, sentinel, num_bins);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const Body body = choose_body(C, dtype, g, out);
  if (dtype == 0) {
    launch_walk<float>(body, g, o_out, frac + n, starts, out, C, H, W, B, num_cells, st);
  } else {
    launch_walk<__nv_bfloat16>(body, g, o_out, frac + n, starts, out, C, H, W, B, num_cells, st);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* warp_bwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
