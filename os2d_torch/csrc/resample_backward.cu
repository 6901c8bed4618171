// Gradient of the correlation resample + masked pool, for training: the
// backward of both forward tiers (hat_resample.cu, "default", and
// resample.cu, "high"/"highest").
//
// The TPU package has no Pallas backward: its trainer differentiates the XLA
// hat-weight einsums of os2d_tpu/ops/sampling.py:
// resample_correlation_from_pxpy at every tier (the Pallas forwards
// os2d_tpu/ops/pallas_resample.py:_resample_kernel and
// os2d_tpu/ops/pallas_hat_resample.py:_hat_resample_kernel are eval-only).
// These kernels compute that gradient in the hat form with JAX's rules, fp32:
//
//   out[bc, a] = sum_t mask[c, t] * sum_{h, w} hy_h(py) corr[bc, h, w, t] hx_w(px)
//   hx_w(p) = max(0, 1 - |p - w|), d hx_w / dp = -sign+(p - w) where
//   |p - w| < 1 (sign+(0) = +1, JAX's abs), half of that where |p - w| == 1
//   (JAX's max splits a tie), 0 elsewhere; indices outside the map dropped.
//
// Per (bc, anchor a, template point t), with go = g * mask, gd = g_sum *
// mask and v[i][j] the corr value at row floor(py) - 1 + i, column
// floor(px) - 1 + j:
//   dpx[bc, t, a] = sum_j dhx_j * (go * (hy_1 v[1][j] + hy_2 v[2][j]))
//   dpy[bc, t, a] = sum_i dhy_i * ((go * hx_1) v[i][1] + (go * hx_2) v[i][2])
//   dcorr[bc, cell, t] += hy_i * (gd * hx_j)   for i, j in {1, 2}, both non-zero
// with every product and sum rounded on its own in the order of the plain
// version (os2d_torch/ops/sampling.py: resample_backward_reference), so dpx
// and dpy agree with it to the bit. A weight is non-zero only at floor(p) and
// floor(p) + 1 (offsets 1, 2); a derivative also at offsets 0 and 3, at
// exact ties (integer p). g_sum is g plus the gradient of the head's
// cls_detached (the same resample with px/py detached), which reaches corr
// but not px/py.
//
// Bound on an H100: bytes. Read the corr prefix, px, py, g, g_sum and the
// mask once, write dpx, dpy and all t_full channels of dcorr once: 0.0918 ms
// at 3.35 TB/s for the training shape (B=4, C=16, fm 38x38, T=121 of 225).
// dcorr is a scatter (many anchors sample one cell), summed with fp32
// atomics, so it agrees with the plain version up to the order of its sums.
// What held the first kernel (0.78 ms at that shape on an H100, 3.1x
// aten.grid_sampler_2d_backward) back, and what this design does about it:
// - Its atomics went straight into dcorr's [BC, H, W, t_full] layout, where
//   the 32 anchors of a warp at one t add to cells 900 bytes apart: each add
//   was its own L2 sector operation. Here the scatter kernel adds into a
//   scratch in the library's layout, [BC, T, H*W]: a warp's adds at one t
//   fall on neighbouring words of one plane, a few sectors an instruction.
//   The adds' results are unused, so they compile to red.
// - Neighbouring lanes at near-identity px/py add to the same cells: lane
//   i's right-hand column is lane i+1's left-hand one. Lane i+1 then adds
//   both contributions with one red, and lane i adds nothing there. The
//   test is the forward's corner-sharing test (resample_tile.cuh); any
//   px/py gives the right sums, only the count of adds changes.
// - It computed four weights and derivatives an axis and read up to 12
//   cells a sample, in one dependent chain per t. Here each axis has a
//   window of two cells, floor(p) clamped to [0, n - 2], which holds both
//   non-zero weights and, at p = n - 1 (the head clips px/py to the map),
//   the one derivative off floor(p) and floor(p) + 1 as well; so a sample
//   needs its 2x2 window and two-term sums. Only a tie (an integer p inside
//   the map) has a derivative outside the window; its dpx/dpy are computed
//   again, in the plain version's full form, after the main loop, for the
//   chunks that had one.
// - The loads follow the forward's skeleton: 8x32 anchor tiles, t in chunks
//   of kChunk, the chunk's px/py/mask loads, then its left-hand window
//   cells, then its right-hand ones (from the next lane by shuffle where it
//   holds the same cells) issued together, so each chunk waits on memory
//   twice.
// - The first kernel zero-filled all 225 channels of dcorr and then wrote
//   the 121-channel prefix scattered. Here the memset clears the scratch
//   (the T channels only), and the transpose kernel writes dcorr whole,
//   once: it reads scratch rows along H*W into a shared-memory tile and
//   writes each block's contiguous run of dcorr in order, with exact zeros
//   in channels t >= T (as JAX's gradient through corr[..., :T] leaves them).
// The scratch's memset, red traffic and read (3 x 44.7 MB at the training
// shape) are not in the bound. The one C entry point enqueues the memset and
// both kernels on the caller's stream, allocates nothing and does not
// synchronise. Measured times and the designs tried are in PERF.md.

#include "resample_tile.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// template points whose coordinate and corner loads a thread issues together
constexpr int kChunk = 4;
constexpr int kTransposeTile = 32;  // anchors per transpose block

struct BackwardArgs {
  const float* g;      // [BC, H*W]
  const float* g_sum;  // [BC, H*W]
  const float* corr;   // [BC, H, W, t_full]
  const float* px;     // [BC, T, H*W]
  const float* py;     // [BC, T, H*W]
  const float* mask;   // [C, T]
  float* scratch;      // [BC, T, H*W], zeroed: dcorr's channels t < T
  float* dpx;          // [BC, T, H*W]
  float* dpy;          // [BC, T, H*W]
  int num_classes, h, w, t_count, t_full;
  int tiles_x, tiles_y;
};

// *p += value unless value is 0 (a NaN is added), as a predicated
// red.global.add.f32: an atomic add whose result is unused, with no branch
__device__ __forceinline__ void add_if(float value, float* p) {
  asm volatile(
      "{\n .reg .pred q;\n setp.neu.f32 q, %1, 0f00000000;\n @q red.global.add.f32 [%0], %1;\n}\n"
      :
      : "l"(p), "f"(value)
      : "memory");
}

// The hat weight max(0, 1 - |p - i|) of index i and its derivative by p
// under JAX's rules, for an i inside the map; p - i rounded in fp32 as the
// plain version takes it (i is an integer held as a float).
__device__ __forceinline__ void hat_at(float p, float i, float& wt, float& der) {
  const float diff = __fsub_rn(p, i);
  const float ad = fabsf(diff);
  const float sign = diff >= 0.0f ? -1.0f : 1.0f;
  wt = fmaxf(0.0f, __fsub_rn(1.0f, ad));
  der = ad < 1.0f ? sign : (ad == 1.0f ? 0.5f * sign : 0.0f);
}

// A sample's window on one axis of n cells: the indices c, c + 1 with c =
// floor(p) clamped to [0, n - 2] (0 where n = 1, and c + 1 is then off the
// map). It holds both non-zero weights (at floor(p) and floor(p) + 1) and,
// at p = n - 1 (the head clips px/py to the map, so the last row and column
// are common), the derivative at n - 2 too.
__device__ __forceinline__ float window_start(float fl, float n) {
  return fmaxf(fminf(fl, n - 2.0f), 0.0f);
}

struct Window {
  float wt0, wt1, der0, der1;  // at c and c + 1
};

__device__ __forceinline__ Window window(float p, float c, bool second_inside) {
  Window a;
  hat_at(p, c, a.wt0, a.der0);
  hat_at(p, c + 1.0f, a.wt1, a.der1);
  if (!second_inside) a.wt1 = a.der1 = 0.0f;
  return a;
}

// Whether p (floor fl) has a non-zero derivative outside its window, where
// the window's sums would miss it: an integer inside the map (the derivative
// -0.5 at fl - 1), a difference to fl + 2 rounded to exactly -1 (+0.5
// there), or p off the map. Off the window the derivative at fl - 1 is -0.5
// or 0 (p - (fl - 1) >= 1), at fl + 2 +0.5 or 0, and fl - 1 is in the window
// only at fl = n - 1.
__device__ __forceinline__ bool tie(float p, float fl, float n) {
  return fl < 0.0f || fl > n - 1.0f ||
         (fl >= 1.0f && fl != n - 1.0f && __fsub_rn(p, fl - 1.0f) == 1.0f) ||
         (fl + 2.0f < n && __fsub_rn(p, fl + 2.0f) == -1.0f);
}

// the hat weights and JAX derivatives at indices floor(p) - 1 .. floor(p) + 2
// (zero outside [0, n)); returns floor(p) - 1
__device__ __forceinline__ int axis_terms(float p, int n, float wt[4], float der[4]) {
  const int base = static_cast<int>(floorf(p)) - 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = base + k;
    hat_at(p, static_cast<float>(i), wt[k], der[k]);
    if (i < 0 || i >= n) wt[k] = der[k] = 0.0f;
  }
  return base;
}

// dpx, dpy of a tie, as the plain version computes them: its four offsets
// on each axis, every cell that a product needs loaded here
__device__ __forceinline__ void tie_terms(const float* gp, int t_full, float x, float y, int h,
                                          int w, float go, float& sx, float& sy) {
  float hx[4], dhx[4], hy[4], dhy[4];
  const int x_base = axis_terms(x, w, hx, dhx);
  const int y_base = axis_terms(y, h, hy, dhy);
  float v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool need = (hy[i] != 0.0f && (hx[j] != 0.0f || dhx[j] != 0.0f)) ||
                        (dhy[i] != 0.0f && hx[j] != 0.0f);
      const int64_t cell = static_cast<int64_t>(y_base + i) * w + (x_base + j);
      v[i][j] = os2d::load_if(need, gp + cell * t_full, 0.0f);
    }
  }
  sx = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float r = __fadd_rn(__fmul_rn(hy[1], v[1][j]), __fmul_rn(hy[2], v[2][j]));
    sx = __fadd_rn(sx, __fmul_rn(dhx[j], __fmul_rn(go, r)));
  }
  const float gx1 = __fmul_rn(go, hx[1]), gx2 = __fmul_rn(go, hx[2]);
  sy = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = __fadd_rn(__fmul_rn(gx1, v[i][1]), __fmul_rn(gx2, v[i][2]));
    sy = __fadd_rn(sy, __fmul_rn(dhy[i], q));
  }
}

// What a thread of the scatter kernel holds for all t: its anchor's
// pointers at t = 0 and the map's constants.
struct Lane {
  const float* plane;  // corr [H*W, t_full] of this (b, c)
  const float* px;     // px[bc, 0, a]; t advances by a_count
  const float* py;
  float* dpx;
  float* dpy;
  float* splane;       // scratch [T, H*W] of this (b, c)
  const float* mask;   // mask[c, 0]
  float g, g_sum;      // 0 for a lane past the map
  float wf, hf;
  int w, a_count, t_full;
  int dx, dy;          // cell offset of the window's second column and row (0 where n = 1)
  int lane;
  bool valid;
};

// K template points t0 .. t0 + K - 1 of one lane (a full chunk, or K = 1 for
// the tail): dpx and dpy (a tie's are redone later), and dcorr's
// contributions added into the scratch. Returns whether a sample was a tie.
template <int K>
__device__ __forceinline__ bool scatter_chunk(const Lane& l, int t0) {
  float x[K], y[K], m[K], xfl[K], yfl[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = l.valid ? __ldg(l.px + (t0 + k) * l.a_count) : 0.0f;
    y[k] = l.valid ? __ldg(l.py + (t0 + k) * l.a_count) : 0.0f;
    m[k] = __ldg(l.mask + t0 + k);
  }
  // the window values, in two rounds of loads that are each all in flight
  // together: the left-hand column, then the right-hand one, taken from the
  // next lane where its left-hand cell is this lane's right-hand one
  // (near-identity px/py; the rows then match too), else loaded
  int i00[K];
  float v00[K], v10[K], v01[K], v11[K];
  bool got[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    xfl[k] = floorf(x[k]);
    yfl[k] = floorf(y[k]);
    i00[k] = static_cast<int>(window_start(yfl[k], l.hf)) * l.w +
             static_cast<int>(window_start(xfl[k], l.wf));
    const float* p = l.plane + t0 + k + i00[k] * l.t_full;
    v00[k] = __ldg(p);
    v10[k] = __ldg(p + l.dy * l.t_full);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // every lane takes part in every shuffle (lane 31's results unused)
    const int next00 = __shfl_down_sync(kFull, i00[k], 1);
    const float u00 = __shfl_down_sync(kFull, v00[k], 1);
    const float u10 = __shfl_down_sync(kFull, v10[k], 1);
    got[k] = l.lane < 31 && next00 == i00[k] + l.dx;
    const float* p = l.plane + t0 + k + (i00[k] + l.dx) * l.t_full;
    v01[k] = os2d::load_if(!got[k], p, u00);
    v11[k] = os2d::load_if(!got[k], p + l.dy * l.t_full, u10);
  }

  bool any_tie = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k;
    const Window X = window(x[k], window_start(xfl[k], l.wf), l.dx != 0);
    const Window Y = window(y[k], window_start(yfl[k], l.hf), l.dy != 0);
    any_tie |= l.valid && (tie(x[k], xfl[k], l.wf) || tie(y[k], yfl[k], l.hf));
    // every non-zero weight, and away from ties every non-zero derivative,
    // lies in the window: the plain version's sums over four offsets add
    // signed zeros besides these two terms each, in the same order, so these
    // give its values
    const float go = __fmul_rn(l.g, m[k]);
    const float r0 = __fadd_rn(__fmul_rn(Y.wt0, v00[k]), __fmul_rn(Y.wt1, v10[k]));
    const float r1 = __fadd_rn(__fmul_rn(Y.wt0, v01[k]), __fmul_rn(Y.wt1, v11[k]));
    const float sx = __fadd_rn(__fmul_rn(X.der0, __fmul_rn(go, r0)),
                               __fmul_rn(X.der1, __fmul_rn(go, r1)));
    const float gx0 = __fmul_rn(go, X.wt0), gx1 = __fmul_rn(go, X.wt1);
    const float q0 = __fadd_rn(__fmul_rn(gx0, v00[k]), __fmul_rn(gx1, v01[k]));
    const float q1 = __fadd_rn(__fmul_rn(gx0, v10[k]), __fmul_rn(gx1, v11[k]));
    const float sy = __fadd_rn(__fmul_rn(Y.der0, q0), __fmul_rn(Y.der1, q1));
    if (l.valid) {
      l.dpx[t * l.a_count] = sx;
      l.dpy[t * l.a_count] = sy;
    }

    // dcorr: hy * (gd * hx) where both weights are non-zero (a zero
    // contribution is not added, which changes no sum); a right-hand one
    // goes to the next lane where `got`, and this lane adds the previous
    // lane's likewise
    const float gd = __fmul_rn(l.g_sum, m[k]);
    const float gx0d = X.wt0 != 0.0f ? __fmul_rn(gd, X.wt0) : 0.0f;
    const float gx1d = X.wt1 != 0.0f ? __fmul_rn(gd, X.wt1) : 0.0f;
    const float c00 = Y.wt0 != 0.0f ? __fmul_rn(Y.wt0, gx0d) : 0.0f;
    const float c10 = Y.wt1 != 0.0f ? __fmul_rn(Y.wt1, gx0d) : 0.0f;
    const float c01 = Y.wt0 != 0.0f ? __fmul_rn(Y.wt0, gx1d) : 0.0f;
    const float c11 = Y.wt1 != 0.0f ? __fmul_rn(Y.wt1, gx1d) : 0.0f;
    const bool take = __shfl_up_sync(kFull, got[k], 1) && l.lane > 0;
    const float q01 = __shfl_up_sync(kFull, c01, 1);
    const float q11 = __shfl_up_sync(kFull, c11, 1);
    float* sp = l.splane + t * l.a_count + i00[k];
    add_if(take ? __fadd_rn(c00, q01) : c00, sp);
    add_if(take ? __fadd_rn(c10, q11) : c10, sp + l.dy);
    add_if(got[k] ? 0.0f : c01, sp + l.dx);
    add_if(got[k] ? 0.0f : c11, sp + l.dx + l.dy);
  }
  return any_tie;
}

__global__ void __launch_bounds__(os2d::kThreads)
resample_backward_scatter_kernel(const BackwardArgs args) {
  const int h = args.h, w = args.w, t_count = args.t_count, t_full = args.t_full;
  const int tiles = args.tiles_x * args.tiles_y;
  const int bc = blockIdx.x / tiles;
  const int tile = blockIdx.x - bc * tiles;
  const int tile_y = tile / args.tiles_x;
  const int tile_x = tile - tile_y * args.tiles_x;
  const int ax = tile_x * os2d::kTileCols + (threadIdx.x & 31);
  const int ay = tile_y * os2d::kTileRows + (threadIdx.x >> 5);
  // lanes past the map stay to the end (they take part in the shuffles, and
  // may add a neighbour's contribution) but load no coordinates, store
  // nothing and contribute nothing of their own (their g_sum is 0)
  const bool valid = ax < w && ay < h;
  const int a_count = h * w;
  const int a = valid ? ay * w + ax : 0;
  // a plane's offsets fit in 32 bits (the entry point checks)
  const int64_t coord_base = static_cast<int64_t>(bc) * t_count * a_count;
  const Lane l{args.corr + static_cast<int64_t>(bc) * a_count * t_full,
               args.px + coord_base + a,
               args.py + coord_base + a,
               args.dpx + coord_base + a,
               args.dpy + coord_base + a,
               args.scratch + coord_base,
               args.mask + static_cast<int64_t>(bc % args.num_classes) * t_count,
               valid ? args.g[static_cast<int64_t>(bc) * a_count + a] : 0.0f,
               valid ? args.g_sum[static_cast<int64_t>(bc) * a_count + a] : 0.0f,
               static_cast<float>(w),
               static_cast<float>(h),
               w,
               a_count,
               t_full,
               w > 1 ? 1 : 0,
               h > 1 ? w : 0,
               static_cast<int>(threadIdx.x & 31),
               valid};

  // bit i: a tie in chunk i (bit 63: in chunk 63 or later)
  uint64_t tie_chunks = 0;
  int t0 = 0;
  for (; t0 + kChunk <= t_count; t0 += kChunk)
    if (scatter_chunk<kChunk>(l, t0)) tie_chunks |= uint64_t{1} << min(t0 / kChunk, 63);
  for (int t = t0; t < t_count; ++t)
    if (scatter_chunk<1>(l, t)) tie_chunks |= uint64_t{1} << min(t / kChunk, 63);

  // the ties (rare on the main path: an integer px or py inside the map),
  // out of the loop above so that their code costs it nothing
  while (tie_chunks) {
    const int chunk = __ffsll(static_cast<long long>(tie_chunks)) - 1;
    tie_chunks &= tie_chunks - 1;
    const int end = chunk == 63 ? t_count : min(t_count, (chunk + 1) * kChunk);
    for (int t = chunk * kChunk; t < end; ++t) {
      const float x = __ldg(l.px + t * a_count), y = __ldg(l.py + t * a_count);
      if (tie(x, floorf(x), l.wf) || tie(y, floorf(y), l.hf)) {
        float sx, sy;
        tie_terms(l.plane + t, t_full, x, y, h, w, __fmul_rn(l.g, __ldg(l.mask + t)), sx, sy);
        l.dpx[t * a_count] = sx;
        l.dpy[t * a_count] = sy;
      }
    }
  }
}

// dcorr [BC, H*W, t_full] from the scratch [BC, T, H*W]: a block owns
// kTransposeTile consecutive anchors of one plane, whose dcorr rows are one
// contiguous run. It reads their T scratch rows (along H*W) into a padded
// shared tile [T][kTransposeTile + 1], then writes the run in order, with
// channels t >= T written 0 without a read.
__global__ void __launch_bounds__(os2d::kThreads)
resample_backward_transpose_kernel(const float* scratch, float* dcorr, int a_count,
                                   int t_count, int t_full, int a_tiles) {
  extern __shared__ float tile[];  // [t_count][kTransposeTile + 1]
  constexpr int kPitch = kTransposeTile + 1;
  const int bc = blockIdx.x / a_tiles;
  const int a0 = (blockIdx.x - bc * a_tiles) * kTransposeTile;
  const int na = min(kTransposeTile, a_count - a0);
  const float* src = scratch + static_cast<int64_t>(bc) * t_count * a_count + a0;
  float* dst = dcorr + (static_cast<int64_t>(bc) * a_count + a0) * t_full;
  for (int i = threadIdx.x; i < t_count * kTransposeTile; i += os2d::kThreads) {
    const int t = i / kTransposeTile, r = i % kTransposeTile;
    tile[t * kPitch + r] = r < na ? src[static_cast<int64_t>(t) * a_count + r] : 0.0f;
  }
  __syncthreads();
  // the run in order, consecutive threads on consecutive floats; (r, t) is
  // the anchor and channel of element e
  const int step_r = os2d::kThreads / t_full, step_t = os2d::kThreads - step_r * t_full;
  int r = threadIdx.x / t_full, t = threadIdx.x - r * t_full;
  for (int e = threadIdx.x; e < na * t_full; e += os2d::kThreads) {
    dst[e] = t < t_count ? tile[t * kPitch + r] : 0.0f;
    r += step_r;
    t += step_t;
    if (t >= t_full) {
      t -= t_full;
      ++r;
    }
  }
}

}  // namespace

// Enqueues on `stream` the scratch's memset, the scatter kernel and the
// transpose kernel, and returns the first CUDA error code (0 on success).
// The caller has checked shapes, strides and devices: g and g_sum are
// [B*C, H*W], corr and dcorr [B*C, H, W, t_full] contiguous, px/py/dpx/dpy
// [B*C, T, H*W], mask [C, T], scratch [B*C, T, H*W] (any contents). It
// refuses a plane of more than 2^31 - 1 floats, and a T whose transpose tile
// exceeds the 227 KB of shared memory a block may have (T > 1760).
extern "C" int os2d_resample_correlation_backward(
    const float* g, const float* g_sum, const float* corr, const float* px, const float* py,
    const float* mask, float* scratch, float* dcorr, float* dpx, float* dpy, int bc_count,
    int num_classes, int h, int w, int t_count, int64_t t_full, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (w + os2d::kTileCols - 1) / os2d::kTileCols;
  const int tiles_y = (h + os2d::kTileRows - 1) / os2d::kTileRows;
  const int64_t blocks = static_cast<int64_t>(bc_count) * tiles_x * tiles_y;
  const int a_count = h * w;
  const int a_tiles = (a_count + kTransposeTile - 1) / kTransposeTile;
  const int64_t transpose_blocks = static_cast<int64_t>(bc_count) * a_tiles;
  // the kernels index within one plane in 32 bits
  const int64_t plane_size =
      static_cast<int64_t>(a_count) * (t_full > t_count ? t_full : int64_t{t_count});
  if (blocks < 1 || blocks > INT_MAX || transpose_blocks > INT_MAX || plane_size > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(float) * static_cast<size_t>(bc_count) * t_count * a_count, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BackwardArgs args{g, g_sum, corr, px, py, mask, scratch, dpx, dpy, num_classes, h, w,
                          t_count, static_cast<int>(t_full), tiles_x, tiles_y};
  resample_backward_scatter_kernel<<<static_cast<unsigned>(blocks), os2d::kThreads, 0, s>>>(
      args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t tile_bytes = sizeof(float) * (kTransposeTile + 1) * static_cast<size_t>(t_count);
  if (tile_bytes > 48 * 1024) {  // above the default limit of dynamic shared memory
    err = cudaFuncSetAttribute(resample_backward_transpose_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(tile_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  resample_backward_transpose_kernel<<<static_cast<unsigned>(transpose_blocks), os2d::kThreads,
                                       tile_bytes, s>>>(scratch, dcorr, a_count, t_count,
                                                        static_cast<int>(t_full), a_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
