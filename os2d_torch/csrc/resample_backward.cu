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
//
// dcorr is a scatter (many anchors sample one cell). No two threads ever
// add into one value at once: each cell's terms are summed by one thread
// after another in the plain version's order, so dcorr repeats to the bit
// from call to call and equals the plain version on the CPU to the bit (its
// scatter_add_ adds along the anchors in order; CUDA's scatter_add_ does
// not keep an order). The plain version adds, per t, corner (1,1)'s terms
// of all anchors in ascending order, then corner (1,2)'s, (2,1)'s and
// (2,2)'s. Three kernels behind one entry point:
// - the scatter kernel computes dpx and dpy only;
// - the dcorr kernel gives each (bc, t) plane one owner warp, whose
//   accumulator [H*W] lies in shared memory where it fits (else in the
//   scratch plane itself). The warp walks corner k, then the anchors in
//   chunks of 32, and computes each term from px, py and g_sum (a term does
//   not depend on corr). The lanes of a chunk whose terms fall on one cell
//   add them one round each, in lane order; lanes on distinct cells add in
//   the same round. Every cell thus gets its terms in the plain version's
//   order, with one writer at a time;
// - the transpose kernel writes dcorr whole from the scratch.
// A design that writes each sample's four terms to a [B*C, T, 4, H*W]
// buffer from the scatter kernel moves 2 x 179 MB more at the training
// shape; since a term needs no corr value, the dcorr kernel recomputes it
// from px/py (89 MB, read again) instead. The scatter kernel adds nothing
// into the scratch, which needs no memset.
//
// What held the first kernel (0.78 ms at that shape on an H100, 3.1x
// aten.grid_sampler_2d_backward) back, and what the scatter kernel does
// about it:
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
//   the 121-channel prefix scattered. Here the transpose kernel writes dcorr
//   whole, once: it reads scratch rows along H*W into a shared-memory tile
//   and writes each block's contiguous run of dcorr in order, with exact
//   zeros in channels t >= T (as JAX's gradient through corr[..., :T] leaves
//   them).
// The scratch's write and read (2 x 44.7 MB at the training shape) and the
// second read of px/py are not in the bound. The one C entry point enqueues
// the three kernels on the caller's stream, allocates nothing and does not
// synchronise. Measured times and the designs tried are in PERF.md.

#include <algorithm>

#include "resample_tile.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// template points whose coordinate and corner loads a thread issues together
constexpr int kChunk = 4;
constexpr int kTransposeTile = 32;  // anchors per transpose block
constexpr int kDcorrWarps = 4;      // (bc, t) planes per dcorr block, one warp each
// chunks of 32 anchors whose loads a dcorr warp issues together
constexpr int kDcorrDepth = 4;
// the dcorr kernel's accumulators live in shared memory up to this many
// bytes a block (the 227 KB a block may have, less a margin)
constexpr size_t kDcorrSharedBytes = 200 * 1024;

struct BackwardArgs {
  const float* g;      // [BC, H*W]
  const float* corr;   // [BC, H, W, t_full]
  const float* px;     // [BC, T, H*W]
  const float* py;     // [BC, T, H*W]
  const float* mask;   // [C, T]
  float* dpx;          // [BC, T, H*W]
  float* dpy;          // [BC, T, H*W]
  int num_classes, h, w, t_count, t_full;
  int tiles_x, tiles_y;
};

struct DcorrArgs {
  const float* g_sum;  // [BC, H*W]
  const float* px;     // [BC, T, H*W]
  const float* py;     // [BC, T, H*W]
  const float* mask;   // [C, T]
  float* scratch;      // [BC, T, H*W]: dcorr's channels t < T, every value written
  int64_t plane_count; // BC * T
  int num_classes, h, w, t_count;
  int warps;           // planes per block
  bool shared;         // accumulators in shared memory (else in the scratch)
};

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
  const float* mask;   // mask[c, 0]
  float g;             // 0 for a lane past the map
  float wf, hf;
  int w, a_count, t_full;
  int dx, dy;          // cell offset of the window's second column and row (0 where n = 1)
  int lane;
  bool valid;
};

// K template points t0 .. t0 + K - 1 of one lane (a full chunk, or K = 1 for
// the tail): dpx and dpy (a tie's are redone later). Returns whether a
// sample was a tie.
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
  // lanes past the map stay to the end (they take part in the shuffles) but
  // load no coordinates and store nothing
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
               args.mask + static_cast<int64_t>(bc % args.num_classes) * t_count,
               valid ? args.g[static_cast<int64_t>(bc) * a_count + a] : 0.0f,
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

// The plain version's hat weight of index i = floor(p) - 1 + k (k = 1, 2)
// on one axis of n cells, i formed as it forms it: 0 outside the map (a NaN
// p is outside too), else max(0, 1 - |p - i|) with a NaN kept.
__device__ __forceinline__ float plain_weight(float p, int k, float n, float& i) {
  i = __fadd_rn(__fsub_rn(floorf(p), 1.0f), static_cast<float>(k));
  if (!(i >= 0.0f && i < n)) return 0.0f;
  const float r = __fsub_rn(1.0f, fabsf(__fsub_rn(p, i)));
  return r < 0.0f ? 0.0f : r;
}

// dcorr's channels t < T into the scratch [BC, T, H*W]. One warp owns one
// (bc, t) plane, so no other thread writes it. Per corner (i, j) in the
// plain version's order (1,1), (1,2), (2,1), (2,2), and per chunk of 32
// anchors in ascending order, each lane forms its anchor's term hy_i *
// (gd * hx_j) (0 unless both weights are non-zero) and its cell; the lanes
// that share a cell add their terms one round each, in lane order, and the
// lanes of distinct cells in the same round. So each cell adds its terms one
// at a time in the plain version's order. A zero term is not added: the
// sum starts at +0 and is never -0, so adding a zero would change nothing.
// The kernel is bound by its instructions per term, and most of them went
// to finding the lanes that share a cell. Where they do at all, those lanes
// are mostly neighbours (anchors clipped to one border cell, neighbouring
// anchors at near-identity px/py): so each run of equal cells in lane order
// is taken as a group, and a byte tag per cell in shared memory (each run's
// first lane writes its lane number to its cell's tag and reads it back)
// shows whether two runs share a cell. Only then are the groups found with
// one ballot per bit of the cells' span. (__match_any_sync on every chunk,
// or a ballot per bit of the cell index, took 0.38-0.45 ms at the training
// shape on an H100.) px, py and g_sum are loaded kDcorrDepth chunks at a
// time, the next group's while the current group's adds run.
// The lanes of one chunk that add into one cell, in lane order: `rank` is
// this lane's place among them. `tag` (a byte per cell, or null) tests
// whether the runs of equal cells in lane order are the groups.
__device__ __forceinline__ int rank_in_cell(int cell, int lane, unsigned below,
                                            unsigned char* tag) {
  const int before = __shfl_up_sync(kFull, cell, 1);  // every lane shuffles
  const bool head = lane == 0 || cell != before;
  bool runs = false;
  if (tag != nullptr) {
    if (head && cell >= 0) tag[cell] = static_cast<unsigned char>(lane);
    __syncwarp();
    runs = !__any_sync(kFull, head && cell >= 0 && tag[cell] != lane);
  }
  if (runs) {  // the lanes of a cell are one run: the rank is the place in it
    const unsigned heads = __ballot_sync(kFull, head) & (below | (1u << lane));
    return lane - (31 - __clz(static_cast<int>(heads)));
  }
  // else the lanes with a term whose cell agrees in every bit of the span
  const int lo = __reduce_min_sync(kFull, cell >= 0 ? cell : INT_MAX);
  const unsigned key = cell >= 0 ? static_cast<unsigned>(cell - lo) : 0u;
  const int bits = 32 - __clz(static_cast<int>(__reduce_max_sync(kFull, key)));
  unsigned same = __ballot_sync(kFull, cell >= 0);
  for (int b = 0; b < bits; ++b) {
    const bool bit = (key >> b) & 1u;
    const unsigned ones = __ballot_sync(kFull, bit);
    same &= bit ? ones : ~ones;
  }
  return cell >= 0 ? __popc(same & below) : 0;
}

__global__ void __launch_bounds__(kDcorrWarps * 32)
resample_backward_dcorr_kernel(const DcorrArgs args) {
  // where args.shared: [warps][H*W] accumulators, then [warps][H*W] byte tags
  extern __shared__ float planes[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t plane = static_cast<int64_t>(blockIdx.x) * args.warps + warp;
  if (plane >= args.plane_count) return;  // no block barrier follows
  const int w = args.w, a_count = args.h * w;
  const int64_t bc = plane / args.t_count;
  const int t = static_cast<int>(plane - bc * args.t_count);
  const float wf = static_cast<float>(w), hf = static_cast<float>(args.h);
  float* out = args.scratch + plane * a_count;
  float* acc = out;
  unsigned char* tag = nullptr;
  if (args.shared) {
    acc = planes + static_cast<int64_t>(warp) * a_count;
    tag = reinterpret_cast<unsigned char*>(planes + static_cast<int64_t>(args.warps) * a_count) +
          static_cast<int64_t>(warp) * a_count;
  }
  for (int i = lane; i < a_count; i += 32) acc[i] = 0.0f;
  __syncwarp();
  const float* px = args.px + plane * a_count;
  const float* py = args.py + plane * a_count;
  const float* g_sum = args.g_sum + bc * a_count;
  const float m = __ldg(args.mask + (bc % args.num_classes) * args.t_count + t);
  const unsigned below = (1u << lane) - 1u;
  constexpr int kGroup = 32 * kDcorrDepth;
  for (int k = 0; k < 4; ++k) {
    const int ki = 1 + (k >> 1), kj = 1 + (k & 1);
    // px, py and g_sum of kDcorrDepth chunks loaded together, the next
    // group's in flight while the current group's adds run
    float nx[kDcorrDepth], ny[kDcorrDepth], ng[kDcorrDepth];
#pragma unroll
    for (int j = 0; j < kDcorrDepth; ++j) {
      const int a = 32 * j + lane;
      nx[j] = a < a_count ? __ldg(px + a) : 0.0f;
      ny[j] = a < a_count ? __ldg(py + a) : 0.0f;
      ng[j] = a < a_count ? __ldg(g_sum + a) : 0.0f;
    }
    for (int g0 = 0; g0 < a_count; g0 += kGroup) {
      float x[kDcorrDepth], y[kDcorrDepth], gs[kDcorrDepth];
#pragma unroll
      for (int j = 0; j < kDcorrDepth; ++j) {
        x[j] = nx[j];
        y[j] = ny[j];
        gs[j] = ng[j];
        const int a = g0 + kGroup + 32 * j + lane;
        nx[j] = a < a_count ? __ldg(px + a) : 0.0f;
        ny[j] = a < a_count ? __ldg(py + a) : 0.0f;
        ng[j] = a < a_count ? __ldg(g_sum + a) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kDcorrDepth; ++j) {
        const int a0 = g0 + 32 * j;
        if (a0 >= a_count) break;  // uniform over the warp
        float v = 0.0f;
        int cell = -1 - lane;  // a lane with no term is a group of its own
        if (a0 + lane < a_count) {
          float xi, yi;
          const float hx = plain_weight(x[j], kj, wf, xi);
          const float hy = plain_weight(y[j], ki, hf, yi);
          if (hx != 0.0f && hy != 0.0f) {
            v = __fmul_rn(hy, __fmul_rn(__fmul_rn(gs[j], m), hx));
            if (v != 0.0f) cell = static_cast<int>(yi) * w + static_cast<int>(xi);
          }
        }
        const int rank = rank_in_cell(cell, lane, below, tag);
        const int rounds =
            static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(rank))) + 1;
        for (int r = 0; r < rounds; ++r) {
          if (rank == r && cell >= 0) acc[cell] = __fadd_rn(acc[cell], v);
          __syncwarp();
        }
      }
    }
  }
  if (args.shared)
    for (int i = lane; i < a_count; i += 32) out[i] = acc[i];
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

// Enqueues on `stream` the scatter kernel, the dcorr kernel and the
// transpose kernel, and returns the first CUDA error code (0 on success).
// The caller has checked shapes, strides and devices: g and g_sum are
// [B*C, H*W], corr and dcorr [B*C, H, W, t_full] contiguous, px/py/dpx/dpy
// [B*C, T, H*W], mask [C, T], scratch [B*C, T, H*W] (any contents; every
// value is written). It refuses a plane of more than 2^31 - 1 floats, and a
// T whose transpose tile exceeds the 227 KB of shared memory a block may
// have (T > 1760).
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
  // the dcorr kernel's accumulators and tags: in shared memory where one
  // plane's fit in kDcorrSharedBytes (as many planes a block as fit, up to
  // kDcorrWarps), else the accumulators in the scratch planes and no tags,
  // kDcorrWarps a block
  const size_t plane_bytes = (sizeof(float) + 1) * static_cast<size_t>(a_count);
  const bool shared = plane_bytes <= kDcorrSharedBytes;
  const int dcorr_warps =
      shared ? static_cast<int>(std::min<size_t>(kDcorrWarps, kDcorrSharedBytes / plane_bytes))
             : kDcorrWarps;
  const size_t dcorr_bytes = shared ? plane_bytes * dcorr_warps : 0;
  const int64_t plane_count = static_cast<int64_t>(bc_count) * t_count;
  const int64_t dcorr_blocks = (plane_count + dcorr_warps - 1) / dcorr_warps;
  // the kernels index within one plane in 32 bits
  const int64_t plane_size =
      static_cast<int64_t>(a_count) * (t_full > t_count ? t_full : int64_t{t_count});
  if (blocks < 1 || blocks > INT_MAX || transpose_blocks > INT_MAX || dcorr_blocks > INT_MAX ||
      plane_size > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const BackwardArgs args{g, corr, px, py, mask, dpx, dpy, num_classes, h, w, t_count,
                          static_cast<int>(t_full), tiles_x, tiles_y};
  resample_backward_scatter_kernel<<<static_cast<unsigned>(blocks), os2d::kThreads, 0, s>>>(
      args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dcorr_bytes > 48 * 1024) {  // above the default limit of dynamic shared memory
    err = cudaFuncSetAttribute(resample_backward_dcorr_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dcorr_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const DcorrArgs dargs{g_sum, px, py, mask, scratch, plane_count, num_classes, h, w, t_count,
                        dcorr_warps, shared};
  resample_backward_dcorr_kernel<<<static_cast<unsigned>(dcorr_blocks), dcorr_warps * 32,
                                   dcorr_bytes, s>>>(dargs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t tile_bytes = sizeof(float) * (kTransposeTile + 1) * static_cast<size_t>(t_count);
  if (tile_bytes > 48 * 1024) {
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
