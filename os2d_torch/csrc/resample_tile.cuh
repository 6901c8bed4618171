// Shared skeleton of the two correlation-resample kernels: resample.cu (the
// fp32 gather, tiers "high"/"highest") and hat_resample.cu (the bf16 hat
// form, tier "default"). Both compute, per (b, c, anchor),
//
//   out[bc, a] = sum_t term(corr[bc, :, :, t], px[bc, t, a], py[bc, t, a], mask[c, t])
//
// over the head's t-major contract (corr [B*C, H, W, T_full] with a row
// stride of t_full floats, only t < T read; px/py [B*C, T, H*W]; mask
// [C, T]), t in order. A Form supplies the term: how the two rows and two
// columns around (px, py) are indexed, weighted and rounded. The two kernels
// differ in nothing else.
//
// Bound on an H100: bytes. Each sample needs one 4-byte corr value and its
// 4-byte px and py, and each anchor writes one float: about 0.17 ms at
// 3.35 TB/s for the largest bench level (B=2, C=16, fm 96x128, T=121). The
// arithmetic, 20-28 fp32 flop per sample, takes about 0.02 ms on the CUDA
// cores (67 TFLOP/s), so the tensor cores buy nothing here.
//
// What costs the time is the corr read. A corner value is 4 bytes at a row
// stride of 225 floats, so each read fetches a 32-byte sector, and the
// sector that holds channels t..t+7 of one cell is what the anchors of one
// column in up to 8 consecutive rows need (consecutive t walk down a
// template column, os2d_torch/models/head.py:58-69). The design puts those
// anchors on one SM, where L1 serves the sector again:
// - a block owns a 2-D tile of anchors, kTileRows rows (one warp each) by
//   kTileCols consecutive columns (one warp-width), so one block holds the 8
//   rows that share a sector (the first designs' blocks held 256 consecutive
//   anchors, two feature-map rows);
// - a thread walks t in chunks of kChunk template points: it loads the
//   chunk's px, py (coalesced: the anchor is the minor index) and mask
//   values first, then its corners, so many loads are in flight;
// - a warp is one tile row at one t, and where px/py are near the identity
//   transform a lane's right-hand corners are its right neighbour's
//   left-hand ones: the lane takes them with a shuffle when the neighbour's
//   addresses match its own, and loads them itself only where they do not
//   (a predicated load), so a warp reads about two sectors per sample;
// - no shared memory and no barrier. Staging each chunk's window of corr
//   cells in shared memory (block min/max of the tile's floor(px), floor(py),
//   4-byte cp.async, gathers from shared memory) was built and measured
//   slower on an H100: 0.43 against 0.32 ms for the gather at the largest
//   bench level, on near-identity px/py. The window reduction, two barriers
//   per chunk and the copies cost more than the L1 misses they save.
// The grid is 1-D over (bc, tile), so B*C is not limited to gridDim.y, and
// no map size is limited.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace os2d {

constexpr int kTileCols = 32;  // anchors per tile row: one warp, consecutive x
constexpr int kTileRows = 8;   // tile rows: one warp each
constexpr int kThreads = kTileCols * kTileRows;
constexpr int kChunk = 8;      // template points whose loads a thread issues together

struct ResampleArgs {
  const float* corr;  // [BC, H, W, t_full]
  const float* px;    // [BC, T, H*W]
  const float* py;    // [BC, T, H*W]
  const float* mask;  // [C, T]
  float* out;         // [BC, H*W]
  int num_classes, h, w, t_count;
  int64_t t_full;
  int tiles_x, tiles_y;
};

// *p where pred holds, else `other`: a predicated load, so that the lanes
// that do not need the value issue no memory request
__device__ __forceinline__ float load_if(bool pred, const float* p, float other) {
  float v = other;
  asm(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q ld.global.nc.f32 %0, [%1];\n}\n"
      : "+f"(v)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

template <class Form>
__global__ void __launch_bounds__(kThreads)
resample_tile_kernel(const ResampleArgs args) {
  const int h = args.h, w = args.w, t_count = args.t_count;
  const int64_t t_full = args.t_full;
  const int tiles = args.tiles_x * args.tiles_y;
  const int bc = blockIdx.x / tiles;
  const int tile = blockIdx.x - bc * tiles;
  const int tile_y = tile / args.tiles_x;
  const int tile_x = tile - tile_y * args.tiles_x;
  const int lane = threadIdx.x & 31;
  const int ax = tile_x * kTileCols + lane;
  const int ay = tile_y * kTileRows + (threadIdx.x >> 5);
  // lanes past the map stay to the end (they take part in the shuffles) but
  // load no coordinates and store nothing
  const bool valid = ax < w && ay < h;
  const int a_count = h * w;
  const int a = valid ? ay * w + ax : 0;

  const float* plane = args.corr + static_cast<int64_t>(bc) * a_count * t_full;
  const int64_t coord_base = static_cast<int64_t>(bc) * t_count * a_count + a;
  const float* pxp = args.px + coord_base;
  const float* pyp = args.py + coord_base;
  const float* maskp = args.mask + static_cast<int64_t>(bc % args.num_classes) * t_count;

  float acc = 0.0f;
  for (int t0 = 0; t0 < t_count; t0 += kChunk) {
    const int n = min(kChunk, t_count - t0);
    float x[kChunk], y[kChunk], m[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int64_t off = static_cast<int64_t>(t0 + k) * a_count;
      x[k] = valid && k < n ? __ldg(pxp + off) : 0.0f;
      y[k] = valid && k < n ? __ldg(pyp + off) : 0.0f;
      m[k] = k < n ? __ldg(maskp + t0 + k) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < n) {  // uniform over the warp
        // the corners at floor and floor + 1, clamped to the map (the hat
        // form leaves out what lies outside; its clamped reads are unused)
        const int x0 = static_cast<int>(floorf(x[k]));
        const int y0 = static_cast<int>(floorf(y[k]));
        const int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
        const int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
        const int i00 = ya * w + xa, i10 = yb * w + xa;
        const int i01 = ya * w + xb, i11 = yb * w + xb;
        const float* g = plane + t0 + k;
        const float v00 = __ldg(g + static_cast<int64_t>(i00) * t_full);
        const float v10 = __ldg(g + static_cast<int64_t>(i10) * t_full);
        // the right-hand corners: where the next lane read the same cell as
        // its left-hand corner (neighbouring anchors at near-identity px/py),
        // take its value instead of a second 32-byte sector
        const int n00 = __shfl_down_sync(0xffffffffu, i00, 1);
        const int n10 = __shfl_down_sync(0xffffffffu, i10, 1);
        const float u00 = __shfl_down_sync(0xffffffffu, v00, 1);
        const float u10 = __shfl_down_sync(0xffffffffu, v10, 1);
        const bool got01 = lane < 31 && n00 == i01;
        const bool got11 = lane < 31 && n10 == i11;
        const float v01 = load_if(!got01, g + static_cast<int64_t>(i01) * t_full, u00);
        const float v11 = load_if(!got11, g + static_cast<int64_t>(i11) * t_full, u10);
        acc = Form::accumulate(acc, x[k], y[k], m[k], h, w, v00, v01, v10, v11);
      }
    }
  }
  if (valid) args.out[static_cast<int64_t>(bc) * a_count + a] = acc;
}

// Launches on `stream` and returns a CUDA error code (0 on success).
template <class Form>
int launch_resample(const float* corr, const float* px, const float* py, const float* mask,
                    float* out, int bc_count, int num_classes, int h, int w, int t_count,
                    int64_t t_full, cudaStream_t stream) {
  const int tiles_x = (w + kTileCols - 1) / kTileCols;
  const int tiles_y = (h + kTileRows - 1) / kTileRows;
  const int64_t blocks = static_cast<int64_t>(bc_count) * tiles_x * tiles_y;
  if (blocks < 1 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const ResampleArgs args{corr, px, py, mask, out, num_classes, h, w, t_count, t_full,
                          tiles_x, tiles_y};
  resample_tile_kernel<Form><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace os2d
