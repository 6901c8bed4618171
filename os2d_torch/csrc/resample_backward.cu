// Gradient of the correlation resample + masked pool, for training: the
// backward of both forward tiers (hat_resample.cu, "default", and
// resample.cu, "high"/"highest").
//
// The TPU package has no Pallas backward: its trainer differentiates the XLA
// hat-weight einsums of os2d_tpu/ops/sampling.py:
// resample_correlation_from_pxpy at every tier (the Pallas forwards
// os2d_tpu/ops/pallas_resample.py:_resample_kernel and
// os2d_tpu/ops/pallas_hat_resample.py:_hat_resample_kernel are eval-only).
// This kernel computes that gradient in the hat form with JAX's rules, fp32:
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
// exact ties (integer p), so up to 12 cells are read, 4 in the common case.
// g_sum is g plus the gradient of the head's cls_detached (the same resample
// with px/py detached), which reaches corr but not px/py.
//
// dcorr is a scatter: many anchors sample one cell. This first kernel adds
// with fp32 atomicAdd (so dcorr agrees with the plain version up to the order
// of its sums) into the full [BC, H, W, t_full] tensor, which the wrapper
// zero-fills; channels t >= T stay zero, as JAX's gradient through
// corr[..., :T] leaves them.
//
// Bound on an H100: bytes. It reads the corr prefix, px, py and g once and
// writes dpx, dpy and the touched dcorr cells once, after the zero-fill of
// all t_full channels: about 0.2 ms at 3.35 TB/s for the training shape
// (B=4, C=16, fm 38x38, T=121 of 225). The layout is the forward's
// (resample_tile.cuh): a block owns a 2-D tile of anchors, 8 rows of 32
// consecutive columns, so a warp's coordinate loads and dpx/dpy stores are
// coalesced and the rows that share a corr sector sit on one SM. Left for
// later: a deterministic dcorr without atomics, and fewer dcorr bytes than
// the zero-fill of all 225 channels.

#include "resample_tile.cuh"

namespace {

struct BackwardArgs {
  const float* g;      // [BC, H*W]
  const float* g_sum;  // [BC, H*W]
  const float* corr;   // [BC, H, W, t_full]
  const float* px;     // [BC, T, H*W]
  const float* py;     // [BC, T, H*W]
  const float* mask;   // [C, T]
  float* dcorr;        // [BC, H, W, t_full], zero-filled
  float* dpx;          // [BC, T, H*W]
  float* dpy;          // [BC, T, H*W]
  int num_classes, h, w, t_count;
  int64_t t_full;
  int tiles_x, tiles_y;
};

// the hat weights and JAX derivatives at indices floor(p) - 1 .. floor(p) + 2
// (zero outside [0, n)); returns floor(p) - 1
__device__ __forceinline__ int axis_terms(float p, int n, float wt[4], float der[4]) {
  const int base = static_cast<int>(floorf(p)) - 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = base + k;
    const float diff = __fsub_rn(p, static_cast<float>(i));
    const float ad = fabsf(diff);
    const float sign = diff >= 0.0f ? -1.0f : 1.0f;
    const bool inside = i >= 0 && i < n;
    wt[k] = inside ? fmaxf(0.0f, __fsub_rn(1.0f, ad)) : 0.0f;
    der[k] = inside ? (ad < 1.0f ? sign : (ad == 1.0f ? 0.5f * sign : 0.0f)) : 0.0f;
  }
  return base;
}

__global__ void __launch_bounds__(os2d::kThreads)
resample_backward_kernel(const BackwardArgs args) {
  const int h = args.h, w = args.w, t_count = args.t_count;
  const int64_t t_full = args.t_full;
  const int tiles = args.tiles_x * args.tiles_y;
  const int bc = blockIdx.x / tiles;
  const int tile = blockIdx.x - bc * tiles;
  const int tile_y = tile / args.tiles_x;
  const int tile_x = tile - tile_y * args.tiles_x;
  const int ax = tile_x * os2d::kTileCols + (threadIdx.x & 31);
  const int ay = tile_y * os2d::kTileRows + (threadIdx.x >> 5);
  if (ax >= w || ay >= h) return;  // no shuffles below: a lane may leave
  const int a_count = h * w;
  const int a = ay * w + ax;

  const int64_t plane_off = static_cast<int64_t>(bc) * a_count * t_full;
  const float* plane = args.corr + plane_off;
  float* dplane = args.dcorr + plane_off;
  const int64_t coord_base = static_cast<int64_t>(bc) * t_count * a_count + a;
  const float* maskp = args.mask + static_cast<int64_t>(bc % args.num_classes) * t_count;
  const float g = args.g[static_cast<int64_t>(bc) * a_count + a];
  const float g_sum = args.g_sum[static_cast<int64_t>(bc) * a_count + a];

  for (int t = 0; t < t_count; ++t) {
    const int64_t off = coord_base + static_cast<int64_t>(t) * a_count;
    const float x = __ldg(args.px + off);
    const float y = __ldg(args.py + off);
    const float m = __ldg(maskp + t);
    const float go = __fmul_rn(g, m);
    const float gd = __fmul_rn(g_sum, m);
    float hx[4], dhx[4], hy[4], dhy[4];
    const int x_base = axis_terms(x, w, hx, dhx);
    const int y_base = axis_terms(y, h, hy, dhy);

    // v[i][j], read only where a product needs it (a non-zero weight or
    // derivative on both axes), so outside the map nothing is read
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool need = (hy[i] != 0.0f && (hx[j] != 0.0f || dhx[j] != 0.0f)) ||
                          (dhy[i] != 0.0f && hx[j] != 0.0f);
        const int64_t cell = static_cast<int64_t>(y_base + i) * w + (x_base + j);
        v[i][j] = os2d::load_if(need, plane + cell * t_full + t, 0.0f);
      }
    }

    float sx = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float r = __fadd_rn(__fmul_rn(hy[1], v[1][j]), __fmul_rn(hy[2], v[2][j]));
      sx = __fadd_rn(sx, __fmul_rn(dhx[j], __fmul_rn(go, r)));
    }
    const float gx1 = __fmul_rn(go, hx[1]), gx2 = __fmul_rn(go, hx[2]);
    float sy = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float q = __fadd_rn(__fmul_rn(gx1, v[i][1]), __fmul_rn(gx2, v[i][2]));
      sy = __fadd_rn(sy, __fmul_rn(dhy[i], q));
    }
    args.dpx[off] = sx;
    args.dpy[off] = sy;

#pragma unroll
    for (int i = 1; i <= 2; ++i) {
#pragma unroll
      for (int j = 1; j <= 2; ++j) {
        if (hy[i] != 0.0f && hx[j] != 0.0f) {
          const int64_t cell = static_cast<int64_t>(y_base + i) * w + (x_base + j);
          atomicAdd(dplane + cell * t_full + t, __fmul_rn(hy[i], __fmul_rn(gd, hx[j])));
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success). The
// caller has checked shapes, strides and devices and zero-filled dcorr; g and
// g_sum are [B*C, H*W], corr and dcorr [B*C, H, W, t_full] contiguous,
// px/py/dpx/dpy [B*C, T, H*W], mask [C, T].
extern "C" int os2d_resample_correlation_backward(
    const float* g, const float* g_sum, const float* corr, const float* px, const float* py,
    const float* mask, float* dcorr, float* dpx, float* dpy, int bc_count, int num_classes,
    int h, int w, int t_count, int64_t t_full, void* stream) {
  const int tiles_x = (w + os2d::kTileCols - 1) / os2d::kTileCols;
  const int tiles_y = (h + os2d::kTileRows - 1) / os2d::kTileRows;
  const int64_t blocks = static_cast<int64_t>(bc_count) * tiles_x * tiles_y;
  if (blocks < 1 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const BackwardArgs args{g, g_sum, corr, px, py, mask, dcorr, dpx, dpy,
                          num_classes, h, w, t_count, t_full, tiles_x, tiles_y};
  resample_backward_kernel<<<static_cast<unsigned>(blocks), os2d::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
