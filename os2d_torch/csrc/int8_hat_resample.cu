// Correlation-map resample + masked pool in the int8 hat-weight form: the
// `resample_precision="int8"` tier.
//
// Replaces the int8 branch of os2d_tpu/ops/sampling.py:
// resample_correlation_from_pxpy (lines 198-240), which JAX runs as two XLA
// einsums on the TPU's int8 matrix unit, not as a Pallas kernel:
//
//   q[h, w]    = clamp(round(corr[bc, h, w, t] * 127), -127, 127)      (int8)
//   wq_t[a, h] = round(max(0, 1 - |py[bc, t, a] - h|) * 127)           (int8)
//   r_t[a, w]  = sum_h wq_t[a, h] * q[h, w]                            (int32)
//   out[bc, a] = sum_t (sum_w (r_t[a, w] * K) * wx_t[a, w]) * mask[c, t]
//
// with K = fp32(1 / (127 * 127)) and wx_t[a, w] = max(0, 1 - |px - w|) in
// fp32. A hat row has at most two non-zero weights, at y0 = floor(py) and
// y0 + 1 (likewise x0, x0 + 1), and an index outside the map has none (the
// hat form drops it). So per sample, with the terms of an index outside the
// map left out:
//
//   q     = clamp(rintf(corr * 127), -127, 127)
//   r(x)  = wq0 * q[y0, x] + wq1 * q[y0 + 1, x]        (exact, in integers)
//   term  = (r(x0) * K) * wx0 + (r(x0 + 1) * K) * wx1
//   acc   = acc + term * mask[c, t],  t in order,
//
// each product and sum rounded on its own, with no contraction into an FMA.
// rintf rounds half to even, as torch.round and jnp.round do. The plain
// version (ops/sampling.py: int8_hat_resample_reference) forms the same
// values; its matrix product and its sum over w add only exact zeros besides
// these terms, so the two agree bit for bit. No int8 copy of corr is
// written: the kernel reads the fp32 prefix view and quantizes what it reads.
//
// Two sources of the sample coordinates, one kernel (a template parameter):
// - theta (the head's interior-first path, the main path): the inverted
//   affine theta [B*C, H*W, 6], the anchors' feature-map boxes [H*W, 4] and
//   the template lattice [2, n] (T = n * n, t = tx * n + ty). The kernel
//   forms px and py in registers with the roundings of the head's chain
//   (models/head.py, ops/sampling.py: interior_sample_coords) as the card
//   computes it: each product and sum on its own, and the division by
//   (n - 1) as ATen's CUDA division by a scalar does it, a multiply by
//   fp32(1 / fp32(n - 1)) (the CPU divides; the two may differ in the last
//   bit, and the kernel is held to its plain version on the card). No px/py
//   tensor is written or read.
// - px/py [B*C, T, H*W] (the grid path, corr_interior_first=False).
//
// Bound on an H100: bytes. The theta source reads the fp32 corr prefix,
// theta, the boxes and the mask once and writes out once: about 0.060 ms at
// 3.35 TB/s at the largest bench level (B=2, C=16, fm 96x128, T=121; the
// px/py source adds 381 MB there, 0.171 ms in all). Per sample the kernel
// does about 75 operations on the CUDA cores (0.05 ms at the fp32 rate), so
// it uses no tensor cores. What the design does about the time:
// - px/py live in registers: read from tensors, they are two thirds of the
//   px/py source's bytes, and the head builds those tensors in ~14
//   elementwise passes.
// - The tile is the gather kernel's (resample_tile.cuh): a block of 8 rows
//   by 32 consecutive columns of anchors, one row a warp, whose rows share
//   each 32-byte corr sector through L1. A lane loads and quantizes its
//   left-hand corners; its right-hand ones come, already quantized, from
//   the lane to its right where that lane's cells are the same (neighbouring
//   anchors at near-identity theta), else from a load. So most corr values
//   are loaded and quantized once per warp, not once per reader.
// What did not pay, measured on an H100 in turns with this kernel (PERF.md):
// a 16-column tile for widths that leave a 32-column one idle (slower at
// 40, 50 and 112 columns, 3% faster at 80), warps of 16x2 and 8x4 anchors
// whose bottom corners come from the lane below (up to 9% slower), chunks
// of 4 or 16 template points, and a shared-memory window of int8 values
// per chunk (the block's bounding box of its corners, each cell's 8
// channels read as one 32-byte run and quantized once per block, two block
// barriers a chunk: 2.5x slower). The kernel is bound by its corr sectors,
// not by px/py: reading px/py from tensors instead of forming them takes
// about as long.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "resample_tile.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// template points whose coordinates and corners a thread issues together
constexpr int kChunk = 8;
constexpr int kMaxSide = 32;  // the template lattice's side, at most (the model's interior: 11)
constexpr float kRowScale = static_cast<float>(1.0 / (127.0 * 127.0));

struct Args {
  const float* corr;     // [BC, H, W, t_full], channels t < T read
  const float* px;       // [BC, T, H*W] (px/py source)
  const float* py;
  const float* theta;    // [BC, H*W, 6] (theta source)
  const float* boxes;    // [H*W, 4] feature-map boxes x0, y0, x1, y1
  const float* lattice;  // [2, side]: template abscissae, then ordinates
  const float* mask;     // [C, T]
  float* out;            // [BC, H*W]
  int num_classes, h, w, t_count, side;
  int64_t t_full;
  float inv_w1, inv_h1;  // fp32(1 / fp32(W - 1)), fp32(1 / fp32(H - 1))
  int tiles_x, tiles_y;
};

__device__ __forceinline__ float hat(float p, int i) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, static_cast<float>(i)))));
}

// clamp(round(v * 127), -127, 127) as an integer
__device__ __forceinline__ int quantize(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, 127.0f)), -127.0f), 127.0f));
}

// the head's clip of a normalized coordinate to [-1, 1]; a NaN stays NaN,
// as torch.maximum / torch.minimum keep it
__device__ __forceinline__ float clip_unit(float g) {
  return g != g ? g : fminf(fmaxf(g, -1.0f), 1.0f);
}

// px (or py) of a box-local coordinate l, as the head's chain forms it on
// the card: ((((l * half) + center) * inv) * 2 - 1) clipped, then
// ((g + 1) * 0.5) * (n - 1)
__device__ __forceinline__ float to_map(float l, float half, float center, float inv,
                                        float nm1) {
  const float v = __fadd_rn(__fmul_rn(l, half), center);
  const float g = clip_unit(__fsub_rn(__fmul_rn(__fmul_rn(v, inv), 2.0f), 1.0f));
  return __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), nm1);
}

template <bool kTheta>
__global__ void __launch_bounds__(os2d::kThreads) int8_resample_kernel(const Args args) {
  __shared__ float lattice[2][kMaxSide];
  if constexpr (kTheta) {
    if (threadIdx.x < 2 * args.side)
      lattice[threadIdx.x / args.side][threadIdx.x % args.side] = __ldg(args.lattice + threadIdx.x);
    __syncthreads();
  }
  const int h = args.h, w = args.w, t_count = args.t_count;
  const int64_t t_full = args.t_full;
  const int tiles = args.tiles_x * args.tiles_y;
  const int bc = blockIdx.x / tiles;
  const int tile = blockIdx.x - bc * tiles;
  const int tile_y = tile / args.tiles_x;
  const int tile_x = tile - tile_y * args.tiles_x;
  const int lane = threadIdx.x & 31;
  const int ax = tile_x * os2d::kTileCols + lane;
  const int ay = tile_y * os2d::kTileRows + (threadIdx.x >> 5);
  // lanes past the map stay to the end (they take part in the shuffles) but
  // store nothing; they sample the map at anchor 0's theta
  const bool valid = ax < w && ay < h;
  const int a_count = h * w;
  const int a = valid ? ay * w + ax : 0;

  const float* plane = args.corr + static_cast<int64_t>(bc) * a_count * t_full;
  const float* maskp = args.mask + static_cast<int64_t>(bc % args.num_classes) * t_count;
  const int64_t coord_base = static_cast<int64_t>(bc) * t_count * a_count + a;
  float th[6] = {}, x_half = 0.0f, x_center = 0.0f, y_half = 0.0f, y_center = 0.0f;
  if constexpr (kTheta) {
    const float* tp = args.theta + (static_cast<int64_t>(bc) * a_count + a) * 6;
#pragma unroll
    for (int i = 0; i < 6; ++i) th[i] = __ldg(tp + i);
    const float* fb = args.boxes + static_cast<int64_t>(a) * 4;
    const float bx0 = __ldg(fb), by0 = __ldg(fb + 1), bx1 = __ldg(fb + 2), by1 = __ldg(fb + 3);
    x_half = __fmul_rn(__fsub_rn(bx1, bx0), 0.5f);
    x_center = __fmul_rn(__fadd_rn(bx1, bx0), 0.5f);
    y_half = __fmul_rn(__fsub_rn(by1, by0), 0.5f);
    y_center = __fmul_rn(__fadd_rn(by1, by0), 0.5f);
  }
  const float wm1 = static_cast<float>(w - 1), hm1 = static_cast<float>(h - 1);

  float acc = 0.0f;
  int tx0 = 0, ty0 = 0;  // the lattice point of t0 (theta source)
  for (int t0 = 0; t0 < t_count; t0 += kChunk) {
    const int n = min(kChunk, t_count - t0);
    float x[kChunk], y[kChunk], m[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      m[k] = k < n ? __ldg(maskp + t0 + k) : 0.0f;
      if constexpr (kTheta) {
        int tx = tx0, ty = ty0 + k;
        while (ty >= args.side) {
          ty -= args.side;
          ++tx;
        }
        tx = min(tx, args.side - 1);  // past T in the last chunk: unused
        const float ux = lattice[0][tx], uy = lattice[1][ty];
        const float l_x = __fadd_rn(__fadd_rn(__fmul_rn(th[0], ux), __fmul_rn(th[1], uy)), th[2]);
        const float l_y = __fadd_rn(__fadd_rn(__fmul_rn(th[3], ux), __fmul_rn(th[4], uy)), th[5]);
        x[k] = to_map(l_x, x_half, x_center, args.inv_w1, wm1);
        y[k] = to_map(l_y, y_half, y_center, args.inv_h1, hm1);
      } else {
        const int64_t off = coord_base + static_cast<int64_t>(t0 + k) * a_count;
        x[k] = valid && k < n ? __ldg(args.px + off) : 0.0f;
        y[k] = valid && k < n ? __ldg(args.py + off) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < n) {  // uniform over the warp
        // the corners at floor and floor + 1, clamped to the map (a term
        // whose row or column lies outside is left out; its clamped read is
        // unused)
        const int x0 = static_cast<int>(floorf(x[k]));
        const int y0 = static_cast<int>(floorf(y[k]));
        const int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
        const int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
        const int i00 = ya * w + xa, i01 = ya * w + xb;
        const int i10 = yb * w + xa, i11 = yb * w + xb;
        const float* g = plane + t0 + k;
        // the left-hand corners loaded and quantized; the right-hand ones
        // from the next lane where its left-hand cells are this lane's
        // right-hand ones (every lane takes part in every shuffle)
        const int q00 = quantize(__ldg(g + static_cast<int64_t>(i00) * t_full));
        const int q10 = quantize(__ldg(g + static_cast<int64_t>(i10) * t_full));
        const int right_i00 = __shfl_down_sync(kFull, i00, 1);
        const int right_i10 = __shfl_down_sync(kFull, i10, 1);
        const int right_q00 = __shfl_down_sync(kFull, q00, 1);
        const int right_q10 = __shfl_down_sync(kFull, q10, 1);
        const bool got01 = lane < 31 && right_i00 == i01;
        const bool got11 = lane < 31 && right_i10 == i11;
        const float v01 = os2d::load_if(!got01, g + static_cast<int64_t>(i01) * t_full, 0.0f);
        const float v11 = os2d::load_if(!got11, g + static_cast<int64_t>(i11) * t_full, 0.0f);
        const int q01 = got01 ? right_q00 : quantize(v01);
        const int q11 = got11 ? right_q10 : quantize(v11);

        const bool in_x0 = x0 >= 0 && x0 < w, in_x1 = x0 + 1 >= 0 && x0 + 1 < w;
        const bool in_y0 = y0 >= 0 && y0 < h, in_y1 = y0 + 1 >= 0 && y0 + 1 < h;
        const int wq0 = in_y0 ? static_cast<int>(rintf(__fmul_rn(hat(y[k], y0), 127.0f))) : 0;
        const int wq1 = in_y1 ? static_cast<int>(rintf(__fmul_rn(hat(y[k], y0 + 1), 127.0f))) : 0;
        // r(x) * K, r(x) = wq0 * q[y0, x] + wq1 * q[y0 + 1, x] (|r| <= 2 * 127 * 127)
        const float r0 = __fmul_rn(static_cast<float>(wq0 * q00 + wq1 * q10), kRowScale);
        const float r1 = __fmul_rn(static_cast<float>(wq0 * q01 + wq1 * q11), kRowScale);
        const float s0 = in_x0 ? __fmul_rn(r0, hat(x[k], x0)) : 0.0f;
        const float s1 = in_x1 ? __fmul_rn(r1, hat(x[k], x0 + 1)) : 0.0f;
        acc = __fadd_rn(acc, __fmul_rn(__fadd_rn(s0, s1), m[k]));
      }
    }
    if constexpr (kTheta) {
      ty0 += kChunk;
      while (ty0 >= args.side) {
        ty0 -= args.side;
        ++tx0;
      }
    }
  }
  if (valid) args.out[static_cast<int64_t>(bc) * a_count + a] = acc;
}

template <bool kTheta>
int launch(Args args, int bc_count, cudaStream_t stream) {
  args.tiles_x = (args.w + os2d::kTileCols - 1) / os2d::kTileCols;
  args.tiles_y = (args.h + os2d::kTileRows - 1) / os2d::kTileRows;
  const int64_t blocks = static_cast<int64_t>(bc_count) * args.tiles_x * args.tiles_y;
  if (blocks < 1 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int8_resample_kernel<kTheta><<<static_cast<unsigned>(blocks), os2d::kThreads, 0, stream>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success). The
// caller has checked shapes, strides and devices; corr is the fp32 prefix
// view [B*C, H, W, t_full] and out is [B*C, H*W]. The coordinates come from
// theta [B*C, H*W, 6], boxes [H*W, 4] and lattice [2, side] (T = side *
// side, side <= 32) where theta is not null, else from px/py [B*C, T, H*W];
// inv_w1 and inv_h1 are fp32(1 / fp32(W - 1)) and fp32(1 / fp32(H - 1))
// (theta source only).
extern "C" int os2d_int8_hat_resample_correlation(
    const float* corr, const float* px, const float* py, const float* theta, const float* boxes,
    const float* lattice, const float* mask, float* out, int bc_count, int num_classes, int h,
    int w, int t_count, int side, int64_t t_full, float inv_w1, float inv_h1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (theta != nullptr && (side < 1 || side > kMaxSide || side * side != t_count))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{corr, px, py, theta, boxes, lattice, mask, out, num_classes, h, w, t_count,
                  side, t_full, inv_w1, inv_h1, 0, 0};
  return theta != nullptr ? launch<true>(args, bc_count, s) : launch<false>(args, bc_count, s);
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
