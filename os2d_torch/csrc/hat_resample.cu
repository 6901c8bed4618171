// Correlation-map resample + masked pool in the bf16 hat-weight form: the
// `resample_precision="default"` tier.
//
// Replaces the TPU kernel os2d_tpu/ops/pallas_hat_resample.py:
// _hat_resample_kernel (called through hat_resample_correlation_map_pallas),
// the one-pass bf16 matrix-unit form of the op that the gather kernel
// (resample.cu) computes in fp32:
//
//   out[bc, a] = sum_t sum_w (wy_t @ M_t)[a, w] * wx_t[a, w]
//   M_t[h, w]  = bf16(corr[bc, h, w, t] * mask[c, t])
//   wy_t[a, h] = bf16(max(0, 1 - |py[bc, t, a] - h|))
//   wx_t[a, w] = max(0, 1 - |px[bc, t, a] - w|)           (fp32, not rounded)
//
// A hat row has at most two non-zero weights, at y0 = floor(py) and y0 + 1
// (likewise x0, x0 + 1), and an index outside the map has no weight at all
// (the hat form drops it; it does not clamp like the gather). So per sample
//
//   r(x) = wy0 * M[y0, x] + wy1 * M[y0 + 1, x]      (each product exact in fp32)
//   term = r(x0) * wx0 + r(x0 + 1) * wx1,  acc += term, t in order,
//
// each product and sum rounded on its own, with the terms of an index
// outside the map left out. The plain version's matrix product adds only
// exact zeros besides these two terms, and a sum of two terms is the same in
// either order, so kernel and plain version (ops/sampling.py:
// hat_resample_reference) agree bit for bit.
//
// Bound on an H100: bytes, the gather's (corr prefix, px, py, out: about
// 0.17 ms at 3.35 TB/s at the largest bench level, B=2, C=16, fm 96x128,
// T=121); the banded form's 28 fp32 flop per sample take 0.02 ms on the
// CUDA cores, so the kernel uses no tensor cores. The first design ran the
// dense product wy_t @ M_t on mma.sync over all H rows (94 of every 96 hat
// weights zeros at H=96), staged every t-plane transposed between two
// barriers, and needed a bf16 [B*C, T, H, W] operand that the wrapper built
// first: 11.25 ms a launch there on an H100. This design is the gather
// kernel's (resample_tile.cuh: a 2-D anchor tile whose rows share each corr
// sector through L1, corners shared between neighbouring lanes), reads the
// fp32 prefix view as it is and forms each value M = bf16(corr * mask) from
// the fp32 corner it reads, so no operand tensor is written and no map
// size is limited.

#include <cuda_bf16.h>

#include "resample_tile.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float hat(float p, int i) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, static_cast<float>(i)))));
}

struct HatResample {
  // v00..v11: corr at rows floor(py), floor(py) + 1 and columns floor(px),
  // floor(px) + 1, read at indices clamped to the map; a term whose row or
  // column lies outside the map is left out, so a clamped read is unused
  static __device__ __forceinline__ float accumulate(float acc, float x, float y, float m,
                                                     int h, int w, float v00, float v01,
                                                     float v10, float v11) {
    const int x0 = static_cast<int>(floorf(x));
    const int y0 = static_cast<int>(floorf(y));
    const bool in_x0 = x0 >= 0 && x0 < w, in_x1 = x0 + 1 >= 0 && x0 + 1 < w;
    const bool in_y0 = y0 >= 0 && y0 < h, in_y1 = y0 + 1 >= 0 && y0 + 1 < h;
    const float wy0 = round_bf16(hat(y, y0));
    const float wy1 = round_bf16(hat(y, y0 + 1));
    // r(x) = wy0 * M[y0, x] + wy1 * M[y0 + 1, x], M = bf16(corr * mask)
    const auto r = [&](float top, float bottom) {
      const float p0 = in_y0 ? __fmul_rn(wy0, round_bf16(__fmul_rn(top, m))) : 0.0f;
      const float p1 = in_y1 ? __fmul_rn(wy1, round_bf16(__fmul_rn(bottom, m))) : 0.0f;
      return __fadd_rn(p0, p1);
    };
    const float s0 = in_x0 ? __fmul_rn(r(v00, v10), hat(x, x0)) : 0.0f;
    const float s1 = in_x1 ? __fmul_rn(r(v01, v11), hat(x, x0 + 1)) : 0.0f;
    return __fadd_rn(acc, __fadd_rn(s0, s1));
  }
};

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success). The
// caller has checked shapes, strides and devices; corr is the fp32 prefix
// view [B*C, H, W, t_full], px/py are [B*C, T, H*W], out is [B*C, H*W].
extern "C" int os2d_hat_resample_correlation(const float* corr, const float* px,
                                             const float* py, const float* mask, float* out,
                                             int bc_count, int num_classes, int h, int w,
                                             int t_count, int64_t t_full, void* stream) {
  return os2d::launch_resample<HatResample>(corr, px, py, mask, out, bc_count, num_classes,
                                            h, w, t_count, t_full,
                                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
