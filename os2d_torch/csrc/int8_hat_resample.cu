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
//   q     = clamp(rintf(corr * 127), -127, 127), each corner as it is loaded
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
// Bound on an H100: bytes, the hat kernel's (the fp32 corr prefix, px, py,
// out: about 0.17 ms at 3.35 TB/s at the largest bench level, B=2, C=16,
// fm 96x128, T=121). The TPU's int8 matrix rate has no counterpart in a
// banded kernel: per sample it is about 30 operations on the CUDA cores,
// 0.02 ms in all, so the kernel uses no tensor cores. It is a third Form on
// the skeleton of the other two (resample_tile.cuh: a 2-D anchor tile whose
// rows share each corr sector through L1, corners shared between
// neighbouring lanes), and is laid out like HatResample in hat_resample.cu.

#include "resample_tile.cuh"

namespace {

constexpr float kRowScale = static_cast<float>(1.0 / (127.0 * 127.0));

__device__ __forceinline__ float hat(float p, int i) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, static_cast<float>(i)))));
}

// clamp(round(v * 127), -127, 127) as an integer
__device__ __forceinline__ int quantize(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, 127.0f)), -127.0f), 127.0f));
}

struct Int8HatResample {
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
    const int wq0 = in_y0 ? static_cast<int>(rintf(__fmul_rn(hat(y, y0), 127.0f))) : 0;
    const int wq1 = in_y1 ? static_cast<int>(rintf(__fmul_rn(hat(y, y0 + 1), 127.0f))) : 0;
    // r(x) * K, r(x) = wq0 * q[y0, x] + wq1 * q[y0 + 1, x] (|r| <= 2 * 127 * 127)
    const auto rf = [&](float top, float bottom) {
      const int r = wq0 * quantize(top) + wq1 * quantize(bottom);
      return __fmul_rn(static_cast<float>(r), kRowScale);
    };
    const float s0 = in_x0 ? __fmul_rn(rf(v00, v10), hat(x, x0)) : 0.0f;
    const float s1 = in_x1 ? __fmul_rn(rf(v01, v11), hat(x, x0 + 1)) : 0.0f;
    return __fadd_rn(acc, __fmul_rn(__fadd_rn(s0, s1), m));
  }
};

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success). The
// caller has checked shapes, strides and devices; corr is the fp32 prefix
// view [B*C, H, W, t_full], px/py are [B*C, T, H*W], out is [B*C, H*W].
extern "C" int os2d_int8_hat_resample_correlation(const float* corr, const float* px,
                                                  const float* py, const float* mask,
                                                  float* out, int bc_count, int num_classes,
                                                  int h, int w, int t_count, int64_t t_full,
                                                  void* stream) {
  return os2d::launch_resample<Int8HatResample>(corr, px, py, mask, out, bc_count,
                                                num_classes, h, w, t_count, t_full,
                                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
