// Correlation-map resample + masked pool in fp32: the model's distinguishing
// op at the "high"/"highest" tiers.
//
// Replaces the TPU kernel os2d_tpu/ops/pallas_resample.py:_resample_kernel
// (called through resample_correlation_map_pallas). It computes the same
// function on the head's t-major contract (os2d_tpu/models/head.py:294-299):
//
//   out[b, c, a] = sum_t mask[c, t] * bilinear(corr[b, c, :, :, t], px, py)
//
// with px = px[b, c, t, a], py = py[b, c, t, a]; x0 = floor(px), wx = px - x0
// taken from the unclamped floor, the corner indices x0 and x0 + 1 clamped to
// [0, W - 1] (likewise for y), and the sum over t in fp32, t in order. Every
// product and sum is rounded on its own (no fused multiply-add) in the order
// of the plain version (ops/sampling.py), so the two agree bit for bit.
//
// corr is [B, C, H, W, T_full] with a row stride of t_full floats; the kernel
// reads only the prefix t < T (T = 121 interior template points of 225), so
// the caller never copies corr[..., :121].
//
// Bound on an H100: bytes, B*C*A*(3*T + 1)*4 of them (corr prefix, px, py,
// out), about 0.17 ms at 3.35 TB/s for the largest bench level (B=2, C=16,
// fm 96x128, T=121); the ~20 flop per sample take 0.014 ms on the fp32 CUDA
// cores, so the kernel uses no tensor cores. The first design (one thread
// per anchor, a block of 256 consecutive anchors, one t at a time) read each
// corner value at a row stride of 225 floats, a 32-byte sector per 4-byte
// value, and the 8 anchors that share a sector sat in different blocks:
// 0.60 ms a launch there on an H100. This design (resample_tile.cuh) gives a
// block a 2-D anchor tile whose rows share each sector through L1, issues a
// chunk of 8 template points' loads at a time, and takes a lane's
// right-hand corners from its neighbour where they are the same cells.

#include "resample_tile.cuh"

namespace {

struct GatherResample {
  // v00..v11: corr at (ya, xa), (ya, xb), (yb, xa), (yb, xb), the corner
  // indices clamped to the map
  static __device__ __forceinline__ float accumulate(float acc, float x, float y, float m,
                                                     int, int, float v00, float v01, float v10,
                                                     float v11) {
    const float wx = x - floorf(x);
    const float wy = y - floorf(y);
    const float ux = __fsub_rn(1.0f, wx);
    const float uy = __fsub_rn(1.0f, wy);
    float sampled = __fmul_rn(__fmul_rn(v00, ux), uy);
    sampled = __fadd_rn(sampled, __fmul_rn(__fmul_rn(v01, wx), uy));
    sampled = __fadd_rn(sampled, __fmul_rn(__fmul_rn(v10, ux), wy));
    sampled = __fadd_rn(sampled, __fmul_rn(__fmul_rn(v11, wx), wy));
    return __fadd_rn(acc, __fmul_rn(sampled, m));
  }
};

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success). The
// caller has checked shapes, strides and devices; px/py are [B*C, T, H*W],
// out is [B*C, H*W].
extern "C" int os2d_resample_correlation(const float* corr, const float* px, const float* py,
                                         const float* mask, float* out, int bc_count,
                                         int num_classes, int h, int w, int t_count,
                                         int64_t t_full, void* stream) {
  return os2d::launch_resample<GatherResample>(corr, px, py, mask, out, bc_count, num_classes,
                                               h, w, t_count, t_full,
                                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
