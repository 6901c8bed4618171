// Correlation-map resample + masked pool: the model's distinguishing op.
//
// Replaces the TPU kernel os2d_tpu/ops/pallas_resample.py:_resample_kernel
// (called through resample_correlation_map_pallas). It computes the same
// function on the head's t-major contract (os2d_tpu/models/head.py:294-299):
//
//   out[b, c, a] = sum_t mask[c, t] * bilinear(corr[b, c, :, :, t], px, py)
//
// with px = px[b, c, t, a], py = py[b, c, t, a]; x0 = floor(px), wx = px - x0
// taken from the unclamped floor, the corner indices x0 and x0 + 1 clamped to
// [0, W - 1] (likewise for y), and the sum over t in fp32.
//
// corr is [B, C, H, W, T_full] with a row stride of t_full floats; the kernel
// reads only the prefix t < T (T = 121 interior template points of 225), so
// the caller never copies corr[..., :121].
//
// Bound on an H100: bytes. Each (b, c, anchor) needs its T corr values, its
// T px and T py coordinates and one output: B*C*A*(3*T + 1)*4 bytes, about
// 0.17 ms at 3.35 TB/s for the largest bench level (B=2, C=16, fm 96x128,
// T=121). The arithmetic (about 20 flops per sample) is far below the fp32
// peak.
//
// First design: grid (ceil(A / 256), B*C), one thread per anchor looping
// over the T template points. px/py loads are coalesced (anchor is the minor
// index); the class's T mask weights go to shared memory once per block; the
// four corner gathers read corr at stride t_full, and one (b, c) plane is at
// most ~11 MB at the bench shapes, so the gathers hit L2. One fp32 register
// accumulates and each thread stores once. Left for later: the gathers fetch
// a 32-byte sector for each 4-byte value, and px/py (two thirds of the bytes)
// could be computed from theta inside the kernel instead of being read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resample_correlation_kernel(const float* __restrict__ corr,
                            const float* __restrict__ px,
                            const float* __restrict__ py,
                            const float* __restrict__ mask,
                            float* __restrict__ out,
                            int num_classes, int h, int w, int t_count,
                            int64_t t_full) {
  extern __shared__ float s_mask[];
  const int bc = blockIdx.y;
  const int c = bc % num_classes;
  const int a_count = h * w;
  for (int i = threadIdx.x; i < t_count; i += blockDim.x) {
    s_mask[i] = mask[static_cast<int64_t>(c) * t_count + i];
  }
  __syncthreads();

  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= a_count) return;

  const float* plane = corr + static_cast<int64_t>(bc) * a_count * t_full;
  const int64_t coord_base = static_cast<int64_t>(bc) * t_count * a_count + a;
  const float* pxp = px + coord_base;
  const float* pyp = py + coord_base;

  float acc = 0.0f;
  for (int t = 0; t < t_count; ++t) {
    const float x = __ldg(pxp + static_cast<int64_t>(t) * a_count);
    const float y = __ldg(pyp + static_cast<int64_t>(t) * a_count);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float wx = x - x0;
    const float wy = y - y0;
    const int x0i = static_cast<int>(x0);
    const int y0i = static_cast<int>(y0);
    const int xa = min(max(x0i, 0), w - 1);
    const int xb = min(max(x0i + 1, 0), w - 1);
    const int ya = min(max(y0i, 0), h - 1);
    const int yb = min(max(y0i + 1, 0), h - 1);
    const float* col = plane + t;
    const float v00 = __ldg(col + static_cast<int64_t>(ya * w + xa) * t_full);
    const float v01 = __ldg(col + static_cast<int64_t>(ya * w + xb) * t_full);
    const float v10 = __ldg(col + static_cast<int64_t>(yb * w + xa) * t_full);
    const float v11 = __ldg(col + static_cast<int64_t>(yb * w + xb) * t_full);
    // every product and sum rounded on its own (no fused multiply-add), in
    // the order of the plain version, so the two agree bit for bit
    const float ux = __fsub_rn(1.0f, wx);
    const float uy = __fsub_rn(1.0f, wy);
    float sampled = __fmul_rn(__fmul_rn(v00, ux), uy);
    sampled = __fadd_rn(sampled, __fmul_rn(__fmul_rn(v01, wx), uy));
    sampled = __fadd_rn(sampled, __fmul_rn(__fmul_rn(v10, ux), wy));
    sampled = __fadd_rn(sampled, __fmul_rn(__fmul_rn(v11, wx), wy));
    acc = __fadd_rn(acc, __fmul_rn(sampled, s_mask[t]));
  }
  out[static_cast<int64_t>(bc) * a_count + a] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller has checked shapes, strides and devices; out is [B, C, H*W].
extern "C" int os2d_resample_correlation(const float* corr, const float* px,
                                         const float* py, const float* mask,
                                         float* out, int batch, int num_classes,
                                         int h, int w, int t_count,
                                         int64_t t_full, void* stream) {
  const int a_count = h * w;
  const dim3 grid((a_count + kThreads - 1) / kThreads, batch * num_classes);
  const size_t smem = static_cast<size_t>(t_count) * sizeof(float);
  resample_correlation_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      corr, px, py, mask, out, num_classes, h, w, t_count, t_full);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
