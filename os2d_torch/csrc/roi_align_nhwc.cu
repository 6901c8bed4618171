// RoIAlign over channels-last fp32 feature maps: CoAE's RoI head
// (models/coae.py) crops every proposal of every (image, query) pair from
// that pair's query-modulated map into a pooled x pooled grid.
//
// Replaces no TPU kernel: the JAX package runs no two-stage detector.
// torchvision's roi_align (aligned=False, sampling_ratio=0), which CoAE's
// code calls through maskrcnn-benchmark's ROIAlign, is not installed, and
// its kernel reads NCHW maps one channel plane at a time.
//
// Semantics (torchvision's roi_align_forward_kernel_impl, legacy
// coordinates: aligned=False): for RoI (n, x1, y1, x2, y2) in image pixels,
//   start = x1 * scale, end = x2 * scale (and y),
//   size = end - start, at least 1,
//   bin = size / pooled, grid = ceil(size / pooled) samples a bin side,
//   sample (iy, ix) of bin (ph, pw) at
//     y = start_y + ph * bin_y + (iy + 0.5) * bin_y / grid_y    (and x),
//   each sample bilinear in map n (0 where y < -1, y > H, x < -1 or x > W;
//   clamped to the last row or column at the border), the bin the sum of
//   its grid_y * grid_x samples (iy outer, ix inner) over max(count, 1).
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn: no FMA contraction), in that order, so that two
// launches agree to the bit and the plain version (ops/roi_align.py) gives
// the same sums.
//
// Layout: feats [N, H, W, C] fp32, C % 4 == 0, 16-byte aligned; rois [R, 5]
// fp32; out [R, pooled, pooled, C]. One block a bin (RoI, ph, pw), its
// threads over the C / 4 float4 channel vectors of a pixel, so each of a
// sample's four corner loads is one contiguous C * 4-byte row across the
// block; the sample's coordinates and weights are the same in every thread.
//
// Bound on an H100: bytes. The output is written once (at the CoAE cell's
// 9,600 RoIs of 7 x 7 x 1024, 1.93 GB, 0.58 ms at 3.35 TB/s); the corners
// come from the pair's map, which L2 holds while a pair's RoIs read it.
//
// One C entry point enqueues one kernel on the caller's stream, allocates
// nothing and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

struct Axis {
  int lo, hi;   // the two rows (columns) of the sample's corners
  float l, h;   // their weights: l for hi, h for lo
  bool inside;  // within [-1, size]
};

// torchvision's bilinear_interpolate along one axis
__device__ __forceinline__ Axis axis(float v, int size) {
  Axis a;
  a.inside = !(v < -1.f || v > static_cast<float>(size));
  if (v <= 0.f) v = 0.f;
  a.lo = static_cast<int>(v);
  if (a.lo >= size - 1) {
    a.hi = a.lo = size - 1;
    v = static_cast<float>(a.lo);
  } else {
    a.hi = a.lo + 1;
  }
  a.l = __fsub_rn(v, static_cast<float>(a.lo));
  a.h = __fsub_rn(1.f, a.l);
  return a;
}

__device__ __forceinline__ float corner_sum(float w1, float v1, float w2, float v2, float w3,
                                            float v3, float w4, float v4) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w1, v1), __fmul_rn(w2, v2)), __fmul_rn(w3, v3)),
                   __fmul_rn(w4, v4));
}

__global__ void __launch_bounds__(kMaxThreads)
RoiAlignNhwc(const float4* __restrict__ feats, const float* __restrict__ rois,
             float4* __restrict__ out, int height, int width, int cvecs, int pooled,
             float scale) {
  const int bins = pooled * pooled;
  const int64_t r = blockIdx.x / bins;
  const int bin = blockIdx.x % bins;
  const int ph = bin / pooled, pw = bin % pooled;
  const float* roi = rois + 5 * r;
  const int64_t n = static_cast<int64_t>(roi[0]);
  const float start_w = __fmul_rn(roi[1], scale), start_h = __fmul_rn(roi[2], scale);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(roi[3], scale), start_w), 1.f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(roi[4], scale), start_h), 1.f);
  const float fpooled = static_cast<float>(pooled);
  const float bin_w = __fdiv_rn(roi_w, fpooled), bin_h = __fdiv_rn(roi_h, fpooled);
  const int grid_w = static_cast<int>(ceilf(__fdiv_rn(roi_w, fpooled)));
  const int grid_h = static_cast<int>(ceilf(__fdiv_rn(roi_h, fpooled)));
  const int count = max(grid_h * grid_w, 1);
  const float base_h = __fadd_rn(start_h, __fmul_rn(static_cast<float>(ph), bin_h));
  const float base_w = __fadd_rn(start_w, __fmul_rn(static_cast<float>(pw), bin_w));
  const float4* map = feats + n * height * width * cvecs;
  float4* dst = out + (r * bins + bin) * cvecs;
  for (int c = threadIdx.x; c < cvecs; c += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int iy = 0; iy < grid_h; ++iy) {
      const float y = __fadd_rn(
          base_h, __fdiv_rn(__fmul_rn(static_cast<float>(iy) + 0.5f, bin_h),
                            static_cast<float>(grid_h)));
      const Axis ay = axis(y, height);
      for (int ix = 0; ix < grid_w; ++ix) {
        const float x = __fadd_rn(
            base_w, __fdiv_rn(__fmul_rn(static_cast<float>(ix) + 0.5f, bin_w),
                              static_cast<float>(grid_w)));
        const Axis ax = axis(x, width);
        if (!(ay.inside && ax.inside)) continue;  // the sample reads 0
        const float w1 = __fmul_rn(ay.h, ax.h), w2 = __fmul_rn(ay.h, ax.l);
        const float w3 = __fmul_rn(ay.l, ax.h), w4 = __fmul_rn(ay.l, ax.l);
        const float4 v1 = __ldg(map + (static_cast<int64_t>(ay.lo) * width + ax.lo) * cvecs + c);
        const float4 v2 = __ldg(map + (static_cast<int64_t>(ay.lo) * width + ax.hi) * cvecs + c);
        const float4 v3 = __ldg(map + (static_cast<int64_t>(ay.hi) * width + ax.lo) * cvecs + c);
        const float4 v4 = __ldg(map + (static_cast<int64_t>(ay.hi) * width + ax.hi) * cvecs + c);
        acc.x = __fadd_rn(acc.x, corner_sum(w1, v1.x, w2, v2.x, w3, v3.x, w4, v4.x));
        acc.y = __fadd_rn(acc.y, corner_sum(w1, v1.y, w2, v2.y, w3, v3.y, w4, v4.y));
        acc.z = __fadd_rn(acc.z, corner_sum(w1, v1.z, w2, v2.z, w3, v3.z, w4, v4.z));
        acc.w = __fadd_rn(acc.w, corner_sum(w1, v1.w, w2, v2.w, w3, v3.w, w4, v4.w));
      }
    }
    const float fcount = static_cast<float>(count);
    dst[c] = make_float4(__fdiv_rn(acc.x, fcount), __fdiv_rn(acc.y, fcount),
                         __fdiv_rn(acc.z, fcount), __fdiv_rn(acc.w, fcount));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// out [num_rois, pooled, pooled, channels] = RoIAlign of feats [n, height,
// width, channels] (fp32, channels-last) at rois [num_rois, 5] (map index,
// x1, y1, x2, y2 in image pixels; the index must lie in [0, n)), legacy
// coordinates. channels % 4 == 0; feats and out 16-byte aligned.
extern "C" int os2d_roi_align(const float* feats, const float* rois, float* out,
                              int64_t num_rois, int height, int width, int channels,
                              int pooled, float spatial_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_rois < 1 || height < 1 || width < 1 || channels < 4 || channels % 4 || pooled < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rois * pooled * pooled > int64_t{0x7fffffff})
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(feats) || !aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  const int cvecs = channels / 4;
  int threads = cvecs < kMaxThreads ? cvecs : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const unsigned blocks = static_cast<unsigned>(num_rois * pooled * pooled);
  RoiAlignNhwc<<<blocks, threads, 0, s>>>(
      reinterpret_cast<const float4*>(feats), rois, reinterpret_cast<float4*>(out), height,
      width, cvecs, pooled, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
