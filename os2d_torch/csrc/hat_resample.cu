// Correlation-map resample + masked pool as a hat-weight matrix product on
// the tensor cores: the `resample_precision="default"` tier.
//
// Replaces the TPU kernel os2d_tpu/ops/pallas_hat_resample.py:
// _hat_resample_kernel (called through hat_resample_correlation_map_pallas),
// which is the one-pass bf16 matrix-unit form of the same op that the
// gather kernel (resample.cu) computes in fp32:
//
//   out[bc, a] = sum_t sum_w (wy_t @ M_t)[a, w] * wx_t[a, w]
//   M_t[h, w]  = bf16(corr[bc, h, w, t] * mask[c, t])   (built by the wrapper)
//   wy_t[a, h] = bf16(max(0, 1 - |py[bc, t, a] - h|))
//   wx_t[a, w] = max(0, 1 - |px[bc, t, a] - w|)           (fp32, not rounded)
//
// with the product wy_t @ M_t accumulated in fp32 and every later sum in
// fp32, t in order.
//
// Bound on an H100: bytes. The function is the gather's resample with its
// operands rounded to bf16, so it needs the gather's bytes (the fp32 corr
// prefix, px, py, the output: about 0.17 ms at 3.35 TB/s at the largest bench
// level, B=2, C=16, T=121, fm 96x128) and, for the two non-zero hat weights
// of each row, 2*2*W flops per sample. This dense first design does the whole
// hat product instead, 2*B*C*T*A*H*W flops (1.17e12 there, 1.18 ms at
// 989 TFLOP/s bf16), most of them on zero weights.
//
// First design: grid (ceil(A / 128), B*C), 8 warps, each warp owns one
// 16-anchor row tile of the product. For each t the block stages M_t
// transposed ([W, H] with H contiguous, zero-padded to a multiple of 16 and
// W to a multiple of 8) in shared memory; the row stride of H + 8 bf16 keeps
// the B-fragment loads free of bank conflicts. Each thread builds its
// A-fragments (the hat rows of its two anchors, rounded to bf16) once per t
// in registers, since py is known per anchor, and reuses them across every
// n-tile; `mma.sync.m16n8k16` bf16 -> fp32 does the product; the epilogue
// multiplies each accumulator by wx computed from px in fp32 and reduces
// over the quad. Every fp32 product and sum outside the tensor cores is
// rounded on its own (no contraction), as the plain version computes it.
// Left for later: wgmma and TMA, double-buffered staging, and skipping the
// zero band of the hat rows (only two of each row's H weights are non-zero).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kAnchorsPerBlock = kWarps * 16;
constexpr int kMaxKSteps = 16;  // H <= 256

__device__ __forceinline__ float hat(float p, float i) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, i))));
}

__device__ __forceinline__ uint32_t hat_pair_bf16(float p, int i) {
  // two hat weights at i and i + 1, rounded to bf16, low half first
  const __nv_bfloat162 v = __floats2bfloat162_rn(hat(p, static_cast<float>(i)),
                                                 hat(p, static_cast<float>(i + 1)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KSTEPS>
__global__ void __launch_bounds__(kThreads)
hat_resample_kernel(const __nv_bfloat16* __restrict__ m,  // [BC, T, H, W]
                    const float* __restrict__ px,         // [BC, T, A]
                    const float* __restrict__ py,         // [BC, T, A]
                    float* __restrict__ out,              // [BC, A]
                    int h, int w, int t_count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_mt = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int h_pad = KSTEPS * 16;
  constexpr int ld = h_pad + 8;  // row stride of the transposed slab, in bf16
  const int w_pad = (w + 7) & ~7;
  const int a_count = h * w;
  const int bc = blockIdx.y;

  // zero the whole slab once; each t rewrites only the valid h < H, w < W
  for (int i = threadIdx.x; i < w_pad * ld / 2; i += kThreads) {
    reinterpret_cast<uint32_t*>(s_mt)[i] = 0u;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane >> 2;  // row of the fragment, and +8
  const int tig = lane & 3;     // thread in group: column pair
  const int a0 = blockIdx.x * kAnchorsPerBlock + warp * 16 + group;
  const int a1 = a0 + 8;
  const bool in0 = a0 < a_count;
  const bool in1 = a1 < a_count;

  const int64_t plane = static_cast<int64_t>(h) * w;
  const __nv_bfloat16* m_bc = m + static_cast<int64_t>(bc) * t_count * plane;
  const float* px_bc = px + static_cast<int64_t>(bc) * t_count * a_count;
  const float* py_bc = py + static_cast<int64_t>(bc) * t_count * a_count;
  const int pairs = (h + 1) / 2;

  float acc0 = 0.0f, acc1 = 0.0f;
  for (int t = 0; t < t_count; ++t) {
    __syncthreads();  // the previous t's slab is no longer read
    const __nv_bfloat16* m_t = m_bc + static_cast<int64_t>(t) * plane;
    for (int i = threadIdx.x; i < pairs * w; i += kThreads) {
      const int hp = i / w;
      const int col = i - hp * w;
      const int row = 2 * hp;
      __nv_bfloat162 v;
      v.x = m_t[static_cast<int64_t>(row) * w + col];
      v.y = row + 1 < h ? m_t[static_cast<int64_t>(row + 1) * w + col]
                        : __float2bfloat16_rn(0.0f);
      *reinterpret_cast<__nv_bfloat162*>(s_mt + col * ld + row) = v;
    }

    const int64_t off = static_cast<int64_t>(t) * a_count;
    const float y0 = in0 ? py_bc[off + a0] : 0.0f;
    const float y1 = in1 ? py_bc[off + a1] : 0.0f;
    const float x0 = in0 ? px_bc[off + a0] : 0.0f;
    const float x1 = in1 ? px_bc[off + a1] : 0.0f;

    // A-fragments (m16n8k16, row-major): rows group / group + 8, columns
    // 2*tig + {0, 1} and 2*tig + 8 + {0, 1} of each 16-wide k-step
    uint32_t afrag[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int k = ks * 16 + 2 * tig;
      afrag[ks][0] = hat_pair_bf16(y0, k);
      afrag[ks][1] = hat_pair_bf16(y1, k);
      afrag[ks][2] = hat_pair_bf16(y0, k + 8);
      afrag[ks][3] = hat_pair_bf16(y1, k + 8);
    }
    __syncthreads();  // the slab of this t is staged

    float s0 = 0.0f, s1 = 0.0f;
    for (int n0 = 0; n0 < w_pad; n0 += 8) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      // B-fragment (k x n, "col"): k = 2*tig + {0, 1} (and + 8), n = group;
      // consecutive k sit next to each other in the transposed slab
      const __nv_bfloat16* col = s_mt + (n0 + group) * ld + 2 * tig;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col + ks * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(col + ks * 16 + 8);
        mma_bf16_16816(d, afrag[ks], b0, b1);
      }
      // accumulator: d[0], d[1] at row group, columns n0 + 2*tig + {0, 1};
      // d[2], d[3] at row group + 8
      const float c0 = static_cast<float>(n0 + 2 * tig);
      const float c1 = c0 + 1.0f;
      s0 = __fadd_rn(s0, __fmul_rn(d[0], hat(x0, c0)));
      s0 = __fadd_rn(s0, __fmul_rn(d[1], hat(x0, c1)));
      s1 = __fadd_rn(s1, __fmul_rn(d[2], hat(x1, c0)));
      s1 = __fadd_rn(s1, __fmul_rn(d[3], hat(x1, c1)));
    }
    // sum over the four threads of the quad: columns 2*tig + {0, 1}
    s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 1));
    s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 2));
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 1));
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 2));
    acc0 = __fadd_rn(acc0, s0);
    acc1 = __fadd_rn(acc1, s1);
  }
  if (tig == 0) {
    if (in0) out[static_cast<int64_t>(bc) * a_count + a0] = acc0;
    if (in1) out[static_cast<int64_t>(bc) * a_count + a1] = acc1;
  }
}

template <int KSTEPS>
int launch(const __nv_bfloat16* m, const float* px, const float* py, float* out,
           int bc_count, int h, int w, int t_count, cudaStream_t stream) {
  const int a_count = h * w;
  const dim3 grid((a_count + kAnchorsPerBlock - 1) / kAnchorsPerBlock, bc_count);
  const size_t smem = static_cast<size_t>((w + 7) & ~7) * (KSTEPS * 16 + 8) * 2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hat_resample_kernel<KSTEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hat_resample_kernel<KSTEPS><<<grid, kThreads, smem, stream>>>(m, px, py, out, h, w,
                                                                t_count);
  return static_cast<int>(cudaGetLastError());
}

template <int... Ks>
struct Dispatch;

template <int K, int... Ks>
struct Dispatch<K, Ks...> {
  static int run(int ksteps, const __nv_bfloat16* m, const float* px, const float* py,
                 float* out, int bc_count, int h, int w, int t_count, cudaStream_t s) {
    if (ksteps == K) return launch<K>(m, px, py, out, bc_count, h, w, t_count, s);
    return Dispatch<Ks...>::run(ksteps, m, px, py, out, bc_count, h, w, t_count, s);
  }
};

template <>
struct Dispatch<> {
  static int run(int, const __nv_bfloat16*, const float*, const float*, float*, int, int,
                 int, int, cudaStream_t) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success), among
// them the refusal of a shared-memory size above a block's. The caller has
// checked shapes, devices and that h <= 256; m is the bf16
// [B*C, T, H, W] operand, px/py are [B*C, T, H*W], out is [B*C, H*W].
extern "C" int os2d_hat_resample_correlation(const void* m, const float* px, const float* py,
                                             float* out, int bc_count, int h, int w,
                                             int t_count, void* stream) {
  const int ksteps = (h + 15) / 16;
  static_assert(kMaxKSteps == 16, "the dispatch list below covers 1..kMaxKSteps");
  return Dispatch<1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16>::run(
      ksteps, static_cast<const __nv_bfloat16*>(m), px, py, out, bc_count, h, w, t_count,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
