// Frozen BatchNorm with its ReLU, and with a bottleneck's residual add, in
// one pass over fp32 activations: the norm slots of the port's ResNet-C4
// wherever no gradient is recorded (eval, serving, the class heads' build).
//
// Replaces no TPU kernel: the JAX package writes the frozen BatchNorm, the
// residual add and the ReLU as jnp expressions (os2d_tpu/models/resnet.py:
// _norm, _bottleneck) and XLA fuses them. On the card ATen ran each as its
// own pass over memory: per slot x * scale and + shift, then the ReLU, and
// at a bottleneck's tail the add and a second ReLU, each reading and
// writing the whole activation, besides five tiny launches that fold the
// four parameter vectors into scale and shift.
//
// Per element, with the per-channel fold computed as ATen computes it
// (FrozenBatchNorm2d.folding_factor and forward):
//   scale = weight * rsqrtf(running_var + eps)
//   shift = bias - running_mean * scale
//   bn(v) = v * scale + shift
// and three forms:
//   kRelu       y = relu(bn(x))                    stem, bn1, bn2
//   kAddRelu    y = relu(bn(x) + identity)         a tail without downsample
//   kBnAddRelu  y = relu(bn(x) + bn'(identity))    a tail with downsample:
//               bn3, the downsample's BatchNorm, the add and the ReLU
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
// FMA contraction), in ATen's order, and the ReLU keeps NaN as ATen's
// clamp_min does, so the output equals the eager chain's bit for bit.
//
// Bound on an H100: bytes. Each element is read once and written once (the
// tail also reads its identity once): at the 1.6 pyramid level's stem slot
// (2 x 64 x 1024 x 768) 805 MB, 0.24 ms at 3.35 TB/s, where the eager chain
// moved three times as much. Loads and stores are 16-byte vectors (four
// channels of one pixel, or four pixels of one channel plane), a few in
// flight per thread, in a grid-stride loop over a grid of a few waves.
//
// Two layouts of an NCHW tensor's memory:
//   channels-last [N, H, W, C]: the block has a multiple of C / 4 threads
//     and the grid's stride is a multiple of C / 4 vectors, so a thread
//     meets the same four channels in every vector it handles and folds
//     their parameters once, in registers;
//   NCHW-contiguous [N, C, H, W] with H * W % 4 == 0: a vector lies in one
//     channel plane, whose channel the thread finds and folds per vector.
// The wrapper (ops/frozen_bn.py) copies anything else to channels-last.
//
// One C entry point enqueues one kernel on the caller's stream, allocates
// nothing and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRelu = 0;
constexpr int kAddRelu = 1;
constexpr int kBnAddRelu = 2;

constexpr int kThreads = 256;
constexpr int kMaxThreads = 1024;
// vectors of one thread whose loads are issued together
constexpr int kUnroll = 4;
// blocks of the grid per SM: a few waves, so that a thread handles several
// vectors and folds its channels' parameters once for all of them
constexpr int kBlocksPerSm = 16;

struct Bn {
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
};

struct Fold {
  float scale[4], shift[4];
};

// ATen's folding_factor and shift, each operation rounded on its own
__device__ __forceinline__ void fold(const Bn& bn, int c, float eps, float& scale,
                                     float& shift) {
  scale = __fmul_rn(__ldg(bn.weight + c), rsqrtf(__fadd_rn(__ldg(bn.var + c), eps)));
  shift = __fsub_rn(__ldg(bn.bias + c), __fmul_rn(__ldg(bn.mean + c), scale));
}

// channels c0 .. c0 + 3 (channels-last) or channel c0 four times (NCHW)
template <bool kChannelsLast>
__device__ __forceinline__ Fold fold4(const Bn& bn, int c0, float eps) {
  Fold f;
  if constexpr (kChannelsLast) {
#pragma unroll
    for (int j = 0; j < 4; ++j) fold(bn, c0 + j, eps, f.scale[j], f.shift[j]);
  } else {
    fold(bn, c0, eps, f.scale[0], f.shift[0]);
#pragma unroll
    for (int j = 1; j < 4; ++j) f.scale[j] = f.scale[0], f.shift[j] = f.shift[0];
  }
  return f;
}

__device__ __forceinline__ float bn_value(float v, const Fold& f, int j) {
  return __fadd_rn(__fmul_rn(v, f.scale[j]), f.shift[j]);
}

// ATen's relu on the card: clamp_min(v, 0), which keeps NaN (v != v is the
// NaN test; fmaxf alone would return 0)
__device__ __forceinline__ float relu(float v) { return v != v ? v : fmaxf(v, 0.f); }

template <int kForm>
__device__ __forceinline__ float4 apply(float4 xv, float4 iv, const Fold& f, const Fold& g) {
  float xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const float is[4] = {iv.x, iv.y, iv.z, iv.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v = bn_value(xs[j], f, j);
    if constexpr (kForm == kAddRelu) v = __fadd_rn(v, is[j]);
    if constexpr (kForm == kBnAddRelu) v = __fadd_rn(v, bn_value(is[j], g, j));
    xs[j] = relu(v);
  }
  return make_float4(xs[0], xs[1], xs[2], xs[3]);
}

// y = the form's output over `vecs` float4 vectors of x (and identity);
// channels-last: blockDim.x is a multiple of channels / 4; NCHW:
// plane_vecs = H * W / 4 vectors per channel plane
template <int kForm, bool kChannelsLast>
__global__ void __launch_bounds__(kMaxThreads)
FrozenBnAct(const float4* __restrict__ x, Bn bn, const float4* __restrict__ identity, Bn id_bn,
            float4* __restrict__ y, int64_t vecs, int channels, int64_t plane_vecs, float eps) {
  Fold f{}, g{};
  if constexpr (kChannelsLast) {
    const int c0 = 4 * (threadIdx.x % (channels / 4));
    f = fold4<true>(bn, c0, eps);
    if constexpr (kForm == kBnAddRelu) g = fold4<true>(id_bn, c0, eps);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; v0 < vecs;
       v0 += kUnroll * stride) {
    float4 xq[kUnroll], iq[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + u * stride;
      if (v < vecs) {
        xq[u] = x[v];
        if constexpr (kForm != kRelu) iq[u] = identity[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + u * stride;
      if (v >= vecs) break;
      if constexpr (!kChannelsLast) {
        const int c = static_cast<int>((v / plane_vecs) % channels);
        f = fold4<false>(bn, c, eps);
        if constexpr (kForm == kBnAddRelu) g = fold4<false>(id_bn, c, eps);
      }
      y[v] = apply<kForm>(xq[u], kForm == kRelu ? xq[u] : iq[u], f, g);
    }
  }
}

template <int kForm>
cudaError_t launch(bool channels_last, unsigned blocks, int threads, cudaStream_t s,
                   const float4* x, Bn bn, const float4* identity, Bn id_bn, float4* y,
                   int64_t vecs, int channels, int64_t plane_vecs, float eps) {
  if (channels_last)
    FrozenBnAct<kForm, true><<<blocks, threads, 0, s>>>(x, bn, identity, id_bn, y, vecs,
                                                        channels, plane_vecs, eps);
  else
    FrozenBnAct<kForm, false><<<blocks, threads, 0, s>>>(x, bn, identity, id_bn, y, vecs,
                                                         channels, plane_vecs, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// y = relu(bn(x)) (form 0), relu(bn(x) + identity) (form 1) or
// relu(bn(x) + bn'(identity)) (form 2) over N * C * H * W fp32 values
// (vecs = that / 4). plane_vecs is 0 for channels-last memory, else
// H * W / 4 (NCHW-contiguous memory). x, identity and y 16-byte aligned;
// the parameter vectors [C] fp32; identity and the id_* vectors unused
// where the form does not read them.
extern "C" int os2d_frozen_bn_act(const float* x, const float* weight, const float* bias,
                                  const float* mean, const float* var, const float* identity,
                                  const float* id_weight, const float* id_bias,
                                  const float* id_mean, const float* id_var, float* y,
                                  int64_t vecs, int channels, int64_t plane_vecs, int form,
                                  float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool channels_last = plane_vecs == 0;
  if (vecs < 1 || channels < 1 || plane_vecs < 0 || form < kRelu || form > kBnAddRelu)
    return static_cast<int>(cudaErrorInvalidValue);
  if (channels_last ? (channels % 4 || channels / 4 > kMaxThreads)
                    : vecs % (plane_vecs * channels))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(y) || (form != kRelu && !aligned16(identity)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cvecs = channels / 4;
  const int threads = channels_last ? cvecs * (cvecs < kThreads ? kThreads / cvecs : 1)
                                    : kThreads;
  const int64_t needed = (vecs + static_cast<int64_t>(threads) * kUnroll - 1) /
                         (static_cast<int64_t>(threads) * kUnroll);
  const unsigned blocks =
      static_cast<unsigned>(needed < int64_t{sms} * kBlocksPerSm ? needed
                                                                  : int64_t{sms} * kBlocksPerSm);
  const Bn bn{weight, bias, mean, var};
  const Bn id_bn{id_weight, id_bias, id_mean, id_var};
  const float4* xv = reinterpret_cast<const float4*>(x);
  const float4* iv = reinterpret_cast<const float4*>(identity);
  float4* yv = reinterpret_cast<float4*>(y);
  switch (form) {
    case kRelu:
      err = launch<kRelu>(channels_last, blocks, threads, s, xv, bn, iv, id_bn, yv, vecs,
                          channels, plane_vecs, eps);
      break;
    case kAddRelu:
      err = launch<kAddRelu>(channels_last, blocks, threads, s, xv, bn, iv, id_bn, yv, vecs,
                             channels, plane_vecs, eps);
      break;
    default:
      err = launch<kBnAddRelu>(channels_last, blocks, threads, s, xv, bn, iv, id_bn, yv, vecs,
                               channels, plane_vecs, eps);
  }
  return static_cast<int>(err);
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
