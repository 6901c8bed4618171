// GroupNorm on channels-last fp32 activations, forward and backward: the
// norm of the port's GroupNorm(32) ResNet-C4 backbone on the card.
//
// Replaces no TPU kernel: the JAX package computes GroupNorm as XLA
// reductions (os2d_tpu/models/resnet.py: _norm), and XLA keeps the NHWC
// layout. On the card ATen's group_norm makes its input NCHW-contiguous and
// writes NCHW, so each slot of a channels-last backbone copied its
// activation in and left the next convolution to copy it back. These
// kernels read and write the [N, H*W, C] memory of an NCHW view of
// channels-last memory as it is.
//
// Forward, per sample n and group g of C/G channels (M = H*W*C/G values):
//   mean, var = the mean and biased variance over the group's values, fp32
//   rstd = 1 / sqrt(var + eps)
//   y = ((x - mean) * rstd) * gamma[c] + beta[c], each product and sum
//   rounded on its own, in the plain version's order.
// The statistics are Welford's: each thread keeps a running mean and sum of
// squared deviations of its four channels over its rows, and these merge by
// Chan's rule (the moments of a union of two disjoint sets) in a fixed
// order: the block's threads row by row, the group's channels in order,
// then the chunks of rows of the sample in a fixed tree. No sum of squares
// of raw values is formed, so a group far from zero loses nothing to
// cancellation, as the reference's two-pass statistics do not.
//
// Backward, with xc = x - mean, per (n, c) the sums over H*W
//   sdy[n, c] = sum dy,  sdyx[n, c] = sum dy * xc
// then per (n, g), over the group's channels,
//   A = sum gamma[c] * sdy[n, c],  B = sum gamma[c] * sdyx[n, c]
//   dx = (gamma[c] * rstd) * dy - rstd * A / M - xc * (rstd^3 * B / M)
//   dgamma[c] = sum_n sdyx[n, c] * rstd[n, g],  dbeta[c] = sum_n sdy[n, c].
// Every sum is taken by one thread after another in a fixed order, with no
// atomics, so two calls give the same bits.
//
// Bound on an H100: bytes. The least traffic is x read and y written
// forward, x and dy read and dx written backward (the statistics and the
// per-channel tensors are small): at exp2's V2 recipe 9.9 GB a training
// step over the 43 slots of both passes, 3.0 ms at 3.35 TB/s. This design
// reads x once more in the forward (statistics, then the normalization) and
// x and dy once more in the backward (sums, then dx): 3 passes of the
// activation forward and 5 backward against the least 2 and 3, less what
// the 50 MB L2 keeps between the two kernels of a small slot.
//
// Each direction is one C entry point that enqueues its kernels on the
// caller's stream and allocates nothing (the wrapper passes its scratch):
//   forward:  GroupNormChannelsLastStats    per (chunk of rows, n): Welford
//                                            moments of each group
//             GroupNormChannelsLastFinalize per (n, g): the chunks merged,
//                                            mean and rstd
//             GroupNormChannelsLastApply    y, one float4 a thread
//   backward: GroupNormChannelsLastGradSums per (chunk of rows, n): sdy and
//                                            sdyx of each channel
//             GroupNormChannelsLastGradChunkSums a warp per (n, c): the
//                                            chunks summed
//             GroupNormChannelsLastGradFinalize per g: A, B, dgamma, dbeta
//             GroupNormChannelsLastGradApply dx, one float4 a thread
// A row-parallel block has rows_par rows in flight, C/4 threads on each
// (four channels a thread, one float4 load a row), and walks chunk_rows
// rows, kRowBatch rows' loads of a thread issued together; the wrapper
// chooses both (ops/group_norm.py). The first design summed each (n, c)'s
// chunks in one thread of a block per group: at the stem's 352 chunks that
// serial chain took 0.26 ms of the slot's 0.41 ms backward on an H100.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFinalizeThreads = 128;
constexpr int kApplyThreads = 256;
constexpr int kMaxRowThreads = 512;
// rows a thread loads before it uses them (of the chunk's rows per thread)
constexpr int kRowBatch = 4;

struct Moments {
  float n, mean, m2;
};

// Chan's rule: the count, mean and sum of squared deviations of the union
// of two disjoint sets
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return Moments{n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * (a.n * wb)};
}

// the mean and rstd of channels c0 .. c0 + 3 of a sample whose groups start
// at index ng0: one load each where the four share a group
__device__ __forceinline__ void group_stats(const float* __restrict__ mean,
                                            const float* __restrict__ rstd, int ng0, int c0,
                                            int group_size, float mu[4], float rs[4]) {
  if (group_size % 4 == 0) {
    const int ng = ng0 + c0 / group_size;
    const float m = mean[ng], r = rstd[ng];
#pragma unroll
    for (int j = 0; j < 4; ++j) mu[j] = m, rs[j] = r;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ng = ng0 + (c0 + j) / group_size;
      mu[j] = mean[ng];
      rs[j] = rstd[ng];
    }
  }
}

// the backward's two coefficients of channels c0 .. c0 + 3, as group_stats
__device__ __forceinline__ void group_coefs(const float* __restrict__ coef, int ng0, int c0,
                                            int group_size, float k1[4], float k2[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ng = ng0 + (group_size % 4 == 0 ? c0 : c0 + j) / group_size;
    k1[j] = coef[2 * ng];
    k2[j] = coef[2 * ng + 1];
  }
}

__global__ void __launch_bounds__(kMaxRowThreads)
GroupNormChannelsLastStats(const float* __restrict__ x, float* __restrict__ partial, int rows,
                           int channels, int groups, int rows_par, int chunk_rows, int chunks) {
  extern __shared__ float smem[];
  const int vecs = channels / 4;
  const int tid = threadIdx.x;
  const int rp = tid / vecs, v = tid % vecs;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int row0 = chunk * chunk_rows;
  const int row_end = min(rows, row0 + chunk_rows);
  const float4* xs =
      reinterpret_cast<const float4*>(x + static_cast<int64_t>(n) * rows * channels);
  float count = 0.f;
  float mean[4] = {0.f, 0.f, 0.f, 0.f}, m2[4] = {0.f, 0.f, 0.f, 0.f};
  // kRowBatch rows' loads in flight at once, then their updates in row order
  for (int r0 = row0 + rp; r0 < row_end; r0 += kRowBatch * rows_par) {
    float4 q[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const int r = r0 + k * rows_par;
      if (r < row_end) q[k] = xs[static_cast<int64_t>(r) * vecs + v];
    }
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      if (r0 + k * rows_par >= row_end) break;
      const float vals[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
      count += 1.f;
      const float inv = 1.f / count;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = vals[j] - mean[j];
        mean[j] += d * inv;
        m2[j] += d * (vals[j] - mean[j]);
      }
    }
  }
  // [rows_par] counts, then [rows_par][channels] means and m2
  float* s_count = smem;
  float* s_mean = smem + rows_par;
  float* s_m2 = s_mean + rows_par * channels;
  if (v == 0) s_count[rp] = count;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s_mean[rp * channels + 4 * v + j] = mean[j];
    s_m2[rp * channels + 4 * v + j] = m2[j];
  }
  __syncthreads();
  // each channel's rows merged row thread by row thread; only the thread of
  // column c reads or writes it, so row 0 takes the result in place
  for (int c = tid; c < channels; c += blockDim.x) {
    Moments acc{0.f, 0.f, 0.f};
    for (int p = 0; p < rows_par; ++p)
      acc = merge(acc, Moments{s_count[p], s_mean[p * channels + c], s_m2[p * channels + c]});
    s_mean[c] = acc.mean;
    s_m2[c] = acc.m2;
  }
  __syncthreads();
  const int group_size = channels / groups;
  const float rows_here = static_cast<float>(row_end - row0);
  for (int g = tid; g < groups; g += blockDim.x) {
    Moments acc{0.f, 0.f, 0.f};
    for (int j = 0; j < group_size; ++j) {
      const int c = g * group_size + j;
      acc = merge(acc, Moments{rows_here, s_mean[c], s_m2[c]});
    }
    float* out = partial + ((static_cast<int64_t>(n) * chunks + chunk) * groups + g) * 3;
    out[0] = acc.n;
    out[1] = acc.mean;
    out[2] = acc.m2;
  }
}

__global__ void __launch_bounds__(kFinalizeThreads)
GroupNormChannelsLastFinalize(const float* __restrict__ partial, float* __restrict__ mean,
                              float* __restrict__ rstd, int groups, int chunks, float eps) {
  __shared__ float s_n[kFinalizeThreads], s_mean[kFinalizeThreads], s_m2[kFinalizeThreads];
  const int ng = blockIdx.x;  // n * groups + g
  const int n = ng / groups, g = ng % groups;
  const int t = threadIdx.x;
  Moments acc{0.f, 0.f, 0.f};
  for (int k = t; k < chunks; k += kFinalizeThreads) {
    const float* p = partial + ((static_cast<int64_t>(n) * chunks + k) * groups + g) * 3;
    acc = merge(acc, Moments{p[0], p[1], p[2]});
  }
  s_n[t] = acc.n;
  s_mean[t] = acc.mean;
  s_m2[t] = acc.m2;
  __syncthreads();
  for (int s = kFinalizeThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      const Moments m = merge(Moments{s_n[t], s_mean[t], s_m2[t]},
                              Moments{s_n[t + s], s_mean[t + s], s_m2[t + s]});
      s_n[t] = m.n;
      s_mean[t] = m.mean;
      s_m2[t] = m.m2;
    }
    __syncthreads();
  }
  if (t == 0) {
    mean[ng] = s_mean[0];
    rstd[ng] = 1.f / sqrtf(s_m2[0] / s_n[0] + eps);
  }
}

__global__ void __launch_bounds__(kApplyThreads)
GroupNormChannelsLastApply(const float* __restrict__ x, const float* __restrict__ gamma,
                           const float* __restrict__ beta, const float* __restrict__ mean,
                           const float* __restrict__ rstd, float* __restrict__ y, int rows,
                           int channels, int groups) {
  const int n = blockIdx.y;
  const int vecs = channels / 4;
  const int per_sample = rows * vecs;
  const int group_size = channels / groups;
  const int64_t base = static_cast<int64_t>(n) * per_sample;
  const float4* xs = reinterpret_cast<const float4*>(x) + base;
  float4* ys = reinterpret_cast<float4*>(y) + base;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_sample;
       i += gridDim.x * blockDim.x) {
    const int c0 = (i % vecs) * 4;
    const float4 q = xs[i];
    const float4 gq = reinterpret_cast<const float4*>(gamma)[c0 / 4];
    const float4 bq = reinterpret_cast<const float4*>(beta)[c0 / 4];
    const float vals[4] = {q.x, q.y, q.z, q.w};
    const float gs[4] = {gq.x, gq.y, gq.z, gq.w}, bs[4] = {bq.x, bq.y, bq.z, bq.w};
    float mu[4], rs[4];
    group_stats(mean, rstd, n * groups, c0, group_size, mu, rs);
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(vals[j], mu[j]), rs[j]), gs[j]), bs[j]);
    ys[i] = make_float4(out[0], out[1], out[2], out[3]);
  }
}

__global__ void __launch_bounds__(kMaxRowThreads)
GroupNormChannelsLastGradSums(const float* __restrict__ dy, const float* __restrict__ x,
                              const float* __restrict__ mean, float* __restrict__ partial_dy,
                              float* __restrict__ partial_dyx, int rows, int channels,
                              int groups, int rows_par, int chunk_rows, int chunks) {
  extern __shared__ float smem[];
  const int vecs = channels / 4;
  const int tid = threadIdx.x;
  const int rp = tid / vecs, v = tid % vecs;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int row0 = chunk * chunk_rows;
  const int row_end = min(rows, row0 + chunk_rows);
  const int group_size = channels / groups;
  const int64_t base = static_cast<int64_t>(n) * rows * channels;
  const float4* dys = reinterpret_cast<const float4*>(dy + base);
  const float4* xs = reinterpret_cast<const float4*>(x + base);
  float m[4], sdy[4] = {0.f, 0.f, 0.f, 0.f}, sdyx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = mean[n * groups + (4 * v + j) / group_size];
  for (int r0 = row0 + rp; r0 < row_end; r0 += kRowBatch * rows_par) {
    float4 q[kRowBatch], p[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const int r = r0 + k * rows_par;
      if (r < row_end) {
        const int64_t i = static_cast<int64_t>(r) * vecs + v;
        q[k] = dys[i];
        p[k] = xs[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      if (r0 + k * rows_par >= row_end) break;
      const float g[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
      const float xv[4] = {p[k].x, p[k].y, p[k].z, p[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sdy[j] += g[j];
        sdyx[j] += g[j] * (xv[j] - m[j]);
      }
    }
  }
  float* s_dy = smem;
  float* s_dyx = smem + rows_par * channels;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s_dy[rp * channels + 4 * v + j] = sdy[j];
    s_dyx[rp * channels + 4 * v + j] = sdyx[j];
  }
  __syncthreads();
  for (int c = tid; c < channels; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int p = 0; p < rows_par; ++p) {
      a += s_dy[p * channels + c];
      b += s_dyx[p * channels + c];
    }
    const int64_t o = (static_cast<int64_t>(n) * chunks + chunk) * channels + c;
    partial_dy[o] = a;
    partial_dyx[o] = b;
  }
}

// one warp per (n, c): lane l adds chunks l, l + 32, ... in order, then the
// lanes' sums meet in a fixed tree
__global__ void __launch_bounds__(kApplyThreads)
GroupNormChannelsLastGradChunkSums(const float* __restrict__ partial_dy,
                                   const float* __restrict__ partial_dyx,
                                   float* __restrict__ sum_dy, float* __restrict__ sum_dyx,
                                   int batch, int channels, int chunks) {
  const int lane = threadIdx.x % 32;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * (kApplyThreads / 32) + threadIdx.x / 32;
  if (pair >= static_cast<int64_t>(batch) * channels) return;  // whole warps
  const int64_t n = pair / channels, c = pair % channels;
  float a = 0.f, b = 0.f;
  for (int k = lane; k < chunks; k += 32) {
    const int64_t o = (n * chunks + k) * channels + c;
    a += partial_dy[o];
    b += partial_dyx[o];
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, offset);
    b += __shfl_down_sync(0xffffffffu, b, offset);
  }
  if (lane == 0) {
    sum_dy[pair] = a;
    sum_dyx[pair] = b;
  }
}

__global__ void __launch_bounds__(kApplyThreads)
GroupNormChannelsLastGradFinalize(const float* __restrict__ gamma,
                                  const float* __restrict__ rstd,
                                  const float* __restrict__ sum_dy,
                                  const float* __restrict__ sum_dyx, float* __restrict__ coef,
                                  float* __restrict__ dgamma, float* __restrict__ dbeta,
                                  int batch, int rows, int channels, int groups) {
  const int g = blockIdx.x;
  const int group_size = channels / groups;
  const float inv_m = 1.f / (static_cast<float>(rows) * static_cast<float>(group_size));
  for (int n = threadIdx.x; n < batch; n += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < group_size; ++j) {
      const int c = g * group_size + j;
      a += gamma[c] * sum_dy[static_cast<int64_t>(n) * channels + c];
      b += gamma[c] * sum_dyx[static_cast<int64_t>(n) * channels + c];
    }
    const float r = rstd[n * groups + g];
    coef[2 * (n * groups + g)] = r * a * inv_m;
    coef[2 * (n * groups + g) + 1] = r * r * r * b * inv_m;
  }
  for (int j = threadIdx.x; j < group_size; j += blockDim.x) {
    const int c = g * group_size + j;
    float dg = 0.f, db = 0.f;
    for (int n = 0; n < batch; ++n) {
      dg += sum_dyx[static_cast<int64_t>(n) * channels + c] * rstd[n * groups + g];
      db += sum_dy[static_cast<int64_t>(n) * channels + c];
    }
    dgamma[c] = dg;
    dbeta[c] = db;
  }
}

__global__ void __launch_bounds__(kApplyThreads)
GroupNormChannelsLastGradApply(const float* __restrict__ dy, const float* __restrict__ x,
                               const float* __restrict__ gamma, const float* __restrict__ mean,
                               const float* __restrict__ rstd, const float* __restrict__ coef,
                               float* __restrict__ dx, int rows, int channels, int groups) {
  const int n = blockIdx.y;
  const int vecs = channels / 4;
  const int per_sample = rows * vecs;
  const int group_size = channels / groups;
  const int64_t base = static_cast<int64_t>(n) * per_sample;
  const float4* dys = reinterpret_cast<const float4*>(dy) + base;
  const float4* xs = reinterpret_cast<const float4*>(x) + base;
  float4* dxs = reinterpret_cast<float4*>(dx) + base;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_sample;
       i += gridDim.x * blockDim.x) {
    const int c0 = (i % vecs) * 4;
    const float4 q = dys[i], p = xs[i];
    const float4 gq = reinterpret_cast<const float4*>(gamma)[c0 / 4];
    const float g[4] = {q.x, q.y, q.z, q.w}, xv[4] = {p.x, p.y, p.z, p.w};
    const float gs[4] = {gq.x, gq.y, gq.z, gq.w};
    float mu[4], rs[4], k1[4], k2[4];
    group_stats(mean, rstd, n * groups, c0, group_size, mu, rs);
    group_coefs(coef, n * groups, c0, group_size, k1, k2);
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t1 = __fmul_rn(__fmul_rn(gs[j], rs[j]), g[j]);
      const float t2 = __fmul_rn(__fsub_rn(xv[j], mu[j]), k2[j]);
      out[j] = __fsub_rn(__fsub_rn(t1, k1[j]), t2);
    }
    dxs[i] = make_float4(out[0], out[1], out[2], out[3]);
  }
}

// the shapes every kernel takes: channels a multiple of the group count and
// of 4 (one float4 never leaves a row), a row's threads in one block; a
// sample's float4s indexed in 32 bits; batch within the grid's y
bool valid_shape(int batch, int rows, int channels, int groups, int rows_par, int chunk_rows,
                 int chunks) {
  if (batch < 1 || batch > 65535 || rows < 1 || groups < 1 || channels % groups ||
      channels % 4)
    return false;
  if (static_cast<int64_t>(batch) * groups > INT_MAX) return false;
  if (static_cast<int64_t>(rows) * channels > INT_MAX) return false;
  if (rows_par < 1 || rows_par * (channels / 4) > kMaxRowThreads) return false;
  if (chunk_rows % (kRowBatch * rows_par) || chunks < 1 ||
      static_cast<int64_t>(chunks) * chunk_rows < rows ||
      static_cast<int64_t>(chunks - 1) * chunk_rows >= rows)
    return false;
  return true;
}

unsigned apply_blocks(int rows, int channels) {
  const int64_t vecs = static_cast<int64_t>(rows) * (channels / 4);
  return static_cast<unsigned>((vecs + kApplyThreads - 1) / kApplyThreads);
}

}  // namespace

extern "C" int os2d_group_norm_forward(const float* x, const float* gamma, const float* beta,
                                       float* y, float* mean, float* rstd, float* partial,
                                       int batch, int rows, int channels, int groups,
                                       int rows_par, int chunk_rows, int chunks, float eps,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_shape(batch, rows, channels, groups, rows_par, chunk_rows, chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_threads = rows_par * (channels / 4);
  const size_t stats_bytes =
      sizeof(float) * (rows_par + 2 * static_cast<size_t>(rows_par) * channels);
  GroupNormChannelsLastStats<<<dim3(chunks, batch), row_threads, stats_bytes, s>>>(
      x, partial, rows, channels, groups, rows_par, chunk_rows, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  GroupNormChannelsLastFinalize<<<batch * groups, kFinalizeThreads, 0, s>>>(partial, mean, rstd,
                                                                           groups, chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  GroupNormChannelsLastApply<<<dim3(apply_blocks(rows, channels), batch), kApplyThreads, 0, s>>>(
      x, gamma, beta, mean, rstd, y, rows, channels, groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int os2d_group_norm_backward(const float* dy, const float* x, const float* gamma,
                                        const float* mean, const float* rstd, float* dx,
                                        float* dgamma, float* dbeta, float* partial,
                                        float* sums, float* coef, int batch, int rows,
                                        int channels, int groups, int rows_par, int chunk_rows,
                                        int chunks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_shape(batch, rows, channels, groups, rows_par, chunk_rows, chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_threads = rows_par * (channels / 4);
  const size_t sums_bytes = sizeof(float) * 2 * static_cast<size_t>(rows_par) * channels;
  const int64_t partial_size = static_cast<int64_t>(batch) * chunks * channels;
  GroupNormChannelsLastGradSums<<<dim3(chunks, batch), row_threads, sums_bytes, s>>>(
      dy, x, mean, partial, partial + partial_size, rows, channels, groups, rows_par, chunk_rows,
      chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t sums_size = static_cast<int64_t>(batch) * channels;
  const int64_t sum_blocks = (sums_size + kApplyThreads / 32 - 1) / (kApplyThreads / 32);
  GroupNormChannelsLastGradChunkSums<<<static_cast<unsigned>(sum_blocks), kApplyThreads, 0, s>>>(
      partial, partial + partial_size, sums, sums + sums_size, batch, channels, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  GroupNormChannelsLastGradFinalize<<<groups, kApplyThreads, 0, s>>>(
      gamma, rstd, sums, sums + sums_size, coef, dgamma, dbeta, batch, rows, channels, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  GroupNormChannelsLastGradApply<<<dim3(apply_blocks(rows, channels), batch), kApplyThreads, 0,
                                   s>>>(dy, x, gamma, mean, rstd, coef, dx, rows, channels,
                                        groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* os2d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
