// Hand-written Hopper (sm_90a) kernels for the style nets' conv bias +
// instance norm + ReLU + residual, with a plain C interface loaded by
// ctypes (dvf_tpu_torch/models/layers.py: bias_norm_act).
//
// They replace no TPU kernel: dvf_tpu has no Pallas kernel for the
// instance norm (XLA fuses the reference's jnp chain on the TPU). On the
// card the same chain ran as ~12 PyTorch kernels per norm: the bias add in
// bf16, a float32 copy, var_mean, the affine map in float32, the cast back,
// the ReLU and the residual add, ~28 bytes an element before the ReLU and
// the residual. At the style stream's batch (8 x 720 x 1280, 15 norms over
// 1,356.5 M elements) that is ~44 GB a batch, about half the step.
//
// out = [res +] [relu] round(round(y + b) * a + shift), per (sample, channel)
//   a = scale / sqrt(var + eps), shift = bias - mean * a,
// with mean and var (the population variance, as jnp.var) of round(y + b)
// over H x W, in float32. "round" is the storage dtype's rounding (bf16 or
// float32), taken wherever the plain chain rounds: the bias add, the
// affine map's result and the residual add. So the result differs from
// the chain only by the summation order of the statistics.
//
// Bound: bytes. The statistics read y once and the apply pass reads y (and
// the residual) and writes out once: 6 bytes an element in bf16 (8 with a
// residual), ~8.7 GB a batch at the stream's shapes, 2.6 ms at 3.35 TB/s.
// The arithmetic (a Welford update, ~5 float ops an element) is far below
// the card's float32 rate. The design spends its effort on the loads:
//
// - Three launches: statistics, a tiny merge, the apply pass. The grid of
//   the two large ones is (slice, sample, channel tile); a block of 256
//   threads covers `rows` pixels x `lanes` 16-byte chunks of channels
//   (lanes = C / 8 in bf16, C / 4 in float32, at most 256), so a block
//   reads rows x C contiguous elements (4 KB) per step and each thread
//   keeps one fixed group of channels: its conv bias, a and shift live in
//   registers for the whole pass.
// - Each thread loads four chunks before it uses any (16 bytes each, kept
//   packed in registers), so a thread has 64 bytes in flight.
// - Statistics: each thread runs Welford's update over its pixels (one
//   reciprocal a pixel, shared by the chunk's channels); the block merges
//   its rows by Chan's parallel formula in shared memory and writes one
//   partial (count, mean, M2) per channel; the merge launch combines the
//   slices' partials the same way and writes a and shift. A plain sum and
//   sum of squares would cancel over 921,600 elements; the merges do not.
// - A channel count that is not a multiple of the 16-byte chunk, or a
//   pointer that is not 16-byte aligned, takes the same kernels with one
//   element a thread (any C >= 1).
//
// Nothing is allocated here: the caller hands in the float32 scratch of
// (3 x B x slices x C) partials and (2 x B x C) coefficients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // chunks a thread loads before it uses one

// N storage elements, loaded and stored as one access (16 bytes for the
// vector path).
template <typename T, int N>
struct alignas(sizeof(T) * N) Chunk {
  T v[N];
};

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T to_storage(float v);
template <>
__device__ __forceinline__ float to_storage<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_storage<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the storage dtype, as a float (exact).
template <typename T>
__device__ __forceinline__ float rounded(float v) { return f32(to_storage<T>(v)); }

// Chan's parallel merge of (nb, mb, qb) into (n, m, q): count, mean, M2.
__device__ __forceinline__ void chan_merge(float& n, float& m, float& q, float nb,
                                           float mb, float qb) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - m;
  const float wb = nb / nn;
  m += d * wb;
  q += qb + d * d * n * wb;
  n = nn;
}

// Per (sample, slice, channel) partial statistics of round(y + b).
// part_* are (B, slices, C).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    norm_stats_kernel(const T* __restrict__ y, const float* __restrict__ cbias,
                      float* __restrict__ part_n, float* __restrict__ part_mean,
                      float* __restrict__ part_m2, int HW, int C, int lanes, int rows) {
  __shared__ float s_n[kThreads];
  __shared__ float s_mean[kThreads * N];
  __shared__ float s_m2[kThreads * N];
  const int t = threadIdx.x;
  const int lane = t % lanes, r = t / lanes;
  const int chunk = blockIdx.z * lanes + lane;
  const int b = blockIdx.y, slice = blockIdx.x, slices = gridDim.x;
  const bool active = r < rows && chunk * N < C;
  float n = 0.f, mean[N], m2[N];
#pragma unroll
  for (int v = 0; v < N; ++v) mean[v] = m2[v] = 0.f;
  if (active) {
    float bq[N];
#pragma unroll
    for (int v = 0; v < N; ++v) bq[v] = rounded<T>(cbias[chunk * N + v]);
    const T* base = y + (size_t)b * HW * C + (size_t)chunk * N;
    const int stride = slices * rows;
    for (int p = slice * rows + r; p < HW; p += kUnroll * stride) {
      Chunk<T, N> x[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int q = p + k * stride;
        if (q < HW) x[k] = *reinterpret_cast<const Chunk<T, N>*>(base + (size_t)q * C);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (p + k * stride < HW) {
          n += 1.f;
          const float inv = 1.f / n;
#pragma unroll
          for (int v = 0; v < N; ++v) {
            const float xv = rounded<T>(f32(x[k].v[v]) + bq[v]);
            const float d = xv - mean[v];
            mean[v] += d * inv;
            m2[v] += d * (xv - mean[v]);
          }
        }
      }
    }
  }
  s_n[t] = n;
#pragma unroll
  for (int v = 0; v < N; ++v) {
    s_mean[t * N + v] = mean[v];
    s_m2[t * N + v] = m2[v];
  }
  __syncthreads();
  int half = 1;
  while (half < rows) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (active && r < half && r + half < rows) {
      const int o = t + half * lanes;
      float nn = 0.f;
#pragma unroll
      for (int v = 0; v < N; ++v) {
        nn = n;
        chan_merge(nn, mean[v], m2[v], s_n[o], s_mean[o * N + v], s_m2[o * N + v]);
        s_mean[t * N + v] = mean[v];
        s_m2[t * N + v] = m2[v];
      }
      n = nn;
      s_n[t] = n;
    }
    __syncthreads();
  }
  if (active && r == 0) {
    const size_t at = ((size_t)b * slices + slice) * C + (size_t)chunk * N;
#pragma unroll
    for (int v = 0; v < N; ++v) {
      part_n[at + v] = n;
      part_mean[at + v] = mean[v];
      part_m2[at + v] = m2[v];
    }
  }
}

// Merge the slices' partials of each (sample, channel) and write
// a = scale / sqrt(var + eps) to coef[b, c] and shift = bias - mean * a to
// coef[B + b, c]. Block (32 channels, 8 slice lanes), grid (C / 32, B).
__global__ void __launch_bounds__(256)
    norm_finalize_kernel(const float* __restrict__ part_n,
                         const float* __restrict__ part_mean,
                         const float* __restrict__ part_m2,
                         const float* __restrict__ scale,
                         const float* __restrict__ nbias, float* __restrict__ coef,
                         int slices, int C, float eps) {
  __shared__ float s_n[8][32], s_mean[8][32], s_m2[8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx, b = blockIdx.y, B = gridDim.y;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < C) {
    for (int s = ty; s < slices; s += 8) {
      const size_t at = ((size_t)b * slices + s) * C + c;
      chan_merge(n, mean, m2, part_n[at], part_mean[at], part_m2[at]);
    }
  }
  s_n[ty][tx] = n;
  s_mean[ty][tx] = mean;
  s_m2[ty][tx] = m2;
  __syncthreads();
  for (int half = 4; half > 0; half >>= 1) {
    if (ty < half) {
      chan_merge(n, mean, m2, s_n[ty + half][tx], s_mean[ty + half][tx],
                 s_m2[ty + half][tx]);
      s_n[ty][tx] = n;
      s_mean[ty][tx] = mean;
      s_m2[ty][tx] = m2;
    }
    __syncthreads();
  }
  if (ty == 0 && c < C) {
    const float var = m2 / n;
    const float a = (1.f / sqrtf(var + eps)) * scale[c];
    coef[(size_t)b * C + c] = a;
    coef[((size_t)B + b) * C + c] = nbias[c] - mean * a;
  }
}

// out = [res +] [relu] round(round(y + b) * a + shift), one grid-stride
// pass; each thread keeps its channels' b, a and shift in registers.
template <typename T, int N, bool RES>
__global__ void __launch_bounds__(kThreads)
    norm_apply_kernel(const T* __restrict__ y, const float* __restrict__ cbias,
                      const float* __restrict__ coef, const T* __restrict__ res,
                      T* __restrict__ out, int HW, int C, int lanes, int rows,
                      int relu) {
  const int t = threadIdx.x;
  const int lane = t % lanes, r = t / lanes;
  const int chunk = blockIdx.z * lanes + lane;
  if (r >= rows || chunk * N >= C) return;
  const int b = blockIdx.y, B = gridDim.y;
  const int c0 = chunk * N;
  float bq[N], a[N], sh[N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    bq[v] = rounded<T>(cbias[c0 + v]);
    a[v] = coef[(size_t)b * C + c0 + v];
    sh[v] = coef[((size_t)B + b) * C + c0 + v];
  }
  const size_t base = (size_t)b * HW * C + c0;
  const int stride = gridDim.x * rows;
  for (int p = blockIdx.x * rows + r; p < HW; p += kUnroll * stride) {
    Chunk<T, N> x[kUnroll], rx[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int q = p + k * stride;
      if (q < HW) {
        x[k] = *reinterpret_cast<const Chunk<T, N>*>(y + base + (size_t)q * C);
        if (RES) rx[k] = *reinterpret_cast<const Chunk<T, N>*>(res + base + (size_t)q * C);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int q = p + k * stride;
      if (q < HW) {
        Chunk<T, N> o;
#pragma unroll
        for (int v = 0; v < N; ++v) {
          const float yb = rounded<T>(f32(x[k].v[v]) + bq[v]);
          float h = rounded<T>(fmaf(yb, a[v], sh[v]));
          if (relu && h < 0.f) h = 0.f;
          if (RES) h = rounded<T>(f32(rx[k].v[v]) + h);
          o.v[v] = to_storage<T>(h);
        }
        *reinterpret_cast<Chunk<T, N>*>(out + base + (size_t)q * C) = o;
      }
    }
  }
}

template <typename T, int N>
int run(const T* y, const float* cbias, const float* scale, const float* nbias,
        const T* res, T* out, float* scratch, int B, int HW, int C, int slices,
        int relu, float eps, cudaStream_t s) {
  const int chunks = C / N;
  const int lanes = chunks < kThreads ? chunks : kThreads;
  const int rows = kThreads / lanes;
  const dim3 grid(slices, B, (chunks + lanes - 1) / lanes);
  const size_t parts = (size_t)B * slices * C;
  float* part_n = scratch;
  float* part_mean = part_n + parts;
  float* part_m2 = part_mean + parts;
  float* coef = part_m2 + parts;
  norm_stats_kernel<T, N><<<grid, kThreads, 0, s>>>(y, cbias, part_n, part_mean,
                                                    part_m2, HW, C, lanes, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  norm_finalize_kernel<<<dim3((C + 31) / 32, B), dim3(32, 8), 0, s>>>(
      part_n, part_mean, part_m2, scale, nbias, coef, slices, C, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (res != nullptr)
    norm_apply_kernel<T, N, true><<<grid, kThreads, 0, s>>>(
        y, cbias, coef, res, out, HW, C, lanes, rows, relu);
  else
    norm_apply_kernel<T, N, false><<<grid, kThreads, 0, s>>>(
        y, cbias, coef, res, out, HW, C, lanes, rows, relu);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int dispatch(const void* y, const float* cbias, const float* scale, const float* nbias,
             const void* res, void* out, float* scratch, int B, int HW, int C,
             int slices, int relu, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* yt = static_cast<const T*>(y);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (C % V == 0 && aligned16(y) && aligned16(out) && (res == nullptr || aligned16(res)))
    return run<T, V>(yt, cbias, scale, nbias, rt, ot, scratch, B, HW, C, slices, relu,
                     eps, s);
  return run<T, 1>(yt, cbias, scale, nbias, rt, ot, scratch, B, HW, C, slices, relu,
                   eps, s);
}

}  // namespace

extern "C" {

const char* dvf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y, res (may be null) and out: (B, H*W, C) contiguous, bf16 (bf16 != 0) or
// float32, on the device; cbias (the conv bias), scale and nbias (the
// norm's affine parameters): (C,) float32; scratch: float32 of
// 3 * B * slices * C + 2 * B * C. Three launches on `stream`; returns the
// first nonzero cudaGetLastError() (0 = launched).
int dvf_instance_norm(const void* y, const float* cbias, const float* scale,
                      const float* nbias, const void* res, void* out, float* scratch,
                      int B, int HW, int C, int slices, int bf16, int relu, float eps,
                      void* stream) {
  if (B < 1 || B > 65535 || HW < 1 || C < 1 || slices < 1 || slices > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(y, cbias, scale, nbias, res, out, scratch, B, HW, C,
                                   slices, relu, eps, s);
  return dispatch<float>(y, cbias, scale, nbias, res, out, scratch, B, HW, C, slices,
                         relu, eps, s);
}

}  // extern "C"
