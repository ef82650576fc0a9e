// Hand-written Hopper (sm_90a) kernels for the three stencil filters on
// the single-stream main path, with a plain C interface loaded by ctypes
// (dvf_tpu_torch/ops/kernels.py). They replace the TPU's Pallas kernels
// in dvf_tpu/ops/pallas_kernels.py:
//
//   sep_blur_kernel        <- sep_blur_nhwc_pallas / _sep_blur_kernel
//   bilateral_kernel       <- bilateral_nhwc_pallas / _bilateral_kernel
//   sobel_bilateral_kernel <- sobel_bilateral_nhwc_pallas / _sobel_bilateral_kernel
//
// Shared design. Frames are float32 NHWC in [0, 1]. One thread computes
// one output pixel (all its channels); a 32x8 block covers a 32x8 output
// tile of one frame, and the grid is (W tiles, H tiles, batch). Blocks are
// independent. Each block copies its tile plus halo into shared memory
// with neighbouring threads on neighbouring addresses (a tile row is
// (32 + 2r) * C contiguous floats of the frame row), computing reflect-101
// source indices on the fly, so no padded copy of the frame is ever
// written to device memory. Output pixels outside the frame (the ragged
// last tile) are computed from clamped indices and not stored.
//
// Numerics. Float32 accumulation in the tap order of the plain versions
// (dvf_tpu_torch/ops/conv.py, bilateral.py, chains.py). expf (not
// __expf), IEEE division and sqrt: build without --use_fast_math. nvcc's
// default FMA contraction moves results by a few ulp, inside the 1e-5 bar
// these three kernels are held to.
//
// Bounds on an H100 at the main-path shape (16 x 1080 x 1920 x 3 float32,
// 398 MB in, 398 MB out; 3.35 TB/s, 67 TFLOP/s float32):
//   sep_blur (k=9): 36 flops per output element, 3.6 GFLOP -> 0.05 ms of
//     arithmetic against 0.24 ms of bytes: memory-bound. The H pass lands
//     in shared memory and the W pass reads it there, so the intermediate
//     never reaches device memory; the halo rows (8 of every 16 loaded
//     rows at k=9) are re-read by the neighbouring tile, mostly from L2.
//   bilateral (d=5): 25 expf per pixel plus ~18 flops per tap, ~15 GFLOP;
//     expf runs on the special-function units at 1/8 of the FMA rate, so
//     the kernel is bound by exp/FP32 issue, not bytes. The whole window
//     is read from shared memory; nothing but the output is written.
//   sobel_bilateral (d=5): the gray image and the Sobel magnitude live
//     only in shared memory; the bilateral runs on one channel (colour
//     distance of a gray image broadcast to C channels is C * delta^2, the
//     C folded into inv2sc by the caller), so it issues a third of the
//     3-channel bilateral's range arithmetic with the same 25 expf per
//     pixel.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int TW = 32;            // output tile width  == blockDim.x
constexpr int TH = 8;             // output tile height == blockDim.y
constexpr int NTHREADS = TW * TH;
constexpr int MAX_TAPS = 31;      // sep_blur: longest 1-D tap vector
constexpr int MAX_WIN = 15;       // bilateral: longest window side d
constexpr int MAX_C = 4;          // channels a frame may have

struct SepTaps {
  float kh[MAX_TAPS];
  float kw[MAX_TAPS];
};

struct Window {
  float w[MAX_WIN * MAX_WIN];     // spatial weights, row-major (dy, dx)
};

// Reflect-101 (cv2 BORDER_REFLECT_101, F.pad mode="reflect") for an
// overhang smaller than n; positions further out only feed outputs that
// lie outside the frame, and are clamped to stay in bounds.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ int thread_id() {
  return threadIdx.y * TW + threadIdx.x;
}

// Copy rows [y0 - ry, y0 + TH + ry) x cols [x0 - rx, x0 + TW + rx) of one
// NHWC frame, all C channels, into s laid out [row][col][c].
template <int C>
__device__ void load_tile(const float* __restrict__ img, float* s, int H,
                          int W, int y0, int x0, int ry, int rx) {
  const int row_elems = (TW + 2 * rx) * C;
  const int n = (TH + 2 * ry) * row_elems;
  for (int i = thread_id(); i < n; i += NTHREADS) {
    const int row = i / row_elems;
    const int rem = i - row * row_elems;
    const int col = rem / C;
    const int c = rem - col * C;
    const int gy = reflect101(y0 - ry + row, H);
    const int gx = reflect101(x0 - rx + col, W);
    s[i] = img[((size_t)gy * W + gx) * C + c];
  }
}

// Replaces dvf_tpu/ops/pallas_kernels.py:_sep_blur_kernel. Memory-bound:
// one read of the tile (+ halo) and one write of the output per block; the
// H-blurred rows stay in shared memory for the W pass.
template <int C>
__global__ void __launch_bounds__(NTHREADS)
sep_blur_kernel(const float* __restrict__ x, float* __restrict__ y, int H,
                int W, int kh_len, int kw_len, SepTaps taps) {
  extern __shared__ float smem[];
  __shared__ float kh[MAX_TAPS], kw[MAX_TAPS];
  const int rh = kh_len / 2, rw = kw_len / 2;
  const int row_elems = (TW + 2 * rw) * C;
  float* tile = smem;                              // (TH + 2rh) rows
  float* acc = smem + (TH + 2 * rh) * row_elems;   // TH rows, H-blurred
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = thread_id();
  if (tid < kh_len) kh[tid] = taps.kh[tid];
  if (tid < kw_len) kw[tid] = taps.kw[tid];
  load_tile<C>(x + (size_t)b * H * W * C, tile, H, W, y0, x0, rh, rw);
  __syncthreads();
  // H pass over the tile's TH rows, keeping the W halo.
  for (int i = tid; i < TH * row_elems; i += NTHREADS) {
    const float* src = tile + i;  // row r of acc reads tile rows r..r+2rh
    float a = kh[0] * src[0];
    for (int t = 1; t < kh_len; ++t) a = a + kh[t] * src[t * row_elems];
    acc[i] = a;
  }
  __syncthreads();
  const int ox = x0 + threadIdx.x, oy = y0 + threadIdx.y;
  if (ox >= W || oy >= H) return;
  const float* src = acc + threadIdx.y * row_elems + threadIdx.x * C;
  float* dst = y + (((size_t)b * H + oy) * W + ox) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float o = kw[0] * src[c];
    for (int t = 1; t < kw_len; ++t) o = o + kw[t] * src[t * C + c];
    dst[c] = o;
  }
}

// Replaces dvf_tpu/ops/pallas_kernels.py:_bilateral_kernel. Bound by the
// d*d expf and range arithmetic per pixel: every tap is read from shared
// memory, the accumulators live in registers (C is a template argument).
template <int C>
__global__ void __launch_bounds__(NTHREADS)
bilateral_kernel(const float* __restrict__ x, float* __restrict__ y, int H,
                 int W, int r, float inv2sc, Window win) {
  extern __shared__ float tile[];                  // (TH+2r) x (TW+2r) x C
  __shared__ float sw[MAX_WIN * MAX_WIN];
  const int d = 2 * r + 1;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  for (int i = thread_id(); i < d * d; i += NTHREADS) sw[i] = win.w[i];
  load_tile<C>(x + (size_t)b * H * W * C, tile, H, W, y0, x0, r, r);
  __syncthreads();
  const int ox = x0 + threadIdx.x, oy = y0 + threadIdx.y;
  if (ox >= W || oy >= H) return;
  const int row_elems = (TW + 2 * r) * C;
  const float* ctr = tile + (threadIdx.y + r) * row_elems + (threadIdx.x + r) * C;
  float cv[C], num[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    cv[c] = ctr[c];
    num[c] = 0.0f;
  }
  float den = 0.0f;
  for (int dy = 0; dy < d; ++dy) {
    const float* p = tile + (threadIdx.y + dy) * row_elems + threadIdx.x * C;
    for (int dx = 0; dx < d; ++dx, p += C) {
      float diff = p[0] - cv[0];
      float dist2 = diff * diff;
#pragma unroll
      for (int c = 1; c < C; ++c) {
        diff = p[c] - cv[c];
        dist2 = dist2 + diff * diff;
      }
      const float wgt = sw[dy * d + dx] * expf(-dist2 * inv2sc);
#pragma unroll
      for (int c = 0; c < C; ++c) num[c] = num[c] + wgt * p[c];
      den = den + wgt;
    }
  }
  float* dst = y + (((size_t)b * H + oy) * W + ox) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) dst[c] = num[c] / den;
}

// Replaces dvf_tpu/ops/pallas_kernels.py:_sobel_bilateral_kernel. Reads
// the frame once and writes it once; gray and the edge map exist only in
// shared memory, and the bilateral is single-channel.
__global__ void __launch_bounds__(NTHREADS)
sobel_bilateral_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int H, int W, int C, int r, float inv2sc, float scale,
                       Window win) {
  extern __shared__ float smem[];
  __shared__ float sw[MAX_WIN * MAX_WIN];
  const int d = 2 * r + 1;
  const int R = r + 1;                             // + Sobel support
  const int gw = TW + 2 * R, gh = TH + 2 * R;      // gray tile
  const int mw = TW + 2 * r, mh = TH + 2 * r;      // magnitude tile
  float* gray = smem;
  float* mag = smem + gh * gw;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = thread_id();
  for (int i = tid; i < d * d; i += NTHREADS) sw[i] = win.w[i];
  // Rec.601 gray of the reflect-101 halo'd tile (R rows/cols each side).
  const float* img = x + (size_t)b * H * W * C;
  for (int i = tid; i < gh * gw; i += NTHREADS) {
    const int row = i / gw, col = i - row * gw;
    const float* p = img + ((size_t)reflect101(y0 - R + row, H) * W
                            + reflect101(x0 - R + col, W)) * C;
    gray[i] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
  }
  __syncthreads();
  // Sobel magnitude on the (TH+2r) x (TW+2r) region. Magnitude commutes
  // with reflect-101 (the derivative flips sign under reflection, |.|
  // restores it), so computing it inside the reflected halo reproduces
  // the unfused chain's borders.
  for (int i = tid; i < mh * mw; i += NTHREADS) {
    const int row = i / mw, col = i - row * mw;
    const float* g = gray + row * gw + col;        // 3x3 neighbourhood
    const float sx0 = g[0] + 2.0f * g[gw] + g[2 * gw];
    const float sx2 = g[2] + 2.0f * g[gw + 2] + g[2 * gw + 2];
    const float sy0 = g[0] + 2.0f * g[1] + g[2];
    const float sy2 = g[2 * gw] + 2.0f * g[2 * gw + 1] + g[2 * gw + 2];
    const float gx = sx2 - sx0, gy = sy2 - sy0;
    const float m = sqrtf(gx * gx + gy * gy) * scale;
    mag[i] = fminf(fmaxf(m, 0.0f), 1.0f);
  }
  __syncthreads();
  const int ox = x0 + threadIdx.x, oy = y0 + threadIdx.y;
  if (ox >= W || oy >= H) return;
  const float cv = mag[(threadIdx.y + r) * mw + threadIdx.x + r];
  float num = 0.0f, den = 0.0f;
  for (int dy = 0; dy < d; ++dy) {
    const float* p = mag + (threadIdx.y + dy) * mw + threadIdx.x;
    for (int dx = 0; dx < d; ++dx) {
      const float diff = p[dx] - cv;
      const float wgt = sw[dy * d + dx] * expf(-(diff * diff) * inv2sc);
      num = num + wgt * p[dx];
      den = den + wgt;
    }
  }
  const float res = num / den;
  float* dst = y + (((size_t)b * H + oy) * W + ox) * C;
  for (int c = 0; c < C; ++c) dst[c] = res;
}

dim3 grid_for(int B, int H, int W) {
  return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B);
}

}  // namespace

extern "C" {

const char* dvf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// right after the launch (0 = launched). Host-side arrays (taps, spatial
// weights) are copied into the kernel's by-value arguments.

int dvf_sep_blur(const float* x, float* y, int B, int H, int W, int C,
                 const float* kh, int kh_len, const float* kw, int kw_len,
                 void* stream) {
  if (C < 1 || C > MAX_C || kh_len < 1 || kh_len > MAX_TAPS || kw_len < 1 ||
      kw_len > MAX_TAPS)
    return cudaErrorInvalidValue;
  SepTaps taps;
  memset(&taps, 0, sizeof(taps));
  memcpy(taps.kh, kh, kh_len * sizeof(float));
  memcpy(taps.kw, kw, kw_len * sizeof(float));
  const int rh = kh_len / 2, rw = kw_len / 2;
  const size_t smem = (size_t)(2 * TH + 2 * rh) * (TW + 2 * rw) * C * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(B, H, W), block(TW, TH);
  switch (C) {
    case 1: sep_blur_kernel<1><<<grid, block, smem, s>>>(x, y, H, W, kh_len, kw_len, taps); break;
    case 2: sep_blur_kernel<2><<<grid, block, smem, s>>>(x, y, H, W, kh_len, kw_len, taps); break;
    case 3: sep_blur_kernel<3><<<grid, block, smem, s>>>(x, y, H, W, kh_len, kw_len, taps); break;
    case 4: sep_blur_kernel<4><<<grid, block, smem, s>>>(x, y, H, W, kh_len, kw_len, taps); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int dvf_bilateral(const float* x, float* y, int B, int H, int W, int C, int r,
                  const float* spatial, float inv2sc, void* stream) {
  const int d = 2 * r + 1;
  if (C < 1 || C > MAX_C || r < 0 || d > MAX_WIN) return cudaErrorInvalidValue;
  Window win;
  memset(&win, 0, sizeof(win));
  memcpy(win.w, spatial, d * d * sizeof(float));
  const size_t smem = (size_t)(TH + 2 * r) * (TW + 2 * r) * C * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(B, H, W), block(TW, TH);
  switch (C) {
    case 1: bilateral_kernel<1><<<grid, block, smem, s>>>(x, y, H, W, r, inv2sc, win); break;
    case 2: bilateral_kernel<2><<<grid, block, smem, s>>>(x, y, H, W, r, inv2sc, win); break;
    case 3: bilateral_kernel<3><<<grid, block, smem, s>>>(x, y, H, W, r, inv2sc, win); break;
    case 4: bilateral_kernel<4><<<grid, block, smem, s>>>(x, y, H, W, r, inv2sc, win); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int dvf_sobel_bilateral(const float* x, float* y, int B, int H, int W, int C,
                        int r, const float* spatial, float inv2sc,
                        float scale, void* stream) {
  const int d = 2 * r + 1;
  if (C < 3 || C > MAX_C || r < 0 || d > MAX_WIN) return cudaErrorInvalidValue;
  Window win;
  memset(&win, 0, sizeof(win));
  memcpy(win.w, spatial, d * d * sizeof(float));
  const int R = r + 1;
  const size_t smem = ((size_t)(TH + 2 * R) * (TW + 2 * R)
                       + (size_t)(TH + 2 * r) * (TW + 2 * r)) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sobel_bilateral_kernel<<<grid_for(B, H, W), dim3(TW, TH), smem, s>>>(
      x, y, H, W, C, r, inv2sc, scale, win);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
