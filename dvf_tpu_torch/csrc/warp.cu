// Hand-written Hopper (sm_90a) kernels for the bounded-displacement
// backward warp, with a plain C interface loaded by ctypes
// (dvf_tpu_torch/ops/kernels.py: warp_bounded_pallas). They replace the
// TPU's Pallas kernel in dvf_tpu/ops/pallas_kernels.py:
//
//   warp_window_kernel, warp_gather_kernel <- warp_bounded_pallas / _warp_kernel
//
// Function. out(b, y, x, c) = bilinear sample of img(b) at
// (y + clip(fy), x + clip(fx)), flow clipped to [-R, R], the coordinate
// clamped to the frame (border replicate). flow[..., 0] is dx and
// flow[..., 1] is dy.
//
// The TPU kernel sums (2R+2)^2 hat-weighted static shifts of the frame
// because a TPU has no fast gather. Hopper gathers, so both designs here
// sample directly; they differ in where the gather reads from:
// - warp_window_kernel: a block's output tile is 16 rows x 64 pixels. With
//   |flow| <= R and the coordinate clamp, every corner it samples lies in
//   rows y0 - R .. y0 + 16 + R and columns x0 - R .. x0 + 64 + R, clamped
//   to the frame. That window is copied to shared memory with cp.async
//   (16-byte copies where global and shared addresses are aligned, 4-byte
//   copies at the row ends) while the threads read their flow, and the
//   gathers become shared-memory loads. At R = 4 a block reads 1.78x its
//   tile from L2 (R = 2: 1.41x) and each byte about once from device
//   memory. The outputs are staged back through the same shared memory
//   and stored as 16-byte row chunks where aligned. Taken while the window
//   fits the 48 KB of shared memory a block gets without opt-in (C <= 6 at
//   R = 4) and its grid has two blocks for every SM.
// - warp_gather_kernel: one pixel per thread, 32 x 8 pixel tiles (lanes on
//   neighbouring pixels, so flow loads and stores coalesce), the corners
//   read from global memory through L1. Any R and C. On frames too small
//   to give every SM two window blocks (the inner warp's coarser pyramid
//   levels, 4 x 180 x 320 and 4 x 90 x 160, make 240 and 72 on 132 SMs),
//   a block's load -> sample -> store chain is exposed and the most
//   threads in flight wins (measured by chip_smoke.py at both levels).
// Both use a 2-D grid (column tiles, row tiles, frames), so no index
// needs an integer division.
//
// Numerics follow the plain version, warp_by_flow(img, clamp(flow, -R, R))
// in dvf_tpu_torch/ops/flow.py, operation for operation: gy + fy is
// rounded to float32 (as the plain version's iota + flow is), the weights
// are ys - floor(ys) and 1 - w, and the lerp runs top/bottom in x, then in
// y. The _rn intrinsics keep nvcc from contracting a multiply and an add
// into one FMA, so each step rounds where the plain version's separate
// tensor operations round, and the kernels reproduce it bit for bit.
//
// Bound on an H100 (3.35 TB/s; about 12 flops per output value, far below
// 67 TFLOP/s float32): bytes. Final warp 4 x 720 x 1280, C = 3: img 44.2
// MB + flow 29.5 MB in, out 44.2 MB, 0.0352 ms. Inner warp 4 x 360 x 640,
// C = 5: 44.2 MB, 0.0132 ms, which the 50 MB L2 can hold when the inputs
// were just written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 8;          // channels a frame may have
constexpr int MAX_GRID_Z = 65535; // frames per launch (gridDim.z)
constexpr size_t DEFAULT_SMEM = 48 * 1024;

// The plain version's sample of one pixel: `at(yi, xi)` points at channel
// 0 of source pixel (yi, xi); o receives the C outputs.
template <int C, typename At>
__device__ __forceinline__ void sample(float2 f, int x, int y, int H, int W,
                                       float R, At at, float* o) {
  const float fx = fminf(fmaxf(f.x, -R), R);
  const float fy = fminf(fmaxf(f.y, -R), R);
  const float ys = fminf(fmaxf(__fadd_rn((float)y, fy), 0.0f), (float)(H - 1));
  const float xs = fminf(fmaxf(__fadd_rn((float)x, fx), 0.0f), (float)(W - 1));
  const float y0 = floorf(ys), x0 = floorf(xs);
  const float wy = __fsub_rn(ys, y0), wx = __fsub_rn(xs, x0);
  const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
  const int y0i = (int)y0, x0i = (int)x0;
  const int y1i = min(y0i + 1, H - 1), x1i = min(x0i + 1, W - 1);
  const float* v00 = at(y0i, x0i);
  const float* v01 = at(y0i, x1i);
  const float* v10 = at(y1i, x0i);
  const float* v11 = at(y1i, x1i);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float top = __fadd_rn(__fmul_rn(v00[c], owx), __fmul_rn(v01[c], wx));
    const float bot = __fadd_rn(__fmul_rn(v10[c], owx), __fmul_rn(v11[c], wx));
    o[c] = __fadd_rn(__fmul_rn(top, owy), __fmul_rn(bot, wy));
  }
}

// ---------------------------------------------------------------------------
// warp_window_kernel
// ---------------------------------------------------------------------------

constexpr int WIN_TX = 64;        // output tile width, pixels: 2 per lane
constexpr int WIN_TY = 16;        // output tile rows: 2 per warp of 8

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Where float k of a global row segment starting at `g` goes in a shared
// row: at a + k with a = (g / 4 bytes) mod 4, so that a 16-byte aligned
// chunk of the segment lands on a 16-byte aligned shared address.
__device__ __forceinline__ int misalign(const float* g) {
  return (int)((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// Shared-memory row stride (floats, a multiple of 4) of the window.
__host__ __device__ constexpr int window_stride(int C, int R) {
  return (3 + (WIN_TX + 2 * R + 1) * C + 3) / 4 * 4;
}

// Thread (tx, ty) computes pixels x0 + 2tx, x0 + 2tx + 1 of rows y0 + ty
// and y0 + ty + 8.
template <int C>
__global__ void __launch_bounds__(256)
warp_window_kernel(const float* __restrict__ img, const float* __restrict__ flow,
                   float* __restrict__ out, int H, int W, int R) {
  extern __shared__ __align__(16) float win[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.z, y0 = blockIdx.y * WIN_TY, x0 = blockIdx.x * WIN_TX;
  const int S = window_stride(C, R);
  const int wy0 = max(0, y0 - R), wy1 = min(H - 1, y0 + WIN_TY + R);
  const int wx0 = max(0, x0 - R), wx1 = min(W - 1, x0 + WIN_TX + R);
  const int span = (wx1 - wx0 + 1) * C;
  const float* frame = img + (size_t)b * H * W * C;
  // 1. the window, row by row: lane tx takes the 16-byte slots tx, tx + 32, ...
  for (int row = ty; row <= wy1 - wy0; row += 8) {
    const float* src = frame + ((size_t)(wy0 + row) * W + wx0) * C;
    const int a = misalign(src);
    float* dst = win + row * S;
    const int slots = (a + span + 3) >> 2;
    for (int sl = tx; sl < slots; sl += 32) {
      const int lo = max(0, 4 * sl - a), hi = min(span, 4 * sl - a + 4);
      if (hi - lo == 4) {
        cp_async16(dst + 4 * sl, src + lo);
      } else {
        for (int k = lo; k < hi; ++k) cp_async4(dst + a + k, src + k);
      }
    }
  }
  // 2. the flow of the thread's pixels, while the copies are in flight
  float2 f[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int y = min(y0 + ty + 8 * i, H - 1), x = x0 + 2 * tx;
    const float* fl = flow + (((size_t)b * H + y) * W + min(x, W - 1)) * 2;
    if (x + 1 < W && (reinterpret_cast<uintptr_t>(fl) & 15) == 0) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(fl));
      f[i][0] = make_float2(v.x, v.y);
      f[i][1] = make_float2(v.z, v.w);
    } else {
      f[i][0] = __ldg(reinterpret_cast<const float2*>(fl));
      f[i][1] = x + 1 < W ? __ldg(reinterpret_cast<const float2*>(fl) + 1) : f[i][0];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // 3. sample from the window
  const float* base = frame + (size_t)wx0 * C;
  auto at = [&](int yi, int xi) {
    const int row = yi - wy0;
    return win + row * S + misalign(base + (size_t)yi * W * C) + (xi - wx0) * C;
  };
  float o[2][2][C];
  const float Rf = (float)R;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      sample<C>(f[i][p], min(x0 + 2 * tx + p, W - 1), min(y0 + ty + 8 * i, H - 1),
                H, W, Rf, at, o[i][p]);
  __syncthreads();
  // 4. stage the tile in the window's memory (output row i at i * S, its
  // floats placed like the window's), then store each row in 16-byte
  // chunks where aligned.
  const int rows = min(WIN_TY, H - y0);
  const int ospan = min(WIN_TX, W - x0) * C;
  float* orow0 = out + (((size_t)b * H + y0) * W + x0) * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ri = ty + 8 * i;
    if (ri >= rows) continue;
    float* srow = win + ri * S + misalign(orow0 + (size_t)ri * W * C);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int px = 2 * tx + p;
      if (px * C >= ospan) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) srow[px * C + c] = o[i][p][c];
    }
  }
  __syncthreads();
  for (int ri = ty; ri < rows; ri += 8) {
    float* dst = orow0 + (size_t)ri * W * C;
    const int a = misalign(dst);
    const float* srow = win + ri * S;
    const int slots = (a + ospan + 3) >> 2;
    for (int sl = tx; sl < slots; sl += 32) {
      const int lo = max(0, 4 * sl - a), hi = min(ospan, 4 * sl - a + 4);
      if (hi - lo == 4) {
        *reinterpret_cast<float4*>(dst + lo) =
            *reinterpret_cast<const float4*>(srow + 4 * sl);
      } else {
        for (int k = lo; k < hi; ++k) dst[k] = srow[a + k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// warp_gather_kernel
// ---------------------------------------------------------------------------

constexpr int G_TX = 32;          // tile width == blockDim.x
constexpr int G_TY = 8;           // tile rows == blockDim.y

template <int C>
__global__ void __launch_bounds__(256)
warp_gather_kernel(const float* __restrict__ img, const float* __restrict__ flow,
                   float* __restrict__ out, int H, int W, int R) {
  const int y = blockIdx.y * G_TY + threadIdx.y;
  const int x = blockIdx.x * G_TX + threadIdx.x;
  if (y >= H || x >= W) return;
  const int b = blockIdx.z;
  const size_t p = ((size_t)b * H + y) * W + x;
  const float* frame = img + (size_t)b * H * W * C;
  auto at = [&](int yi, int xi) { return frame + (yi * W + xi) * C; };
  float o[C];
  sample<C>(__ldg(reinterpret_cast<const float2*>(flow) + p), x, y, H, W,
            (float)R, at, o);
  float* dst = out + p * C;
#pragma unroll
  for (int c = 0; c < C; ++c) dst[c] = o[c];
}

// Shared memory the window design needs, bytes.
size_t window_smem(int C, int R) {
  return (size_t)(WIN_TY + 2 * R + 1) * window_stride(C, R) * sizeof(float);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// design: 0 the window where it fits 48 KB and its grid has two blocks
// per SM, else the gather; 1 the window (refused where it does not fit);
// 2 the gather.
template <int C>
int launch(const float* img, const float* flow, float* out, int B, int H, int W,
           int R, int design, cudaStream_t s) {
  const size_t smem = window_smem(C, R);
  if (design == 1 && smem > DEFAULT_SMEM) return cudaErrorInvalidValue;
  const long long window_blocks =
      (long long)((W + WIN_TX - 1) / WIN_TX) * ((H + WIN_TY - 1) / WIN_TY) * B;
  const bool gather = design == 2 ||
      (design == 0 && (smem > DEFAULT_SMEM || window_blocks < 2 * sm_count()));
  const size_t frame = (size_t)H * W;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Z) {
    const int nb = min(B - b0, MAX_GRID_Z);
    const float* im = img + b0 * frame * C;
    const float* fl = flow + b0 * frame * 2;
    float* o = out + b0 * frame * C;
    if (gather) {
      const dim3 grid((W + G_TX - 1) / G_TX, (H + G_TY - 1) / G_TY, nb);
      warp_gather_kernel<C><<<grid, dim3(32, G_TY), 0, s>>>(im, fl, o, H, W, R);
    } else {
      const dim3 grid((W + WIN_TX - 1) / WIN_TX, (H + WIN_TY - 1) / WIN_TY, nb);
      warp_window_kernel<C><<<grid, dim3(32, 8), smem, s>>>(im, fl, o, H, W, R);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

const char* dvf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() right after the
// launch (0 = launched). img and out are (B, H, W, C), flow (B, H, W, 2),
// all contiguous float32 on the device; flow 8-byte aligned. design: as
// launch() above.
int dvf_warp_bounded(const float* img, const float* flow, float* out, int B,
                     int H, int W, int C, int max_disp, int design, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || C > MAX_C || max_disp < 1 ||
      design < 0 || design > 2 || (long long)H * W * MAX_C >= (1LL << 31) ||
      (H + G_TY - 1) / G_TY > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(img, flow, out, B, H, W, max_disp, design, s);
    case 2: return launch<2>(img, flow, out, B, H, W, max_disp, design, s);
    case 3: return launch<3>(img, flow, out, B, H, W, max_disp, design, s);
    case 4: return launch<4>(img, flow, out, B, H, W, max_disp, design, s);
    case 5: return launch<5>(img, flow, out, B, H, W, max_disp, design, s);
    case 6: return launch<6>(img, flow, out, B, H, W, max_disp, design, s);
    case 7: return launch<7>(img, flow, out, B, H, W, max_disp, design, s);
    case 8: return launch<8>(img, flow, out, B, H, W, max_disp, design, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
