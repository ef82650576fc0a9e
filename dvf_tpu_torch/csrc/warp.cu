// Hand-written Hopper (sm_90a) kernel for the bounded-displacement
// backward warp, with a plain C interface loaded by ctypes
// (dvf_tpu_torch/ops/kernels.py: warp_bounded_pallas). It replaces the
// TPU's Pallas kernel in dvf_tpu/ops/pallas_kernels.py:
//
//   warp_bounded_kernel <- warp_bounded_pallas / _warp_kernel
//
// Function. out(b, y, x, c) = bilinear sample of img(b) at
// (y + clip(fy), x + clip(fx)), flow clipped to [-R, R], the coordinate
// clamped to the frame (border replicate). flow[..., 0] is dx and
// flow[..., 1] is dy.
//
// Design. The TPU kernel sums (2R+2)^2 hat-weighted static shifts of the
// frame because a TPU has no fast gather. Hopper has one, so this is a
// direct gather: one thread per output pixel reads its two flow values,
// forms the clamped coordinate, and reads the four neighbours of each
// channel (from L2/L1: with |flow| <= R the reads of a warp stay within a
// few rows of its own). Neighbouring threads handle neighbouring pixels
// of one row, so the flow reads, the output writes and the centre of the
// gather are coalesced.
//
// Numerics follow the plain version, warp_by_flow(img, clamp(flow, -R, R))
// in dvf_tpu_torch/ops/flow.py, operation for operation: gy + fy is
// rounded to float32 (as the plain version's iota + flow is), the weights
// are ys - floor(ys) and 1 - w, and the lerp runs top/bottom in x, then in
// y. The _rn intrinsics keep nvcc from contracting a multiply and an add
// into one FMA, so each step rounds where the plain version's separate
// tensor operations round, and the kernel reproduces it bit for bit.
//
// Bound on an H100 at the main-path shape (4 x 720 x 1280, C = 3 float32):
// img 44.2 MB in, flow 29.5 MB in, out 44.2 MB: 118 MB, 0.035 ms at
// 3.35 TB/s. About 12 flops per output value (0.13 GFLOP, 0.002 ms at
// 67 TFLOP/s float32): memory-bound. Each input byte is read from device
// memory about once while the gather's rows stay in L2 (a 720p frame row
// is 15 KB; the 2R + 2 rows a block's gather touches fit many times over).

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_C = 8;          // channels a frame may have

template <int C>
__global__ void __launch_bounds__(NTHREADS)
warp_bounded_kernel(const float* __restrict__ img,
                    const float* __restrict__ flow, float* __restrict__ out,
                    int H, int W, long long n_pix, float R) {
  const long long p = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (p >= n_pix) return;
  const long long hw = (long long)H * W;
  const long long b = p / hw;
  const int rem = (int)(p - b * hw);
  const int y = rem / W;
  const int x = rem - y * W;
  const float2 f = reinterpret_cast<const float2*>(flow)[p];
  const float fx = fminf(fmaxf(f.x, -R), R);
  const float fy = fminf(fmaxf(f.y, -R), R);
  const float ys = fminf(fmaxf(__fadd_rn((float)y, fy), 0.0f), (float)(H - 1));
  const float xs = fminf(fmaxf(__fadd_rn((float)x, fx), 0.0f), (float)(W - 1));
  const float y0 = floorf(ys), x0 = floorf(xs);
  const float wy = __fsub_rn(ys, y0), wx = __fsub_rn(xs, x0);
  const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
  const int y0i = (int)y0, x0i = (int)x0;
  const int y1i = min(y0i + 1, H - 1), x1i = min(x0i + 1, W - 1);
  const float* frame = img + b * hw * C;
  const float* r0 = frame + (long long)y0i * W * C;
  const float* r1 = frame + (long long)y1i * W * C;
  const float* v00 = r0 + x0i * C;
  const float* v01 = r0 + x1i * C;
  const float* v10 = r1 + x0i * C;
  const float* v11 = r1 + x1i * C;
  float* dst = out + p * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float top = __fadd_rn(__fmul_rn(__ldg(v00 + c), owx),
                                __fmul_rn(__ldg(v01 + c), wx));
    const float bot = __fadd_rn(__fmul_rn(__ldg(v10 + c), owx),
                                __fmul_rn(__ldg(v11 + c), wx));
    dst[c] = __fadd_rn(__fmul_rn(top, owy), __fmul_rn(bot, wy));
  }
}

template <int C>
void launch(const float* img, const float* flow, float* out, int H, int W,
            long long n_pix, float R, cudaStream_t s) {
  const long long blocks = (n_pix + NTHREADS - 1) / NTHREADS;
  warp_bounded_kernel<C><<<(unsigned)blocks, NTHREADS, 0, s>>>(
      img, flow, out, H, W, n_pix, R);
}

}  // namespace

extern "C" {

const char* dvf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() right after the
// launch (0 = launched). img and out are (B, H, W, C), flow (B, H, W, 2),
// all contiguous float32 on the device.
int dvf_warp_bounded(const float* img, const float* flow, float* out, int B,
                     int H, int W, int C, int max_disp, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || C > MAX_C || max_disp < 1)
    return cudaErrorInvalidValue;
  const long long n_pix = (long long)B * H * W;
  if ((n_pix + NTHREADS - 1) / NTHREADS > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const float R = (float)max_disp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch<1>(img, flow, out, H, W, n_pix, R, s); break;
    case 2: launch<2>(img, flow, out, H, W, n_pix, R, s); break;
    case 3: launch<3>(img, flow, out, H, W, n_pix, R, s); break;
    case 4: launch<4>(img, flow, out, H, W, n_pix, R, s); break;
    case 5: launch<5>(img, flow, out, H, W, n_pix, R, s); break;
    case 6: launch<6>(img, flow, out, H, W, n_pix, R, s); break;
    case 7: launch<7>(img, flow, out, H, W, n_pix, R, s); break;
    case 8: launch<8>(img, flow, out, H, W, n_pix, R, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
