// Hand-written Hopper (sm_90a) kernels for the three stencil filters on
// the single-stream main path, with a plain C interface loaded by ctypes
// (dvf_tpu_torch/ops/kernels.py). They replace the TPU's Pallas kernels
// in dvf_tpu/ops/pallas_kernels.py:
//
//   sep_blur_kernel        <- sep_blur_nhwc_pallas / _sep_blur_kernel
//   bilateral_kernel       <- bilateral_nhwc_pallas / _bilateral_kernel
//   sobel_bilateral_kernel <- sobel_bilateral_nhwc_pallas / _sobel_bilateral_kernel
//
// Frames are float32 NHWC in [0, 1]. Blocks are independent; the grid is
// (W tiles, H tiles, batch). Each block reads its tile plus halo straight
// from the NHWC frame, computing reflect-101 source indices in the load,
// so no padded copy of the frame is ever written to device memory. Output
// pixels outside the frame (the ragged last tile) are computed from
// clamped indices and not stored.
//
// Each kernel is specialised at compile time for the sizes the main path
// and the tests use (sep_blur: taps (9,9), (3,9), (5,1); bilateral and
// sobel_bilateral: radii 1, 2, 3), fully unrolled with the taps / log
// weights as kernel-parameter constants; every other size up to MAX_TAPS
// / MAX_WIN runs the same kernel with the size as a runtime argument
// (template argument 0). The wrapper picks the instantiation
// (ops/kernels.py: sep_blur_instance, bilateral_instance,
// sobel_bilateral_instance) and passes it here; an instantiation that was
// not compiled is refused (cudaErrorInvalidValue), never substituted.
//
// Numerics. Float32 accumulation in the tap order of the plain versions
// (dvf_tpu_torch/ops/conv.py, bilateral.py, chains.py). IEEE division and
// sqrt: build without --use_fast_math. nvcc's default FMA contraction
// moves results by a few ulp, inside the 1e-5 bar these three kernels
// are held to. The bilateral range weights are one explicit ex2.approx
// each (see bilateral_kernel's note).
//
// Bounds on an H100 at the main-path shape (16 x 1080 x 1920 x 3 float32,
// 398 MB in, 398 MB out; 3.35 TB/s, 67 TFLOP/s float32): 0.2377 ms of
// bytes for each kernel; see each kernel's note for what bounds its
// instructions.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int MAX_TAPS = 31;      // sep_blur: longest 1-D tap vector
constexpr int MAX_WIN = 15;       // bilateral: longest window side d
constexpr int MAX_C = 4;          // channels a frame may have
constexpr size_t DEFAULT_SMEM = 48 * 1024;  // dynamic smem without opt-in

struct SepTaps {
  float kh[MAX_TAPS];
  float kw[MAX_TAPS];
};

struct Window {
  float w[MAX_WIN * MAX_WIN];     // per-tap weights, row-major (dy, dx)
};

// Reflect-101 (cv2 BORDER_REFLECT_101, F.pad mode="reflect") for an
// overhang smaller than n; positions further out only feed outputs that
// lie outside the frame, and are clamped to stay in bounds.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

// ---------------------------------------------------------------------------
// sep_blur (K1)
// ---------------------------------------------------------------------------

constexpr int BLUR_TW = 64;       // output tile width, pixels
constexpr int BLUR_TH = 64;       // output tile height, rows
// One thread per float of a tile row including its W halo, rounded up to
// whole warps: (64 + 30) * 4 = 376 -> 384 at MAX_TAPS and MAX_C.
constexpr int BLUR_MAX_THREADS = 384;

// Replaces dvf_tpu/ops/pallas_kernels.py:_sep_blur_kernel.
//
// Bound: bytes (0.2377 ms at the main-path shape; 2 * (kh + kw) flops per
// output float need 0.05 ms). What keeps it off that bound is issue
// slots, so the design spends few per output float (~21 in the H pass at
// k = 9, by cuobjdump -sass):
// - a 64x64 output tile: a block reads (64 + 2rh) x (64 + 2rw) pixels for
//   4096 outputs, 1.27x at k = 9 (the first design read 2.5x);
// - H pass (down the columns) in registers: thread e owns one float of a
//   tile row (pixel e / C, C a constant, so no division), computes its
//   reflect-101 column once, and walks down BLUR_TH + 2rh rows with one
//   coalesced load per row (a warp reads 128 contiguous bytes), keeping a
//   rolling window of KH rows; the row index is reflected once per row;
// - the H-blurred tile lands in shared memory (BLUR_TH x (64 + 2rw) x C
//   floats; 55 KB at k = 9, C = 3, so the launch opts in to more than
//   48 KB); the W pass reads it with neighbouring threads on neighbouring
//   words (conflict-free) and writes the output coalesced;
// - KH, KW compile-time: both tap loops unroll and the taps are constant
//   operands of the FFMAs.
// Tap order is the plain version's: H pass from kh[0], then W pass from
// kw[0]. Loads are 4-byte: at one load per ~1.4 output floats they are
// not what the instruction budget goes to (the FFMAs and the W pass's
// shared-memory reads are), so the kernel needs no 16-byte alignment.
template <int C, int KH, int KW>  // KH = KW = 0: tap counts at run time
__global__ void __launch_bounds__(BLUR_MAX_THREADS)
sep_blur_kernel(const float* __restrict__ x, float* __restrict__ y, int H,
                int W, int kh_len, int kw_len, SepTaps taps) {
  static_assert((KH == 0) == (KW == 0), "fixed taps come in pairs");
  extern __shared__ float mid[];                   // BLUR_TH rows x E floats
  __shared__ float skh[KH ? 1 : MAX_TAPS], skw[KW ? 1 : MAX_TAPS];
  const int kh = KH ? KH : kh_len, kw = KW ? KW : kw_len;
  const int rh = kh / 2, rw = kw / 2;
  const int E = (BLUR_TW + 2 * rw) * C;            // floats in a tile row
  const int nt = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.z, y0 = blockIdx.y * BLUR_TH, x0 = blockIdx.x * BLUR_TW;
  const int WC = W * C;
  const float* img = x + (size_t)b * H * WC;
  if constexpr (KH == 0) {
    for (int t = tid; t < kh; t += nt) skh[t] = taps.kh[t];
    for (int t = tid; t < kw; t += nt) skw[t] = taps.kw[t];
    __syncthreads();
  }
  // H pass: one float column of the tile (+ W halo) per thread.
  for (int e = tid; e < E; e += nt) {
    const int px = e / C, c = e - px * C;
    const float* col = img + reflect101(x0 - rw + px, W) * C + c;
    float* m = mid + e;
    if constexpr (KH > 0) {
      float win[KH];                               // win[t] = row i + t
#pragma unroll
      for (int t = 1; t < KH; ++t) win[t] = col[reflect101(y0 - rh + t - 1, H) * WC];
#pragma unroll
      for (int i = 0; i < BLUR_TH; ++i) {
#pragma unroll
        for (int t = 0; t + 1 < KH; ++t) win[t] = win[t + 1];
        win[KH - 1] = col[reflect101(y0 - rh + i + KH - 1, H) * WC];
        float a = taps.kh[0] * win[0];
#pragma unroll
        for (int t = 1; t < KH; ++t) a = a + taps.kh[t] * win[t];
        m[i * E] = a;
      }
    } else {
      for (int i = 0; i < BLUR_TH; ++i) {
        float a = skh[0] * col[reflect101(y0 - rh + i, H) * WC];
        for (int t = 1; t < kh; ++t)
          a = a + skh[t] * col[reflect101(y0 - rh + i + t, H) * WC];
        m[i * E] = a;
      }
    }
  }
  __syncthreads();
  // W pass over the rows and floats that lie in the frame, flattened so
  // every thread has work: element (i, e) reads mid row i at e + t*C.
  const int rows = min(BLUR_TH, H - y0);
  const int valid = min(BLUR_TW, W - x0) * C;
  float* out = y + ((size_t)b * H + y0) * WC + x0 * C;
  int i = 0, e = tid;
  while (e >= valid) { e -= valid; ++i; }
  while (i < rows) {
    const float* m = mid + i * E + e;
    float o;
    if constexpr (KW > 0) {
      o = taps.kw[0] * m[0];
#pragma unroll
      for (int t = 1; t < KW; ++t) o = o + taps.kw[t] * m[t * C];
    } else {
      o = skw[0] * m[0];
      for (int t = 1; t < kw; ++t) o = o + skw[t] * m[t * C];
    }
    out[i * WC + e] = o;
    e += nt;
    while (e >= valid) { e -= valid; ++i; }
  }
}

// ---------------------------------------------------------------------------
// bilateral (K2)
// ---------------------------------------------------------------------------

constexpr int BIL_TW = 32;        // output tile width == blockDim.x
constexpr int BIL_TY = 8;         // blockDim.y
constexpr int BIL_ROWS = 4;       // vertically adjacent outputs per thread
constexpr int BIL_TH = BIL_TY * BIL_ROWS;
static_assert(BIL_TW + 2 * (MAX_WIN / 2) <= 2 * BIL_TW,
              "a lane loads at most two columns of a tile row");

// A pixel in shared memory: RGB is stored RGB0, so one 16-byte load serves
// a tap.
template <int C> struct Px { using T = float4; };
template <> struct Px<1> { using T = float; };
template <> struct Px<2> { using T = float2; };

__device__ __forceinline__ float chan(float p, int) { return p; }
__device__ __forceinline__ float chan(float2 p, int c) { return c == 0 ? p.x : p.y; }
__device__ __forceinline__ float chan(float4 p, int c) {
  return c == 0 ? p.x : c == 1 ? p.y : c == 2 ? p.z : p.w;
}

template <int C>
__device__ __forceinline__ typename Px<C>::T pack(const float* __restrict__ p) {
  if constexpr (C == 1) return p[0];
  else if constexpr (C == 2) return make_float2(p[0], p[1]);
  else if constexpr (C == 3) return make_float4(p[0], p[1], p[2], 0.0f);
  else return make_float4(p[0], p[1], p[2], p[3]);
}

// 2^x on the special-function unit (MUFU.EX2), called explicitly: the
// build has no --use_fast_math. Relative error ~2^-22; subnormal results
// flush to 0 (they are below 1e-38 against a denominator >= 1).
__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Replaces dvf_tpu/ops/pallas_kernels.py:_bilateral_kernel.
//
// Bound: bytes (0.2377 ms at the main-path shape; 0.224 ms of float32
// operations), but in practice the FP32 and MUFU issue rate: d*d range
// weights per pixel, so the design spends few issue slots per tap:
// - R compile-time: the window unrolls fully, and the weight folds into
//   the exponent, w = 2^(dist2 * nk + log2 sw) with nk = -log2(e)/(2 sc^2)
//   and log2 sw both computed in double on the host and rounded to float:
//   one FFMA and one ex2.approx per tap, the log-weights constant
//   operands. Error: the fold rounds nk, log2 sw and the FFMA (3 * 2^-24
//   relative of the exponent x <= 0), which moves w = 2^x by at most
//   3 * 2^-24 * ln2 * |x| * 2^x <= 3 * 2^-24 / e = 6.6e-8; ex2.approx adds
//   ~2^-22 of w. The centre tap has x = 0 and w = 1 exactly, so the
//   denominator is >= 1 and |p - out| <= 1: at d = 5 the output moves by
//   under 25 * 6.6e-8 + 2.4e-7 < 2e-6 against the 1e-5 bar (the plain
//   version's own expf and weight product round at the same scale);
// - the tile is stored RGB0 (C = 3) so one LDS.128 serves a tap;
// - each thread computes BIL_ROWS = 4 vertically adjacent outputs and
//   loads each window row once for all of them: (4 + 2r) * d loads for
//   4 * d * d taps (10 per 25 taps at d = 5, against 75 scalar loads);
// - a 32x32 output tile; the load reflects each tile row and each lane's
//   (at most two) columns once, with no integer division.
// ~13 instructions per tap: C subtractions, C multiply-adds (distance),
// the fold's FFMA, MUFU, C + 1 multiply-adds (numerator, denominator).
template <int C, int R>           // R = 0: radius at run time (r_rt)
__global__ void __launch_bounds__(BIL_TW * BIL_TY)
bilateral_kernel(const float* __restrict__ x, float* __restrict__ y, int H,
                 int W, int r_rt, float nk, Window lw) {
  using P = typename Px<C>::T;
  extern __shared__ float4 smem_tile[];            // (BIL_TH+2r) x (BIL_TW+2r)
  P* tile = reinterpret_cast<P*>(smem_tile);
  __shared__ float slw[R ? 1 : MAX_WIN * MAX_WIN];
  const int r = R ? R : r_rt, d = 2 * r + 1;
  const int SW = BIL_TW + 2 * r, SH = BIL_TH + 2 * r;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.z, y0 = blockIdx.y * BIL_TH, x0 = blockIdx.x * BIL_TW;
  const int WC = W * C;
  const float* img = x + (size_t)b * H * WC;
  if constexpr (R == 0) {
    for (int i = ty * BIL_TW + tx; i < d * d; i += BIL_TW * BIL_TY) slw[i] = lw.w[i];
  }
  // Load: warp ty takes tile rows ty, ty + 8, ...; lane tx columns tx and
  // tx + 32 (SW <= 46).
  const int gx0 = reflect101(x0 - r + tx, W) * C;
  const int gx1 = reflect101(x0 - r + tx + BIL_TW, W) * C;
  const bool two = tx + BIL_TW < SW;
  for (int row = ty; row < SH; row += BIL_TY) {
    const float* src = img + reflect101(y0 - r + row, H) * WC;
    P* dst = tile + row * SW;
    dst[tx] = pack<C>(src + gx0);
    if (two) dst[tx + BIL_TW] = pack<C>(src + gx1);
  }
  __syncthreads();
  float cv[BIL_ROWS][C], num[BIL_ROWS][C], den[BIL_ROWS];
  const P* base = tile + ty * BIL_ROWS * SW + tx;
#pragma unroll
  for (int k = 0; k < BIL_ROWS; ++k) {
    const P p = base[(k + r) * SW + r];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cv[k][c] = chan(p, c);
      num[k][c] = 0.0f;
    }
    den[k] = 0.0f;
  }
  // Window rows j of the thread's 4 + 2r; output k sees row j as dy = j - k,
  // so each output accumulates in the plain version's (dy, dx) order.
#pragma unroll
  for (int j = 0; j < BIL_ROWS + 2 * r; ++j) {
#pragma unroll
    for (int dx = 0; dx < d; ++dx) {
      const P p = base[j * SW + dx];
#pragma unroll
      for (int k = 0; k < BIL_ROWS; ++k) {
        const int dy = j - k;
        if (dy < 0 || dy >= d) continue;
        float diff = chan(p, 0) - cv[k][0];
        float dist2 = diff * diff;
#pragma unroll
        for (int c = 1; c < C; ++c) {
          diff = chan(p, c) - cv[k][c];
          dist2 = dist2 + diff * diff;
        }
        float l;
        if constexpr (R > 0) l = lw.w[dy * d + dx];
        else l = slw[dy * d + dx];
        const float wgt = ex2_approx(fmaf(dist2, nk, l));
#pragma unroll
        for (int c = 0; c < C; ++c) num[k][c] = num[k][c] + wgt * chan(p, c);
        den[k] = den[k] + wgt;
      }
    }
  }
  const int ox = x0 + tx;
  if (ox >= W) return;
#pragma unroll
  for (int k = 0; k < BIL_ROWS; ++k) {
    const int oy = y0 + ty * BIL_ROWS + k;
    if (oy >= H) break;
    float* dst = y + ((size_t)b * H + oy) * WC + ox * C;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = num[k][c] / den[k];
  }
}

// ---------------------------------------------------------------------------
// sobel_bilateral (K3)
// ---------------------------------------------------------------------------

static_assert(BIL_TW + 2 * (MAX_WIN / 2 + 1) <= 2 * BIL_TW,
              "a lane loads at most two gray columns of a tile row");

// Rec.601 gray of the RGB in p[0..2] (utils/image.py rgb_to_gray).
__device__ __forceinline__ float luma(const float* __restrict__ p) {
  return 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
}

// Replaces dvf_tpu/ops/pallas_kernels.py:_sobel_bilateral_kernel. Gray ->
// Sobel magnitude x scale clipped to [0, 1] -> single-channel bilateral,
// broadcast to C channels. The frame is read once and written once; the
// gray tile and the magnitude tile live only in shared memory (11 KB at
// d = 5). The bilateral of a gray image broadcast to C channels has range
// distance C * delta^2, the C folded into nk (the TPU kernel hard-codes 3).
//
// Bound: bytes (0.2377 ms at the main-path shape), with the MUFU close
// behind: 24 ex2 per pixel x 33.2 M pixels at 16 per clock per SM is
// ~0.19 ms at 1.98 GHz, and FP32 issue about as much. What held the first
// design (one output per thread of a 32x8 tile, a runtime window loop
// with an accurate expf and the weight from shared memory per tap, the
// halo loaded 2.08x with two integer divisions per value) to 1.15 ms was
// issue; this one spends few issue slots per tap, as bilateral_kernel
// does, and keeps every load of a block in flight at once:
// - R compile-time: the window unrolls, the weight folds into the
//   exponent, w = 2^(delta^2 * nk + log2 sw) with nk = -C log2(e)/(2 sc^2)
//   and log2 sw computed in double on the host and rounded to float
//   (ops/kernels.py: sobel_bilateral_constants): one FMUL, one FFMA and one
//   ex2.approx per tap; the centre tap is w = 1 exactly and skips them.
//   Error: as in bilateral_kernel's note, the fold moves each w by at most
//   3 * 2^-24 / e = 6.6e-8 and ex2.approx by ~2^-22 of w; the denominator
//   is >= 1 and |p - out| <= 1, so at d = 5 the output moves by under
//   24 * 6.6e-8 + 2.4e-7 < 2e-6 against the 1e-5 bar;
// - a 32x32 output tile, 4 vertically adjacent outputs per thread: each
//   magnitude row of a thread's window is read once for its 4 outputs,
//   (4 + 2r) * d loads for 4 * d * d taps;
// - the gray tile ((32 + 2r + 2)^2, 1.41x the outputs at d = 5) is loaded
//   as bilateral_kernel loads its tile: reflect-101 once per tile row and
//   once per lane column, lane tx taking columns tx and tx + 32, no integer
//   division; the row loop unrolls, so all of a thread's loads are issued
//   before the first returns. The Sobel magnitude ((32 + 2r)^2, 1.27x) is
//   computed from it, flattened over the block with a division by a
//   compile-time width, its loop unrolled too;
// - IEEE sqrtf and num / den run once per pixel, not per tap;
// - the results are staged in shared memory (over the magnitude tile) and
//   each output row is written as C * 32 consecutive floats, lane e
//   storing floats e, e + 32, ...: every store of a warp fills 4 whole
//   32-byte sectors, where C scalar stores per pixel from each lane leave
//   each sector a third written per store; any 4-byte aligned output.
// - at most 32 registers (8 blocks of 256 threads per SM), so other blocks
//   hide each block's load latency; 40 at C = 4, d = 7 (6 blocks), which
//   spills at 32.
// Magnitude commutes with reflect-101 (the derivative flips sign under
// reflection, |.| restores it), so computing it inside the reflected halo
// reproduces the unfused chain's borders.
template <int C, int R>           // R = 0: radius at run time (r_rt)
__global__ void __launch_bounds__(BIL_TW * BIL_TY, C == 4 && R == 3 ? 6 : 8)
sobel_bilateral_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int H, int W, int r_rt, float nk, float scale,
                       Window lw) {
  extern __shared__ float smem[];
  __shared__ float slw[R ? 1 : MAX_WIN * MAX_WIN];
  constexpr int RM = R ? R : MAX_WIN / 2;           // largest radius
  const int r = R ? R : r_rt, d = 2 * r + 1;
  const int GW = BIL_TW + 2 * r + 2, GH = BIL_TH + 2 * r + 2;   // gray tile
  const int MW = BIL_TW + 2 * r, MH = BIL_TH + 2 * r;           // magnitude tile
  float* gray = smem;
  float* mag = smem + GH * GW;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BIL_TW + tx;
  const int b = blockIdx.z, y0 = blockIdx.y * BIL_TH, x0 = blockIdx.x * BIL_TW;
  const int WC = W * C;
  const float* img = x + (size_t)b * H * WC;
  if constexpr (R == 0) {
    for (int i = tid; i < d * d; i += BIL_TW * BIL_TY) slw[i] = lw.w[i];
  }
  // Gray: warp ty takes tile rows ty, ty + 8, ...; lane tx columns tx and
  // tx + 32 (GW <= 48).
  const int gx0 = reflect101(x0 - r - 1 + tx, W) * C;
  const int gx1 = reflect101(x0 - r - 1 + tx + BIL_TW, W) * C;
  const bool two = tx + BIL_TW < GW;
#pragma unroll
  for (int it = 0; it < (BIL_TH + 2 * RM + 2 + BIL_TY - 1) / BIL_TY; ++it) {
    const int row = ty + it * BIL_TY;
    if (row >= GH) break;
    const float* src = img + (size_t)reflect101(y0 - r - 1 + row, H) * WC;
    float* dst = gray + row * GW;
    dst[tx] = luma(src + gx0);
    if (two) dst[tx + BIL_TW] = luma(src + gx1);
  }
  __syncthreads();
  constexpr int M_MAX = (BIL_TH + 2 * RM) * (BIL_TW + 2 * RM);
  constexpr int NT = BIL_TW * BIL_TY;
#pragma unroll
  for (int it = 0; it < (M_MAX + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (i >= MH * MW) break;
    const int row = i / MW, col = i - row * MW;
    const float* g = gray + row * GW + col;        // 3x3 neighbourhood
    const float sx0 = g[0] + 2.0f * g[GW] + g[2 * GW];
    const float sx2 = g[2] + 2.0f * g[GW + 2] + g[2 * GW + 2];
    const float sy0 = g[0] + 2.0f * g[1] + g[2];
    const float sy2 = g[2 * GW] + 2.0f * g[2 * GW + 1] + g[2 * GW + 2];
    const float gx = sx2 - sx0, gy = sy2 - sy0;
    const float m = sqrtf(gx * gx + gy * gy) * scale;
    mag[i] = fminf(fmaxf(m, 0.0f), 1.0f);
  }
  __syncthreads();
  float cv[BIL_ROWS], num[BIL_ROWS], den[BIL_ROWS];
  const float* base = mag + ty * BIL_ROWS * MW + tx;
#pragma unroll
  for (int k = 0; k < BIL_ROWS; ++k) {
    cv[k] = base[(k + r) * MW + r];
    num[k] = 0.0f;
    den[k] = 0.0f;
  }
  // Window rows j of the thread's 4 + 2r; output k sees row j as dy = j - k,
  // so each output accumulates in the plain version's (dy, dx) order.
#pragma unroll
  for (int j = 0; j < BIL_ROWS + 2 * r; ++j) {
#pragma unroll
    for (int dx = 0; dx < d; ++dx) {
      const float p = base[j * MW + dx];
#pragma unroll
      for (int k = 0; k < BIL_ROWS; ++k) {
        const int dy = j - k;
        if (dy < 0 || dy >= d) continue;
        if (R > 0 && dy == r && dx == r) {          // the centre: w = 1
          num[k] = num[k] + p;
          den[k] = den[k] + 1.0f;
          continue;
        }
        const float diff = p - cv[k];
        float l;
        if constexpr (R > 0) l = lw.w[dy * d + dx];
        else l = slw[dy * d + dx];
        const float wgt = ex2_approx(fmaf(diff * diff, nk, l));
        num[k] = num[k] + wgt * p;
        den[k] = den[k] + wgt;
      }
    }
  }
  __syncthreads();                                  // mag is read no more
  float* res = smem;                                // BIL_TH x BIL_TW results
#pragma unroll
  for (int k = 0; k < BIL_ROWS; ++k)
    res[(ty * BIL_ROWS + k) * BIL_TW + tx] = num[k] / den[k];
  __syncthreads();
  const int rows = min(BIL_TH, H - y0);
  const int valid = min(BIL_TW, W - x0) * C;
  for (int i = ty; i < rows; i += BIL_TY) {
    float* dst = y + ((size_t)b * H + y0 + i) * WC + x0 * C;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int e = tx + j * BIL_TW;
      if (e < valid) dst[e] = res[i * BIL_TW + e / C];
    }
  }
}

// Launch with `smem` bytes of dynamic shared memory, opting the kernel in
// first where that is above the 48 KB default (a launch above it without
// the attribute is refused). Returns the launch's cudaGetLastError().
template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
           cudaStream_t s, A... args) {
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, block, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int KH, int KW>
int sep_blur_launch(const float* x, float* y, int B, int H, int W, int kh_len,
                    int kw_len, const SepTaps& taps, cudaStream_t s) {
  const int E = (BLUR_TW + 2 * (kw_len / 2)) * C;
  const int threads = (E + 31) / 32 * 32;
  const size_t smem = (size_t)BLUR_TH * E * sizeof(float);
  const dim3 grid((W + BLUR_TW - 1) / BLUR_TW, (H + BLUR_TH - 1) / BLUR_TH, B);
  return launch(sep_blur_kernel<C, KH, KW>, grid, dim3(threads), smem, s, x, y,
                H, W, kh_len, kw_len, taps);
}

// The tap pairs compiled as constants (ops/kernels.py SEP_BLUR_TAPS), or
// (0, 0) for the runtime-tap instantiation.
template <int C>
int sep_blur_dispatch(int fixed_kh, int fixed_kw, const float* x, float* y,
                      int B, int H, int W, int kh_len, int kw_len,
                      const SepTaps& taps, cudaStream_t s) {
  if (fixed_kh == 0 && fixed_kw == 0)
    return sep_blur_launch<C, 0, 0>(x, y, B, H, W, kh_len, kw_len, taps, s);
  if (fixed_kh == 9 && fixed_kw == 9)
    return sep_blur_launch<C, 9, 9>(x, y, B, H, W, kh_len, kw_len, taps, s);
  if (fixed_kh == 3 && fixed_kw == 9)
    return sep_blur_launch<C, 3, 9>(x, y, B, H, W, kh_len, kw_len, taps, s);
  if (fixed_kh == 5 && fixed_kw == 1)
    return sep_blur_launch<C, 5, 1>(x, y, B, H, W, kh_len, kw_len, taps, s);
  return cudaErrorInvalidValue;
}

template <int C, int R>
int bilateral_launch(const float* x, float* y, int B, int H, int W, int r,
                     float nk, const Window& lw, cudaStream_t s) {
  const size_t smem = (size_t)(BIL_TH + 2 * r) * (BIL_TW + 2 * r)
                      * sizeof(typename Px<C>::T);
  const dim3 grid((W + BIL_TW - 1) / BIL_TW, (H + BIL_TH - 1) / BIL_TH, B);
  return launch(bilateral_kernel<C, R>, grid, dim3(BIL_TW, BIL_TY), smem, s, x,
                y, H, W, r, nk, lw);
}

// The radii compiled as constants (ops/kernels.py BILATERAL_RADII), or 0
// for the runtime-radius instantiation.
template <int C>
int bilateral_dispatch(int fixed_r, const float* x, float* y, int B, int H,
                       int W, int r, float nk, const Window& lw, cudaStream_t s) {
  switch (fixed_r) {
    case 0: return bilateral_launch<C, 0>(x, y, B, H, W, r, nk, lw, s);
    case 1: return bilateral_launch<C, 1>(x, y, B, H, W, r, nk, lw, s);
    case 2: return bilateral_launch<C, 2>(x, y, B, H, W, r, nk, lw, s);
    case 3: return bilateral_launch<C, 3>(x, y, B, H, W, r, nk, lw, s);
  }
  return cudaErrorInvalidValue;
}

template <int C, int R>
int sobel_bilateral_launch(const float* x, float* y, int B, int H, int W, int r,
                           float nk, float scale, const Window& lw,
                           cudaStream_t s) {
  const size_t smem = ((size_t)(BIL_TH + 2 * r + 2) * (BIL_TW + 2 * r + 2)
                       + (size_t)(BIL_TH + 2 * r) * (BIL_TW + 2 * r)) * sizeof(float);
  const dim3 grid((W + BIL_TW - 1) / BIL_TW, (H + BIL_TH - 1) / BIL_TH, B);
  return launch(sobel_bilateral_kernel<C, R>, grid, dim3(BIL_TW, BIL_TY), smem, s,
                x, y, H, W, r, nk, scale, lw);
}

// The radii compiled as constants (ops/kernels.py BILATERAL_RADII), or 0
// for the runtime-radius instantiation.
template <int C>
int sobel_bilateral_dispatch(int fixed_r, const float* x, float* y, int B, int H,
                             int W, int r, float nk, float scale, const Window& lw,
                             cudaStream_t s) {
  switch (fixed_r) {
    case 0: return sobel_bilateral_launch<C, 0>(x, y, B, H, W, r, nk, scale, lw, s);
    case 1: return sobel_bilateral_launch<C, 1>(x, y, B, H, W, r, nk, scale, lw, s);
    case 2: return sobel_bilateral_launch<C, 2>(x, y, B, H, W, r, nk, scale, lw, s);
    case 3: return sobel_bilateral_launch<C, 3>(x, y, B, H, W, r, nk, scale, lw, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* dvf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// right after the launch (0 = launched). Host-side arrays (taps, weights)
// are copied into the kernel's by-value arguments.

// fixed_kh, fixed_kw: the compiled tap pair to run (== kh_len, kw_len), or
// 0, 0 for the runtime-tap instantiation.
int dvf_sep_blur(const float* x, float* y, int B, int H, int W, int C,
                 const float* kh, int kh_len, const float* kw, int kw_len,
                 int fixed_kh, int fixed_kw, void* stream) {
  if (C < 1 || C > MAX_C || kh_len < 1 || kh_len > MAX_TAPS || kw_len < 1 ||
      kw_len > MAX_TAPS)
    return cudaErrorInvalidValue;
  if ((fixed_kh || fixed_kw) && (fixed_kh != kh_len || fixed_kw != kw_len))
    return cudaErrorInvalidValue;
  SepTaps taps;
  memset(&taps, 0, sizeof(taps));
  memcpy(taps.kh, kh, kh_len * sizeof(float));
  memcpy(taps.kw, kw, kw_len * sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return sep_blur_dispatch<1>(fixed_kh, fixed_kw, x, y, B, H, W, kh_len, kw_len, taps, s);
    case 2: return sep_blur_dispatch<2>(fixed_kh, fixed_kw, x, y, B, H, W, kh_len, kw_len, taps, s);
    case 3: return sep_blur_dispatch<3>(fixed_kh, fixed_kw, x, y, B, H, W, kh_len, kw_len, taps, s);
    case 4: return sep_blur_dispatch<4>(fixed_kh, fixed_kw, x, y, B, H, W, kh_len, kw_len, taps, s);
  }
  return cudaErrorInvalidValue;
}

// log2_weights: log2 of the (2r+1)^2 spatial weights, row-major; nk =
// -log2(e) / (2 sigma_color^2). fixed_r: the compiled radius to run (== r),
// or 0 for the runtime-radius instantiation.
int dvf_bilateral(const float* x, float* y, int B, int H, int W, int C, int r,
                  int fixed_r, const float* log2_weights, float nk, void* stream) {
  const int d = 2 * r + 1;
  if (C < 1 || C > MAX_C || r < 0 || d > MAX_WIN || (fixed_r && fixed_r != r))
    return cudaErrorInvalidValue;
  Window lw;
  memset(&lw, 0, sizeof(lw));
  memcpy(lw.w, log2_weights, d * d * sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return bilateral_dispatch<1>(fixed_r, x, y, B, H, W, r, nk, lw, s);
    case 2: return bilateral_dispatch<2>(fixed_r, x, y, B, H, W, r, nk, lw, s);
    case 3: return bilateral_dispatch<3>(fixed_r, x, y, B, H, W, r, nk, lw, s);
    case 4: return bilateral_dispatch<4>(fixed_r, x, y, B, H, W, r, nk, lw, s);
  }
  return cudaErrorInvalidValue;
}

// log2_weights, fixed_r: as dvf_bilateral; nk = -C log2(e) / (2 sigma_color^2)
// (the gray range distance broadcast to C channels); scale: the Sobel
// magnitude's factor.
int dvf_sobel_bilateral(const float* x, float* y, int B, int H, int W, int C,
                        int r, int fixed_r, const float* log2_weights, float nk,
                        float scale, void* stream) {
  const int d = 2 * r + 1;
  if (C < 3 || C > MAX_C || r < 0 || d > MAX_WIN || (fixed_r && fixed_r != r))
    return cudaErrorInvalidValue;
  Window lw;
  memset(&lw, 0, sizeof(lw));
  memcpy(lw.w, log2_weights, d * d * sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 3: return sobel_bilateral_dispatch<3>(fixed_r, x, y, B, H, W, r, nk, scale, lw, s);
    case 4: return sobel_bilateral_dispatch<4>(fixed_r, x, y, B, H, W, r, nk, scale, lw, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
