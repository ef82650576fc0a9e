// Hand-written Hopper (sm_90a) kernel for the style nets' last stage, with a
// plain C interface loaded by ctypes (dvf_tpu_torch/models/layers.py:
// out_conv_tanh):
//
//   out = 0.5 * (tanh(round(round(conv9x9_reflect101(x, w)) + round(b))) + 1)
//
// x: (B, H, W, Cin) bf16 NHWC; w: (9, 9, Cin, 3) HWIO and b: (3,), both
// rounded to bf16; out: (B, H, W, 3) float32. "round" is the bf16
// rounding, taken where the plain ops round (the conv result, the bias
// add); tanh and the
// scale are float32, as in dvf_tpu/models/style_transfer.py. The products
// of bf16 values are exact in float32, so the result differs from the
// plain ops only by the summation order of the conv.
//
// It replaces no TPU kernel: dvf_tpu leaves the conv to XLA. On the card
// cuDNN takes no bf16 kernel for 3 output channels: it widened the
// 32-channel input to float32 and ran a TF32 kernel with 3 of its 64
// output columns in use, ~12.8 ms for the style stream's 8 x 720 x 1280
// batch with the reflect pad and the conversion, then five elementwise
// passes for the bias, tanh and scale (a third of the whole step).
//
// Bound: 2 * 81 * Cin * 3 FLOPs an output pixel (115 GFLOP at the stream's
// batch, 0.116 ms at 989 TFLOP/s) against the input read once and the
// float32 output written once (516 MB, 0.154 ms at 3.35 TB/s): bytes, by a
// little. The tensor cores' 8-wide N is the cost: the design spends its
// effort on keeping the MMAs fed from shared memory.
//
// - Implicit GEMM on mma.sync.m16n8k16 (bf16 in, float32 sums): M = 16
//   output pixels along a row, K = 16 input channels of one tap, N = 8.
//   The N columns hold the 3 output channels of two vertical taps, dy and
//   dy + 1 (columns 2c and 2c + 1 for channel c; 6 and 7 zero): one MMA
//   on input row iy adds tap dy's term to output row iy - dy and tap
//   dy + 1's term to row iy - dy - 1, so the 9 taps of a column take 5
//   MMAs, not 9. A warp keeps R + 1 accumulators for its R output rows;
//   row i's result is accumulator i's even column plus accumulator
//   i + 1's odd one, in the same thread (no shuffle).
// - A warp computes R = 8 rows x 16 columns, a block of 8 warps 16 rows x
//   64 columns. For each of the 9 horizontal taps and each 16-channel
//   step a warp holds the 5 tap pairs' B fragments in registers (loaded
//   from device memory, where they stay in L1, one step ahead) and walks
//   the R + 8 input rows once, one ldmatrix.x4 a row feeding up to 5
//   MMAs.
// - Border: each block loads its output tile plus a 4-pixel halo into
//   shared memory with 16-byte cp.async (past L1, which keeps the
//   weights), rows and columns mirrored at the frame's edge by index
//   (reflect-101): no padded copy is made. The 16-byte chunks of a pixel
//   are XOR-swizzled (where Cin / 8 is a power of two; else a pixel takes
//   one chunk more, an odd count), so the 8 rows of an ldmatrix fall in 8
//   distinct bank groups. At Cin 32 the tile takes 108 KB: two blocks (16
//   warps) an SM, one loading while the other computes.
// - A first launch packs the weight into the B fragments' order (bf16,
//   zeros in the unused columns), 23 KB at Cin 32.
// - Epilogue in registers: the bf16 roundings, the bias, tanhf and the
//   scale; only the 3 real channels are stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 9;              // taps a side
constexpr int HALO = K / 2;
constexpr int PAIRS = (K + 1) / 2;  // tap pairs (dy, dy + 1) a column
constexpr int COUT = 3;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90 (227 KB)

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  // Rows and columns past the halo of the last tile feed no output.
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Output tile: R rows a warp, WY x WX warps, 16 columns a warp.
constexpr int R = 8, WY = 2, WX = 4;
constexpr int NT = 32 * WY * WX;
constexpr int TH = R * WY, TW = 16 * WX;
constexpr int HH = TH + 2 * HALO, HW = TW + 2 * HALO;  // the halo tile

// Shared memory of a pixel with NC 16-byte chunks, and the slot of its
// chunk c: XOR-swizzled across the pixels of a 128-byte line where NC is
// a power of two, else one chunk of padding (an odd stride).
template <int NC>
struct Chunks {
  static constexpr bool POW2 = (NC & (NC - 1)) == 0;
  static constexpr int STRIDE = POW2 ? NC : NC + 1;
  static constexpr int PER_LINE = NC >= 8 ? 1 : 8 / NC;  // pixels a 128-byte line
  static constexpr int SPAN = NC < 8 ? NC : 8;
  __device__ static int slot(int pix, int c) {
    return pix * STRIDE + (POW2 ? c ^ ((pix / PER_LINE) % SPAN) : c);
  }
  __host__ __device__ static size_t tile_bytes() { return (size_t)HH * HW * STRIDE * 16; }
};

// The B fragments, [dx][step][pair][lane] of uint2: lane (g, t) holds
// B[k][n = g] for k = 2t, 2t + 1 (x) and 2t + 8, 2t + 9 (y), two bf16 a
// register (the lower half holds the even k); column n is channel n / 2
// of tap dy = 2 * pair + n % 2, zero past channel 2 and tap 8.
__global__ void pack_weights_kernel(const float* __restrict__ w, uint2* __restrict__ frag,
                                    int C) {
  const int steps = C / 16;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K * steps * PAIRS * 32) return;
  const int lane = i & 31;
  int rest = i >> 5;
  const int pair = rest % PAIRS;
  rest /= PAIRS;
  const int step = rest % steps, dx = rest / steps;
  const int g = lane >> 2, t = lane & 3;
  const int co = g >> 1, dy = 2 * pair + (g & 1);
  uint32_t v[2] = {0u, 0u};
  if (co < COUT && dy < K) {
    for (int h = 0; h < 2; ++h) {
      const int k = step * 16 + 2 * t + 8 * h;
      const float* src = w + ((size_t)(dy * K + dx) * C + k) * COUT + co;
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(src[0]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(src[COUT]));
      v[h] = lo | (hi << 16);
    }
  }
  frag[i] = make_uint2(v[0], v[1]);
}

template <int NC>
__global__ void __launch_bounds__(NT, 2)
out_conv_kernel(const __nv_bfloat16* __restrict__ x, const uint2* __restrict__ frag,
                const float* __restrict__ bias, float* __restrict__ out, int H, int W) {
  using S = Chunks<NC>;
  constexpr int C = NC * 8;
  constexpr int STEPS = C / 16;  // K steps of the MMA a tap
  extern __shared__ __align__(128) uint4 tile[];
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;

  // The halo tile, 16 bytes a copy.
  const __nv_bfloat16* xb = x + (size_t)b * H * W * C;
  for (int i = threadIdx.x; i < HH * HW * NC; i += NT) {
    const int q = i % NC, pix = i / NC;
    const int r = pix / HW, c = pix - r * HW;
    const int iy = reflect101(oy0 - HALO + r, H), ix = reflect101(ox0 - HALO + c, W);
    cp_async16(smem_u32(tile + S::slot(pix, q)), xb + ((size_t)iy * W + ix) * C + q * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wy = warp / WX, wx = warp - wy * WX;
  const uint2* fr = frag + lane;
  uint2 next[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) next[p] = __ldg(fr + p * 32);
  float acc[R + 1][4];
#pragma unroll
  for (int j = 0; j <= R; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // ldmatrix: lane l gives the address of pixel l % 16 of the warp's 16,
  // at channel chunk 2 * step + l / 16 (matrices: pixels 0-7 and 8-15 at
  // k 0-7, then at k 8-15: the A fragment's registers in order).
  const uint32_t base = smem_u32(tile);
  const int pix0 = wy * R * HW + wx * 16 + (lane & 15);
#pragma unroll 1
  for (int dx = 0; dx < K; ++dx) {
#pragma unroll
    for (int step = 0; step < STEPS; ++step) {
      uint2 bp[PAIRS];
      const int nxt = min(dx * STEPS + step + 1, K * STEPS - 1);
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        bp[p] = next[p];
        next[p] = __ldg(fr + (nxt * PAIRS + p) * 32);
      }
      const int chunk = 2 * step + (lane >> 4);
#pragma unroll
      for (int iy = 0; iy < R + 2 * HALO; ++iy) {
        uint32_t a[4];
        ldmatrix_x4(a, base + S::slot(pix0 + iy * HW + dx, chunk) * 16);
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) {
          const int j = iy - 2 * p;  // accumulator: output row j (tap 2p), j - 1 (tap 2p + 1)
          if (j >= 0 && j <= R) mma_bf16(acc[j], a, bp[p]);
        }
      }
    }
  }

  // Thread (g, t) holds, in accumulator j, pixels g (0, 1) and g + 8 (2,
  // 3) of channel t: even taps for row j (0, 2), odd taps for row j - 1
  // (1, 3).
  const int g = lane >> 2, t = lane & 3;
  if (t >= COUT) return;
  const float bb = round_bf16(bias[t]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int oy = oy0 + wy * R + i;
    if (oy >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = ox0 + wx * 16 + g + 8 * h;
      if (ox >= W) continue;
      const float s = acc[i][2 * h] + acc[i + 1][2 * h + 1];
      const float z = round_bf16(round_bf16(s) + bb);
      out[(((size_t)b * H + oy) * W + ox) * COUT + t] = 0.5f * (tanhf(z) + 1.0f);
    }
  }
}

template <int NC>
int launch(const __nv_bfloat16* x, const uint2* frag, const float* bias, float* out, int B,
           int H, int W, cudaStream_t s) {
  const size_t smem = Chunks<NC>::tile_bytes();
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = out_conv_kernel<NC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B), NT, smem, s>>>(x, frag, bias, out,
                                                                          H, W);
  return static_cast<int>(cudaGetLastError());
}

int by_channels(int C, const __nv_bfloat16* x, const uint2* frag, const float* bias,
                float* out, int B, int H, int W, cudaStream_t s) {
  switch (C) {
    case 16: return launch<2>(x, frag, bias, out, B, H, W, s);
    case 32: return launch<4>(x, frag, bias, out, B, H, W, s);
    case 48: return launch<6>(x, frag, bias, out, B, H, W, s);
    case 64: return launch<8>(x, frag, bias, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* dvf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (B, H, W, C) bf16, contiguous, 16-byte aligned; w: (9, 9, C, 3)
// float32, contiguous (rounded to bf16 here); bias: (3,) float32; frag:
// scratch of 9 * (C / 16) * 5 * 32 uint2 (the packed weight); out: (B, H,
// W, 3) float32; all on the device. Two launches on
// `stream` (the packing, the conv); returns the first nonzero cudaError
// (0 = launched). Takes H, W >= 5 and C in 16, 32, 48, 64.
int dvf_out_conv(const void* x, const float* w, const float* bias, void* frag, float* out,
                 int B, int H, int W, int C, void* stream) {
  if (B < 1 || B > 65535 || H < HALO + 1 || W < HALO + 1 || H > 65535 * TH ||
      C < 16 || C > 64 || C % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint2* fr = static_cast<uint2*>(frag);
  const int n_frag = K * (C / 16) * PAIRS * 32;
  pack_weights_kernel<<<(n_frag + 255) / 256, 256, 0, s>>>(w, fr, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return by_channels(C, static_cast<const __nv_bfloat16*>(x), fr, bias, out, B, H, W, s);
}

}  // extern "C"
