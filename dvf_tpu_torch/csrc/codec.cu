// Hand-written Hopper (sm_90a) kernels for the temporal-delta wire's
// device half, with a plain C interface loaded by ctypes
// (dvf_tpu_torch/ops/kernels.py: tile_maxdiff_pallas,
// dct8x8_quant_pallas). They replace the TPU's Pallas kernels in
// dvf_tpu/ops/pallas_kernels.py:
//
//   tile_maxdiff_kernel  <- tile_maxdiff_pallas / _tile_maxdiff_kernel
//   dct8x8_quant_kernel  <- dct8x8_quant_pallas / _dct8x8_quant_kernel
//
// tile_maxdiff. out(b, i, j) = max |a - b| over the tile x tile pixels (all
// channels) of tile (i, j) of frame b, uint8. A ragged edge tile covers
// only the pixels that exist, which is the golden's zero pad (a zero
// difference never raises a max). One warp per tile, eight tiles per
// block. A tile's pixels are the contiguous byte range [j*t*C, (j+1)*t*C)
// of each of its rows, read as NB-byte chunks (16, 4 or 1 bytes: the
// largest that divides t*C and the row and fits the pointers' alignment),
// so a chunk never straddles two tiles and consecutive lanes read
// consecutive chunks of a tile row. Each lane keeps a byte-wise running max
// of |a - b| (__vabsdiffu4 / __vmaxu4), folds its four bytes to one value,
// and the warp reduces the lanes with __reduce_max_sync. Bound: bytes. At
// 16 x 1080 x 1920 x 3 it reads 199 MB (59 us at 3.35 TB/s) and does one
// compare per byte; one warp per tile gives the card 32640 warps there and
// 2048 at the delta wire's 8 x 512 x 512 x 3, so enough loads are in
// flight to cover the memory latency even at the small shape.

// dct8x8_quant. out(b, by, bx, v, u) = round_half_even(T(v, u) * r(v, u))
// with T = D (X - 128) D^T over the 8x8 block (by, bx) of plane b, D the
// orthonormal DCT-II matrix and r the float32 reciprocal of the IJG table,
// int16, natural order. A partial block at the right or bottom edge reads
// clamped coordinates, which is the golden's edge pad. A 256-thread block
// takes a strip of 32 8x8 blocks of one block row (8 x 256 pixels). In the
// vertical pass each thread owns one pixel column of the strip: it loads
// its 8 pixels (a warp reads 32 consecutive bytes per row) and writes the
// 8 vertical coefficients of that column to shared memory. In the
// horizontal pass each thread owns one row v of one 8x8 block: it reads
// the 8 values of that row (a conflict-free pattern with the 257-float row
// pitch), computes the 8 coefficients, quantizes them and stores them as
// one 16-byte vector, so a warp writes 512 contiguous bytes. Bound: bytes
// (1 byte in, 2 out per pixel; ~33 float operations per pixel).
//
// Numerics. The golden (_dct8x8_quant_slab) bars FMA contraction with an
// optimization barrier and sums in a fixed order. Here every product and
// sum is written with __fmul_rn / __fadd_rn, which nvcc never contracts
// into an FMA, in the same order: acc = D[u][0]*x0, then acc += D[u][k]*xk
// for k = 1..7, vertical pass first, then the horizontal pass, then the
// multiply by the reciprocal and rintf (round half to even). So the kernel
// reproduces the golden bit for bit; one coefficient off by one is visible
// on the wire.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MD_WARPS = 8;             // tiles (warps) per thread block
constexpr int DCT_BX = 32;              // 8x8 blocks per thread block
constexpr int DCT_THREADS = 8 * DCT_BX;  // one pixel column (then row) each

// Fold the four bytes of a word to their max.
__device__ __forceinline__ unsigned fold4(unsigned v) {
  v = __vmaxu4(v, v >> 16);
  v = __vmaxu4(v, v >> 8);
  return v & 0xffu;
}

template <int NB>
struct Chunk;

template <>
struct Chunk<16> {
  __device__ __forceinline__ static unsigned absmax(const uint8_t* a,
                                                    const uint8_t* b) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(a));
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(b));
    unsigned m = __vabsdiffu4(x.x, y.x);
    m = __vmaxu4(m, __vabsdiffu4(x.y, y.y));
    m = __vmaxu4(m, __vabsdiffu4(x.z, y.z));
    return __vmaxu4(m, __vabsdiffu4(x.w, y.w));
  }
};

template <>
struct Chunk<4> {
  __device__ __forceinline__ static unsigned absmax(const uint8_t* a,
                                                    const uint8_t* b) {
    return __vabsdiffu4(__ldg(reinterpret_cast<const unsigned*>(a)),
                        __ldg(reinterpret_cast<const unsigned*>(b)));
  }
};

template <>
struct Chunk<1> {
  __device__ __forceinline__ static unsigned absmax(const uint8_t* a,
                                                    const uint8_t* b) {
    return __vabsdiffu4(__ldg(a), __ldg(b));
  }
};

// grid (ceil(B * nty * ntx / MD_WARPS)); warp w of block k owns tile
// id = k * MD_WARPS + w, in the output's (b, i, j) row-major order.
template <int NB>
__global__ void __launch_bounds__(32 * MD_WARPS)
tile_maxdiff_kernel(const uint8_t* __restrict__ a,
                    const uint8_t* __restrict__ b, uint8_t* __restrict__ out,
                    int H, int row_bytes, int tile, int tile_bytes, int nty,
                    int ntx, long long ntiles) {
  const long long id = (long long)blockIdx.x * MD_WARPS + threadIdx.x / 32;
  if (id >= ntiles) return;  // whole warps only: the reduction below is full
  const int lane = threadIdx.x % 32;
  const int j = (int)(id % ntx);
  const long long fi = id / ntx;  // frame * nty + i
  const int i = (int)(fi % nty);
  const long long bb = fi / nty;
  const int r0 = i * tile;
  const int rows = min(tile, H - r0);
  const int x0 = j * tile_bytes;
  const int cw = min(tile_bytes, row_bytes - x0) / NB;  // chunks per tile row
  const long long base = (bb * H + r0) * (long long)row_bytes + x0;
  unsigned acc = 0;
#pragma unroll 4
  for (int k = lane; k < rows * cw; k += 32) {
    const int r = k / cw;
    const long long o = base + (long long)r * row_bytes + (long long)(k - r * cw) * NB;
    acc = __vmaxu4(acc, Chunk<NB>::absmax(a + o, b + o));
  }
  const unsigned m = __reduce_max_sync(0xffffffffu, fold4(acc));
  if (lane == 0) out[id] = (uint8_t)m;
}

struct DctTables {
  float d[64];      // D[u][x], row-major
  float recip[64];  // 1 / q[v][u], natural order
};

__device__ __forceinline__ float load_px(const uint8_t* p) { return (float)__ldg(p); }
__device__ __forceinline__ float load_px(const float* p) { return __ldg(p); }

// grid (ceil(nbx / DCT_BX), nby, B).
template <typename T>
__global__ void __launch_bounds__(DCT_THREADS)
dct8x8_quant_kernel(const T* __restrict__ plane, int16_t* __restrict__ out,
                    int H, int W, int nby, int nbx, DctTables tab) {
  __shared__ float vert[8][8 * DCT_BX + 1];  // [u][strip column]
  __shared__ float sd[64], sr[64];
  const int t = threadIdx.x;
  const int by = blockIdx.y;
  const int b = blockIdx.z;
  if (t < 64)
    sd[t] = tab.d[t];
  else if (t < 128)
    sr[t - 64] = tab.recip[t - 64];
  // this thread's pixel column, clamped (edge pad), level-shifted
  float px[8];
  {
    const int gx = min((int)blockIdx.x * 8 * DCT_BX + t, W - 1);
    const T* col = plane + (long long)b * H * W + gx;
#pragma unroll
    for (int y = 0; y < 8; ++y)
      px[y] = __fsub_rn(load_px(col + (long long)min(by * 8 + y, H - 1) * W),
                        128.0f);
  }
  __syncthreads();
  // vertical pass: vert[u][x] = sum_y D[u][y] * px[y][x]
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float acc = __fmul_rn(sd[u * 8], px[0]);
#pragma unroll
    for (int y = 1; y < 8; ++y)
      acc = __fadd_rn(acc, __fmul_rn(sd[u * 8 + y], px[y]));
    vert[u][t] = acc;
  }
  __syncthreads();
  // horizontal pass: T[v][u] = sum_k D[u][k] * vert[v][k] for row v of
  // 8x8 block lb of the strip
  const int lb = t / 8, v = t % 8;
  const int bx = (int)blockIdx.x * DCT_BX + lb;
  if (bx >= nbx) return;
  float row[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) row[k] = vert[v][lb * 8 + k];
  unsigned packed[4];
#pragma unroll
  for (int u = 0; u < 8; u += 2) {
    unsigned pair = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc = __fmul_rn(sd[(u + h) * 8], row[0]);
#pragma unroll
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(sd[(u + h) * 8 + k], row[k]));
      const int16_t q = (int16_t)rintf(__fmul_rn(acc, sr[v * 8 + u + h]));
      pair |= (unsigned)(uint16_t)q << (16 * h);
    }
    packed[u / 2] = pair;
  }
  *reinterpret_cast<uint4*>(out + (((long long)b * nby + by) * nbx + bx) * 64 +
                            v * 8) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

bool aligned(const void* p, int n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

template <typename T>
int launch_dct(const T* plane, int16_t* out, int B, int H, int W,
               const float* dct, const float* recip, void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535) return cudaErrorInvalidValue;
  const int nby = (H + 7) / 8, nbx = (W + 7) / 8;
  if (nby > 65535) return cudaErrorInvalidValue;
  DctTables tab;
  for (int k = 0; k < 64; ++k) {
    tab.d[k] = dct[k];
    tab.recip[k] = recip[k];
  }
  const dim3 grid((nbx + DCT_BX - 1) / DCT_BX, nby, B);
  dct8x8_quant_kernel<T><<<grid, DCT_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      plane, out, H, W, nby, nbx, tab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* dvf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, b: (B, H, W, C) contiguous uint8 on the device; out: (B, ceil(H/t),
// ceil(W/t)) uint8. Launches on `stream`; returns cudaGetLastError() right
// after the launch (0 = launched).
int dvf_tile_maxdiff(const uint8_t* a, const uint8_t* b, uint8_t* out, int B,
                     int H, int W, int C, int tile, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || tile < 1) return cudaErrorInvalidValue;
  const long long row_bytes = (long long)W * C;
  const long long tile_bytes = (long long)tile * C;
  if (row_bytes > 0x7fffffffLL || tile_bytes > 0x7fffffffLL ||
      (long long)tile * tile_bytes > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int nty = (H + tile - 1) / tile;
  const int ntx = (W + tile - 1) / tile;
  const long long ntiles = (long long)B * nty * ntx;
  const long long blocks = (ntiles + MD_WARPS - 1) / MD_WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int nb = 1;
  if (tile_bytes % 16 == 0 && row_bytes % 16 == 0 && aligned(a, 16) &&
      aligned(b, 16))
    nb = 16;
  else if (tile_bytes % 4 == 0 && row_bytes % 4 == 0 && aligned(a, 4) &&
           aligned(b, 4))
    nb = 4;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = (int)row_bytes, tb = (int)tile_bytes;
  switch (nb) {
    case 16:
      tile_maxdiff_kernel<16><<<grid, 32 * MD_WARPS, 0, s>>>(
          a, b, out, H, rb, tile, tb, nty, ntx, ntiles);
      break;
    case 4:
      tile_maxdiff_kernel<4><<<grid, 32 * MD_WARPS, 0, s>>>(
          a, b, out, H, rb, tile, tb, nty, ntx, ntiles);
      break;
    default:
      tile_maxdiff_kernel<1><<<grid, 32 * MD_WARPS, 0, s>>>(
          a, b, out, H, rb, tile, tb, nty, ntx, ntiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// plane: (B, H, W) contiguous on the device; out: (B, ceil(H/8), ceil(W/8),
// 8, 8) int16. dct and recip are 64 host floats each (D row-major, the
// reciprocal table in natural order), passed to the kernel by value.
int dvf_dct8x8_quant_u8(const uint8_t* plane, int16_t* out, int B, int H,
                        int W, const float* dct, const float* recip,
                        void* stream) {
  return launch_dct<uint8_t>(plane, out, B, H, W, dct, recip, stream);
}

int dvf_dct8x8_quant_f32(const float* plane, int16_t* out, int B, int H,
                         int W, const float* dct, const float* recip,
                         void* stream) {
  return launch_dct<float>(plane, out, B, H, W, dct, recip, stream);
}

}  // extern "C"
