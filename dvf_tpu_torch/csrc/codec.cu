// Hand-written Hopper (sm_90a) kernels for the temporal-delta wire's
// device half, with a plain C interface loaded by ctypes
// (dvf_tpu_torch/ops/kernels.py: tile_maxdiff_pallas,
// dct8x8_quant_planes / dct8x8_quant_pallas). They replace the TPU's
// Pallas kernels in dvf_tpu/ops/pallas_kernels.py:
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
// orthonormal DCT-II matrix and r the float32 reciprocal of the plane's
// IJG table, int16, natural order. A partial block at the right or bottom
// edge reads clamped coordinates, which is the golden's edge pad. One
// launch takes 1-3 planes (the wire's Y, Cb and Cr), each with its own
// geometry and table.
//
// Bounds on the H100. Bytes: 1 in and 2 out per uint8 pixel, 1.88 us for
// one 8 x 512 x 512 plane at 3.35 TB/s, 2.82 us for a 4:2:0 batch (Y and
// two quarter-size chroma planes). Issue: the golden's order bars FMA, so
// each pixel costs 15 FMUL/FADD per pass, a level shift and a quantizer
// multiply and round, ~33 float instructions that each issue alone; at
// 128 per clock per SM that is ~2.1 us for the luma plane and ~3.1 us for
// a batch. So issue, not bytes, is the floor, and the design spends as few
// instructions per pixel as the fixed sequence allows:
//
// - One lane takes one whole 8x8 block: both passes run in registers,
//   with no shared-memory transpose and no barrier between them.
// - A warp takes a task of 32 horizontally adjacent blocks of one block
//   row (an 8 x 256 strip). Each lane reads its block's 8 rows as 8-byte
//   words, so a warp reads 256 contiguous bytes per load instruction.
// - Tasks of all planes form one list, so the chroma tasks fill the luma
//   wave's tail: one launch per 4:2:0 batch, one warp per task.
// - D is read from the kernel parameter (the constant bank) at indices
//   that are constants after unrolling; 1/q, indexed by the plane, from a
//   per-block copy in shared memory (two broadcast 16-byte reads per row).
// - uint8: a byte v becomes v - 128 as __int_as_float(0x4B000000 | v) -
//   8388736 (one PRMT, one FADD; exact), and a quotient q (|q| <= 1024)
//   rounds half to even as q + 12582912, whose low 16 bits are the int16
//   (one FADD, half a PRMT to pack two): no I2F, FRND or F2I. float32
//   planes, whose quotients are not bounded, keep rintf and the cast.
// - The quantized rows are staged in shared memory (a 144-byte pitch per
//   lane, conflict-free) and stored as 16-byte vectors, so a warp writes
//   512 contiguous bytes per store instruction.
//
// What holds it above the floor (measured on the H100, PERF.md): a plane
// is one wave (the luma plane 7.75 warps per SM), so every SM loads, then
// computes, then stores, and the stores (2 bytes per pixel) follow the
// arithmetic.

// Numerics. The golden (_dct8x8_quant_slab) bars FMA contraction with an
// optimization barrier and sums in a fixed order. Here every product and
// sum is written with __fmul_rn / __fadd_rn, which nvcc never contracts
// into an FMA, in the same order: acc = D[u][0]*x0, then acc += D[u][k]*xk
// for k = 1..7, vertical pass first, then the horizontal pass, then the
// multiply by the reciprocal and the round half to even. So the kernel
// reproduces the golden bit for bit; one coefficient off by one is visible
// on the wire.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MD_WARPS = 8;         // tiles (warps) per thread block
constexpr int DCT_WARPS = 4;        // warps per thread block
constexpr int DCT_STRIP = 32;       // 8x8 blocks per task, one lane each
constexpr int DCT_PITCH = 9;        // uint4s per lane in the store stage (144 B)
constexpr int DCT_MAX_PLANES = 3;

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

struct DctPlane {
  const void* src;   // (B, H, W) uint8 or float32
  int16_t* out;      // (B, nby, nbx, 8, 8)
  int H, W, nby, nbx;
  int nstrips;       // tasks per block row: ceil(nbx / DCT_STRIP)
  int fast;          // uint8 rows load as aligned 8-byte words (W % 8 == 0)
  long long begin;   // index of the plane's first task
};

struct DctArgs {
  float d[64];                      // D[u][x], row-major
  float recip[DCT_MAX_PLANES][64];  // 1 / q[v][u] of each plane, natural order
  DctPlane p[DCT_MAX_PLANES];
  int nplanes;
  long long ntasks;
};

// Task t: 32 horizontally adjacent 8x8 blocks (lane i takes bx0 + i) of
// block row `by` of frame `b` of plane `pi`.
struct DctTask {
  int pi, b, by, bx0;
};

__device__ __forceinline__ DctTask task_of(const DctArgs& a, long long t) {
  DctTask k;
  k.pi = (a.nplanes > 2 && t >= a.p[2].begin) ? 2
         : (a.nplanes > 1 && t >= a.p[1].begin) ? 1 : 0;
  const DctPlane& p = a.p[k.pi];
  const int local = (int)(t - p.begin);  // ntasks < 2^31 (the host checks)
  const int r = local / p.nstrips;
  k.bx0 = (local - r * p.nstrips) * DCT_STRIP;
  k.b = r / p.nby;
  k.by = r - k.b * p.nby;
  return k;
}

// A lane's 8x8 block, as loaded: uint8 rows as two words each (bytes 0-3,
// 4-7), float32 rows as floats.
template <typename T>
struct DctRows;

template <>
struct DctRows<uint8_t> {
  uint2 w[8];

  __device__ __forceinline__ void load(const DctPlane& p, const DctTask& k, int lane) {
    const int x0 = min(k.bx0 + lane, p.nbx - 1) * 8, y0 = k.by * 8;
    const uint8_t* src = static_cast<const uint8_t*>(p.src) + (long long)k.b * p.H * p.W;
    if (p.fast && y0 + 8 <= p.H && x0 + 8 <= p.W) {
      const uint8_t* q = src + (long long)y0 * p.W + x0;
#pragma unroll
      for (int y = 0; y < 8; ++y)
        w[y] = __ldg(reinterpret_cast<const uint2*>(q + (long long)y * p.W));
      return;
    }
#pragma unroll
    for (int y = 0; y < 8; ++y) {  // edge block: clamped bytes (edge pad)
      const uint8_t* row = src + (long long)min(y0 + y, p.H - 1) * p.W;
      unsigned lo = 0, hi = 0;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        lo |= (unsigned)__ldg(row + min(x0 + x, p.W - 1)) << (8 * x);
        hi |= (unsigned)__ldg(row + min(x0 + 4 + x, p.W - 1)) << (8 * x);
      }
      w[y] = make_uint2(lo, hi);
    }
  }

  // pixel (y, x) - 128, exactly: 0x4B0000vv is 2^23 + v
  __device__ __forceinline__ float shifted(int y, int x) const {
    const unsigned word = x < 4 ? w[y].x : w[y].y;
    return __fadd_rn(__int_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | (x & 3))),
                     -8388736.0f);
  }

  // round_half_even(acc * r) as int16 in the low 16 bits: |acc * r| <= 1024
  // here, and for |q| < 2^22, q + 1.5 * 2^23 rounds q half to even and
  // keeps its integer in the low bits.
  __device__ __forceinline__ static unsigned quant(float acc, float r) {
    return __float_as_uint(__fadd_rn(__fmul_rn(acc, r), 12582912.0f));
  }
};

template <>
struct DctRows<float> {
  float v[8][8];

  __device__ __forceinline__ void load(const DctPlane& p, const DctTask& k, int lane) {
    const int x0 = min(k.bx0 + lane, p.nbx - 1) * 8, y0 = k.by * 8;
    const float* src = static_cast<const float*>(p.src) + (long long)k.b * p.H * p.W;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const float* row = src + (long long)min(y0 + y, p.H - 1) * p.W;
#pragma unroll
      for (int x = 0; x < 8; ++x) v[y][x] = __ldg(row + min(x0 + x, p.W - 1));
    }
  }

  __device__ __forceinline__ float shifted(int y, int x) const {
    return __fsub_rn(v[y][x], 128.0f);
  }

  __device__ __forceinline__ static unsigned quant(float acc, float r) {
    return (unsigned)(uint16_t)(int16_t)rintf(__fmul_rn(acc, r));
  }
};

// grid (ceil(ntasks / DCT_WARPS)); warp w of block k takes task
// k * DCT_WARPS + w of the planes' task list.
template <typename T>
__global__ void __launch_bounds__(32 * DCT_WARPS, 4)
dct8x8_quant_kernel(const __grid_constant__ DctArgs args) {
  __shared__ __align__(16) float srecip[DCT_MAX_PLANES * 64];
  __shared__ uint4 stage[DCT_WARPS][32 * DCT_PITCH];
  for (int i = threadIdx.x; i < args.nplanes * 64; i += blockDim.x)
    srecip[i] = args.recip[i / 64][i % 64];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  uint4* st = stage[threadIdx.x / 32];
  const long long t = (long long)blockIdx.x * DCT_WARPS + threadIdx.x / 32;
  if (t >= args.ntasks) return;
  const DctTask k = task_of(args, t);
  DctRows<T> blk;
  blk.load(args.p[k.pi], k, lane);
  // vertical pass: vert[u][x] = sum_y D[u][y] * (px[y][x] - 128)
  float vert[8][8];
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    float px[8];
#pragma unroll
    for (int y = 0; y < 8; ++y) px[y] = blk.shifted(y, x);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float acc = __fmul_rn(args.d[u * 8], px[0]);
#pragma unroll
      for (int y = 1; y < 8; ++y) acc = __fadd_rn(acc, __fmul_rn(args.d[u * 8 + y], px[y]));
      vert[u][x] = acc;
    }
  }
  // horizontal pass: T[v][u] = sum_x D[u][x] * vert[v][x], quantized,
  // row v staged as one 16-byte vector
  const float4* rq = reinterpret_cast<const float4*>(srecip + k.pi * 64);
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float4 ra = rq[2 * v], rb = rq[2 * v + 1];
    const float r[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
    unsigned q[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float acc = __fmul_rn(args.d[u * 8], vert[v][0]);
#pragma unroll
      for (int x = 1; x < 8; ++x) acc = __fadd_rn(acc, __fmul_rn(args.d[u * 8 + x], vert[v][x]));
      q[u] = DctRows<T>::quant(acc, r[u]);
    }
    st[lane * DCT_PITCH + v] =
        make_uint4(__byte_perm(q[0], q[1], 0x5410u), __byte_perm(q[2], q[3], 0x5410u),
                   __byte_perm(q[4], q[5], 0x5410u), __byte_perm(q[6], q[7], 0x5410u));
  }
  __syncwarp();
  // the task's blocks are contiguous in the output: 16 bytes per lane,
  // 512 contiguous bytes per store instruction
  const DctPlane& p = args.p[k.pi];
  const int nvalid = min(DCT_STRIP, p.nbx - k.bx0);
  uint4* dst = reinterpret_cast<uint4*>(
      p.out + (((long long)k.b * p.nby + k.by) * p.nbx + k.bx0) * 64);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = j * 32 + lane;  // 16-byte piece i: block i / 8, row i % 8
    if (i / 8 < nvalid) dst[i] = st[(i / 8) * DCT_PITCH + i % 8];
  }
}

bool aligned(const void* p, int n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
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

// planes[i]: a (B, H, W) contiguous plane on the device, uint8 (u8 != 0)
// or float32, with dims[3i..3i+2] = B, H, W; out[i]: its (B, ceil(H/8),
// ceil(W/8), 8, 8) int16 output, 16-byte aligned; 1 <= nplanes <= 3. dct:
// 64 host floats (D row-major); recip: 64 per plane (the reciprocal table
// in natural order); both passed to the kernel by value. One launch on
// `stream`; returns cudaGetLastError() right after it (0 = launched).
int dvf_dct8x8_quant_planes(const void* const* planes, void* const* out,
                            const int* dims, int nplanes, int u8, const float* dct,
                            const float* recip, void* stream) {
  if (nplanes < 1 || nplanes > DCT_MAX_PLANES) return cudaErrorInvalidValue;
  DctArgs a = {};
  for (int k = 0; k < 64; ++k) a.d[k] = dct[k];
  long long ntasks = 0;
  for (int i = 0; i < nplanes; ++i) {
    const int B = dims[3 * i], H = dims[3 * i + 1], W = dims[3 * i + 2];
    if (B < 1 || H < 1 || W < 1 || !aligned(out[i], 16)) return cudaErrorInvalidValue;
    DctPlane& p = a.p[i];
    p.src = planes[i];
    p.out = static_cast<int16_t*>(out[i]);
    p.H = H;
    p.W = W;
    p.nby = (H + 7) / 8;
    p.nbx = (W + 7) / 8;
    p.nstrips = (p.nbx + DCT_STRIP - 1) / DCT_STRIP;
    p.fast = u8 && W % 8 == 0 && aligned(planes[i], 8);
    p.begin = ntasks;
    ntasks += (long long)B * p.nby * p.nstrips;
    for (int k = 0; k < 64; ++k) a.recip[i][k] = recip[64 * i + k];
  }
  if (ntasks > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.nplanes = nplanes;
  a.ntasks = ntasks;
  const dim3 grid((unsigned)((ntasks + DCT_WARPS - 1) / DCT_WARPS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u8)
    dct8x8_quant_kernel<uint8_t><<<grid, 32 * DCT_WARPS, 0, s>>>(a);
  else
    dct8x8_quant_kernel<float><<<grid, 32 * DCT_WARPS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
