// Native JPEG codec shim over libjpeg-turbo — the TurboJPEG role from the
// reference (webcam_app.py:24,110,140; inverter.py:32,44), as SURVEY.md §2b
// specifies: decode lands DIRECTLY in the caller's preallocated NHWC uint8
// staging buffer (the pinned array the engine copies to the card), no
// intermediate allocation, no BGR->RGB copy pass. Encode writes into a caller-provided
// byte buffer sized so libjpeg never reallocates in practice.
//
// Thread model: every entry point uses only stack-local libjpeg state, so
// calls are safe from any number of threads concurrently. The Python side
// binds with ctypes.CDLL (GIL released per call) and runs a thread pool —
// a 1080p decode is milliseconds of C work, exactly what the GIL should
// not serialize.
//
// Error model: libjpeg's default error handler calls exit(); we override
// error_exit with setjmp/longjmp and return negative codes instead.
//
// The PyTorch port's own copy of dvf_tpu/transport/jpeg_shim.cpp (same
// entry points, same bytes out). Built at first use by codec.py with
// `g++ -O3 -shared -fPIC ... -ljpeg` into dvf_tpu_torch/_build/ (see
// _native.py).

#include <cstddef>
#include <cstdio>  // jpeglib.h uses size_t/FILE without including them

#include <jpeglib.h>

#include <csetjmp>
#include <cstdlib>
#include <cstring>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Suppress libjpeg's stderr warnings (corrupt-but-recoverable streams);
// hard errors still longjmp out via on_error.
void no_output(j_common_ptr) {}

void install(jpeg_decompress_struct* cinfo, ErrMgr* err) {
  cinfo->err = jpeg_std_error(&err->pub);
  err->pub.error_exit = on_error;
  err->pub.output_message = no_output;
}

void install(jpeg_compress_struct* cinfo, ErrMgr* err) {
  cinfo->err = jpeg_std_error(&err->pub);
  err->pub.error_exit = on_error;
  err->pub.output_message = no_output;
}

}  // namespace

extern "C" {

// Read dims without decoding. Returns 0 ok, -1 on parse error.
int dvf_jpeg_probe(const unsigned char* blob, unsigned long len, int* h,
                   int* w) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  install(&cinfo, &err);
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, blob, len);
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode RGB8 straight into out (out_h*out_w*3, C-contiguous).
// Returns 0 on success. If the JPEG's dims differ from (out_h, out_w),
// nothing is written, actual dims go to *got_h/*got_w, and 1 is returned
// (caller decides: reject, or re-stage at the real size). -1 = bad stream.
int dvf_jpeg_decode(const unsigned char* blob, unsigned long len,
                    unsigned char* out, int out_h, int out_w, int* got_h,
                    int* got_w) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  install(&cinfo, &err);
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, blob, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *got_h = static_cast<int>(cinfo.output_height);
  *got_w = static_cast<int>(cinfo.output_width);
  if (*got_h != out_h || *got_w != out_w ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);  // implies abort of the decompress
    return 1;
  }
  const unsigned long stride = static_cast<unsigned long>(out_w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode h*w*3 RGB8 into out (capacity out_cap). Returns bytes written
// (>0), -needed if out_cap was too small, or 0 on encode error.
// out_cap >= h*w*3 + 4096 guarantees the in-place path (JPEG never
// exceeds raw size plus header slack at any quality).
long dvf_jpeg_encode(const unsigned char* rgb, int h, int w, int quality,
                     unsigned char* out, unsigned long out_cap) {
  jpeg_compress_struct cinfo;
  ErrMgr err;
  install(&cinfo, &err);
  // jpeg_mem_dest stores these ADDRESSES and writes the final (ptr, size)
  // through them inside jpeg_finish_compress — they must stay live for
  // the whole function. The longjmp error path never reads them (so no
  // volatile needed); it returns without freeing, accepting libjpeg's
  // known mem-dest leak on the (raw-pixel encode, ~never) error path.
  unsigned char* buf = out;
  unsigned long sz = out_cap;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    return 0;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &sz);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const unsigned long stride = static_cast<unsigned long>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row =
        const_cast<unsigned char*>(rgb) + cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  // jpeg_mem_dest may have swapped in a bigger malloc'd buffer; recover
  // the final (buf, sz) pair it published.
  unsigned char* fin = buf;
  unsigned long fsz = sz;
  long written;
  if (fin == out) {
    written = static_cast<long>(fsz);
  } else if (fsz <= out_cap) {
    memcpy(out, fin, fsz);
    free(fin);
    written = static_cast<long>(fsz);
  } else {
    free(fin);
    written = -static_cast<long>(fsz);
  }
  jpeg_destroy_compress(&cinfo);
  return written;
}

// Codec-assist entry: encode from PRE-CONVERTED YCbCr 4:2:0 planes
// (device-side RGB->YCbCr + 2x2 chroma subsample, runtime/codec_assist.py)
// via jpeg_write_raw_data — the host skips libjpeg's color-convert and
// downsample passes and runs DCT + quantization + entropy coding only,
// starting from half the bytes of the RGB path. y is h*w, cb/cr are
// (h/2)*(w/2); h and w must be even (the device stage pads). Bottom
// partial iMCU rows are fed by replicating the last row pointer, which
// matches libjpeg's own edge replication. Returns bytes written (>0),
// -needed if out_cap was too small, 0 on error, -1 on odd dims.
long dvf_jpeg_encode_ycbcr420(const unsigned char* y,
                              const unsigned char* cb,
                              const unsigned char* cr, int h, int w,
                              int quality, unsigned char* out,
                              unsigned long out_cap) {
  if (h % 2 || w % 2 || h <= 0 || w <= 0) return -1;
  jpeg_compress_struct cinfo;
  ErrMgr err;
  install(&cinfo, &err);
  unsigned char* buf = out;
  unsigned long sz = out_cap;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    return 0;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &sz);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_YCbCr;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.raw_data_in = TRUE;
  // 4:2:0 — the same sampling jpeg_set_defaults picks for the RGB path,
  // so the output decodes identically shaped on any peer.
  cinfo.comp_info[0].h_samp_factor = 2;
  cinfo.comp_info[0].v_samp_factor = 2;
  cinfo.comp_info[1].h_samp_factor = 1;
  cinfo.comp_info[1].v_samp_factor = 1;
  cinfo.comp_info[2].h_samp_factor = 1;
  cinfo.comp_info[2].v_samp_factor = 1;
  jpeg_start_compress(&cinfo, TRUE);
  const int cw = w / 2, ch = h / 2;
  JSAMPROW y_rows[2 * DCTSIZE];
  JSAMPROW cb_rows[DCTSIZE];
  JSAMPROW cr_rows[DCTSIZE];
  JSAMPARRAY planes[3] = {y_rows, cb_rows, cr_rows};
  while (cinfo.next_scanline < cinfo.image_height) {
    const int base = static_cast<int>(cinfo.next_scanline);
    for (int r = 0; r < 2 * DCTSIZE; ++r) {
      const int yr = base + r < h ? base + r : h - 1;
      y_rows[r] = const_cast<unsigned char*>(y) +
                  static_cast<size_t>(yr) * w;
    }
    for (int r = 0; r < DCTSIZE; ++r) {
      const int crow = base / 2 + r < ch ? base / 2 + r : ch - 1;
      cb_rows[r] = const_cast<unsigned char*>(cb) +
                   static_cast<size_t>(crow) * cw;
      cr_rows[r] = const_cast<unsigned char*>(cr) +
                   static_cast<size_t>(crow) * cw;
    }
    jpeg_write_raw_data(&cinfo, planes, 2 * DCTSIZE);
  }
  jpeg_finish_compress(&cinfo);
  unsigned char* fin = buf;
  unsigned long fsz = sz;
  long written;
  if (fin == out) {
    written = static_cast<long>(fsz);
  } else if (fsz <= out_cap) {
    memcpy(out, fin, fsz);
    free(fin);
    written = static_cast<long>(fsz);
  } else {
    free(fin);
    written = -static_cast<long>(fsz);
  }
  jpeg_destroy_compress(&cinfo);
  return written;
}

// Full-transform codec-assist entry: entropy-code PRE-QUANTIZED DCT
// coefficient blocks (device-side DCT + quantization,
// ops/pallas_kernels.py dct8x8_quant) via jpeg_write_coefficients — the
// host does Huffman coding and nothing else. Blocks are int16 in NATURAL
// (row-major frequency) order, already divided by the tables
// jpeg_set_quality(quality, force_baseline=TRUE) installs (the device
// uses the same IJG formula, jpeg_quant_table); libjpeg applies the
// zigzag during entropy coding. yq is ceil(h/8)*ceil(w/8) blocks of 64,
// row-major over the block grid; cbq/crq are ceil(h/16)*ceil(w/16)
// blocks (4:2:0). h and w must be even (the device stage pads).
// Virtual-array rows beyond the provided grid (iMCU rounding) stay
// zero — the decoder discards that region, so zero padding is exact.
// Returns bytes written (>0), -needed if out_cap was too small, 0 on
// error, -1 on odd dims.
long dvf_jpeg_encode_coefficients(const short* yq, const short* cbq,
                                  const short* crq, int h, int w,
                                  int quality, unsigned char* out,
                                  unsigned long out_cap) {
  if (h % 2 || w % 2 || h <= 0 || w <= 0) return -1;
  jpeg_compress_struct cinfo;
  ErrMgr err;
  install(&cinfo, &err);
  unsigned char* buf = out;
  unsigned long sz = out_cap;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    return 0;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &sz);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_YCbCr;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.comp_info[0].h_samp_factor = 2;
  cinfo.comp_info[0].v_samp_factor = 2;
  cinfo.comp_info[1].h_samp_factor = 1;
  cinfo.comp_info[1].v_samp_factor = 1;
  cinfo.comp_info[2].h_samp_factor = 1;
  cinfo.comp_info[2].v_samp_factor = 1;
  // Caller-provided block grids (tight: exactly covering the image).
  const int nby[3] = {(h + 7) / 8, (h + 15) / 16, (h + 15) / 16};
  const int nbx[3] = {(w + 7) / 8, (w + 15) / 16, (w + 15) / 16};
  const short* src[3] = {yq, cbq, crq};
  // Virtual coefficient arrays must be requested BEFORE
  // jpeg_write_coefficients (which realizes them) and filled after,
  // with dims rounded up to the sampling factors — the coefficient
  // controller reads whole iMCU rows, v_samp block rows at a time.
  jvirt_barray_ptr coef[3];
  for (int ci = 0; ci < 3; ++ci) {
    const int hs = cinfo.comp_info[ci].h_samp_factor;
    const int vs = cinfo.comp_info[ci].v_samp_factor;
    const JDIMENSION wib =
        static_cast<JDIMENSION>((nbx[ci] + hs - 1) / hs * hs);
    const JDIMENSION hib =
        static_cast<JDIMENSION>((nby[ci] + vs - 1) / vs * vs);
    coef[ci] = (*cinfo.mem->request_virt_barray)(
        reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE,
        TRUE /* pre_zero: iMCU-rounding padding blocks stay 0 */, wib,
        hib, static_cast<JDIMENSION>(vs));
  }
  jpeg_write_coefficients(&cinfo, coef);
  for (int ci = 0; ci < 3; ++ci) {
    const int vs = cinfo.comp_info[ci].v_samp_factor;
    for (int by = 0; by < nby[ci]; by += vs) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
          reinterpret_cast<j_common_ptr>(&cinfo), coef[ci],
          static_cast<JDIMENSION>(by), static_cast<JDIMENSION>(vs), TRUE);
      const int nrows = by + vs <= nby[ci] ? vs : nby[ci] - by;
      for (int r = 0; r < nrows; ++r) {
        memcpy(rows[r],
               src[ci] + (static_cast<size_t>(by + r) * nbx[ci]) * DCTSIZE2,
               static_cast<size_t>(nbx[ci]) * DCTSIZE2 * sizeof(JCOEF));
      }
    }
  }
  jpeg_finish_compress(&cinfo);
  unsigned char* fin = buf;
  unsigned long fsz = sz;
  long written;
  if (fin == out) {
    written = static_cast<long>(fsz);
  } else if (fsz <= out_cap) {
    memcpy(out, fin, fsz);
    free(fin);
    written = static_cast<long>(fsz);
  } else {
    free(fin);
    written = -static_cast<long>(fsz);
  }
  jpeg_destroy_compress(&cinfo);
  return written;
}

// Batched variant: n same-geometry coefficient images (the delta wire's
// dirty tiles) entropy-coded in ONE call, reusing one compress object
// across images (libjpeg supports sequential multi-image reuse; the
// JPOOL_IMAGE pool is released by each finish_compress). This exists
// because the per-call cost (ctypes, struct setup, table init) dominates
// a small tile, whose Huffman work is a few blocks — batching all of a
// frame's dirty tiles into one call makes the host's entropy stage
// scale with dirty BLOCKS, not dirty TILES. Planes are packed
// contiguously per image (image i's yq at yq + i*ceil(h/8)*ceil(w/8)*64,
// chroma at i*ceil(h/16)*ceil(w/16)*64). JPEGs land back-to-back in
// `out`; sizes[i] gets image i's byte length. Returns total bytes
// (>0), 0 on a libjpeg error, -1 on bad dims/count, -needed (a lower
// bound) if out_cap ran out.
long dvf_jpeg_encode_coefficients_batch(const short* yq, const short* cbq,
                                        const short* crq, int n, int h,
                                        int w, int quality,
                                        unsigned char* out,
                                        unsigned long out_cap,
                                        unsigned int* sizes) {
  if (h % 2 || w % 2 || h <= 0 || w <= 0 || n <= 0) return -1;
  const int nby[3] = {(h + 7) / 8, (h + 15) / 16, (h + 15) / 16};
  const int nbx[3] = {(w + 7) / 8, (w + 15) / 16, (w + 15) / 16};
  const size_t ystride =
      static_cast<size_t>(nby[0]) * nbx[0] * DCTSIZE2;
  const size_t cstride =
      static_cast<size_t>(nby[1]) * nbx[1] * DCTSIZE2;
  jpeg_compress_struct cinfo;
  ErrMgr err;
  install(&cinfo, &err);
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    return 0;
  }
  jpeg_create_compress(&cinfo);
  unsigned long off = 0;
  for (int i = 0; i < n; ++i) {
    unsigned char* buf = out + off;
    unsigned long sz = out_cap - off;
    jpeg_mem_dest(&cinfo, &buf, &sz);
    cinfo.image_width = static_cast<JDIMENSION>(w);
    cinfo.image_height = static_cast<JDIMENSION>(h);
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_YCbCr;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    cinfo.comp_info[0].h_samp_factor = 2;
    cinfo.comp_info[0].v_samp_factor = 2;
    cinfo.comp_info[1].h_samp_factor = 1;
    cinfo.comp_info[1].v_samp_factor = 1;
    cinfo.comp_info[2].h_samp_factor = 1;
    cinfo.comp_info[2].v_samp_factor = 1;
    const short* src[3] = {yq + i * ystride, cbq + i * cstride,
                           crq + i * cstride};
    jvirt_barray_ptr coef[3];
    for (int ci = 0; ci < 3; ++ci) {
      const int hs = cinfo.comp_info[ci].h_samp_factor;
      const int vs = cinfo.comp_info[ci].v_samp_factor;
      const JDIMENSION wib =
          static_cast<JDIMENSION>((nbx[ci] + hs - 1) / hs * hs);
      const JDIMENSION hib =
          static_cast<JDIMENSION>((nby[ci] + vs - 1) / vs * vs);
      coef[ci] = (*cinfo.mem->request_virt_barray)(
          reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE, TRUE, wib,
          hib, static_cast<JDIMENSION>(vs));
    }
    jpeg_write_coefficients(&cinfo, coef);
    for (int ci = 0; ci < 3; ++ci) {
      const int vs = cinfo.comp_info[ci].v_samp_factor;
      for (int by = 0; by < nby[ci]; by += vs) {
        JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
            reinterpret_cast<j_common_ptr>(&cinfo), coef[ci],
            static_cast<JDIMENSION>(by), static_cast<JDIMENSION>(vs),
            TRUE);
        const int nrows = by + vs <= nby[ci] ? vs : nby[ci] - by;
        for (int r = 0; r < nrows; ++r) {
          memcpy(rows[r],
                 src[ci] +
                     (static_cast<size_t>(by + r) * nbx[ci]) * DCTSIZE2,
                 static_cast<size_t>(nbx[ci]) * DCTSIZE2 * sizeof(JCOEF));
        }
      }
    }
    jpeg_finish_compress(&cinfo);
    if (buf != out + off || sz > out_cap - off) {
      // jpeg_mem_dest outgrew the caller's remaining space and
      // realloc'd its own buffer: report a lower bound on the needed
      // capacity so the caller can retry (or fall back to singles).
      if (buf != out + off) free(buf);
      jpeg_destroy_compress(&cinfo);
      return -static_cast<long>(
          off + sz +
          static_cast<unsigned long>(n - 1 - i) *
              (static_cast<unsigned long>(h) * w * 3 + 4096));
    }
    sizes[i] = static_cast<unsigned int>(sz);
    off += sz;
  }
  jpeg_destroy_compress(&cinfo);
  return static_cast<long>(off);
}

}  // extern "C"
