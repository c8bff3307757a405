// JPEG encoding on libjpeg for the port's data edge (data/native.py).
//
// Built by g++ together with the repo's csrc/fastloader.cpp (the batch
// decoder) into one host library; nvcc never sees this file. The encoder
// writes what cv2.imwrite(path, bgr, [IMWRITE_JPEG_QUALITY, q]) writes:
// jpeg_set_defaults, then jpeg_set_quality(q, TRUE) -- baseline, 4:2:0
// chroma, the islow DCT, standard Huffman tables, not progressive.

#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>

// jpeglib.h needs stdio/stddef types declared before it
#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

}  // namespace

extern "C" {

// Writes rgb (H, W, 3) uint8, row-major, as a baseline JPEG at `quality`.
// Returns 0 on success, 1 when the file cannot be opened or closed, 2 on a
// libjpeg error (the file may then be partly written).
int ic_jpeg_encode_rgb(const char* path, const uint8_t* rgb, int H, int W,
                       int quality) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  jpeg_compress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = W;
  cinfo.image_height = H;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) +
                   static_cast<size_t>(cinfo.next_scanline) * W * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return std::fclose(f) == 0 ? 0 : 1;
}

// The library the decoder and encoder were built on, e.g.
// "libjpeg 62 (libjpeg-turbo 2001005)".
const char* ic_jpeg_lib_version() {
  static char text[64];
#ifdef LIBJPEG_TURBO_VERSION_NUMBER
  std::snprintf(text, sizeof(text), "libjpeg %d (libjpeg-turbo %d)",
                JPEG_LIB_VERSION, LIBJPEG_TURBO_VERSION_NUMBER);
#else
  std::snprintf(text, sizeof(text), "libjpeg %d", JPEG_LIB_VERSION);
#endif
  return text;
}

}  // extern "C"
