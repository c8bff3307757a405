// JPEG decoding and encoding on the CUDA toolkit's nvJPEG, for a host that
// has no libjpeg (data/native.py picks this build when jpeglib.h is missing
// and nvjpeg.h is there; it never switches between the two at run time).
//
// The entry points keep the libjpeg build's contract:
// * ic_nvjpeg_decode_batch: csrc/fastloader.cpp's fastloader_decode_batch.
//   A thread pool reads each file and decodes it with nvjpegDecode (one
//   decoder state and one stream a thread). For 4:2:0, 4:2:2, 4:4:4 and
//   grey JPEGs nvJPEG returns the component planes (its IDCT on the card),
//   and the host upsamples the chroma and converts to RGB as libjpeg does
//   by default (jdsample.c's "fancy" triangle filters, jdcolor.c's
//   fixed-point tables), so only the IDCT's rounding differs from the
//   libjpeg build; other subsamplings take nvJPEG's own RGB conversion. The
//   image is then resized bilinearly to (H, W) when its size differs, with
//   fastloader.cpp's resize. A file that is missing, is not a JPEG, or has
//   other than 1 or 3 components (CMYK, YCCK) is a failure: its slot is
//   zeroed and its status 0. An error of CUDA or of nvJPEG's resources (not
//   of the file) stops the batch and returns minus its code.
// * ic_jpeg_encode_rgb: jpeg_encode.cpp's, a baseline JPEG with 4:2:0
//   chroma and standard Huffman tables at the given quality, on nvJPEG's
//   encoder (its DCT and colour conversion are not libjpeg's).

#include <cuda_runtime.h>
#include <library_types.h>
#include <nvjpeg.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include "jpeg_color.h"

namespace {

std::once_flag g_once;
nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_handle_status = NVJPEG_STATUS_NOT_INITIALIZED;

nvjpegHandle_t handle() {
  std::call_once(g_once,
                 [] { g_handle_status = nvjpegCreateSimple(&g_handle); });
  return g_handle_status == NVJPEG_STATUS_SUCCESS ? g_handle : nullptr;
}

// A status caused by nvJPEG's resources rather than by the file's bytes.
bool resource_error(nvjpegStatus_t s) {
  return s == NVJPEG_STATUS_NOT_INITIALIZED ||
         s == NVJPEG_STATUS_ALLOCATOR_FAILURE ||
         s == NVJPEG_STATUS_EXECUTION_FAILED ||
         s == NVJPEG_STATUS_ARCH_MISMATCH || s == NVJPEG_STATUS_INTERNAL_ERROR;
}

// Codes returned (negated) for errors that stop a batch.
constexpr int kNvjpegBase = 1000;  // 1000 + nvjpegStatus_t
constexpr int kCudaBase = 2000;    // 2000 + cudaError_t

// csrc/fastloader.cpp's resize_bilinear (half-pixel centres, RGB
// interleaved), copied so that both builds resize to the same bytes.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = static_cast<float>(sh - 1);
    const int y0 = static_cast<int>(fy);
    const int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = static_cast<float>(sw - 1);
      const int x0 = static_cast<int>(fx);
      const int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * 3;
      uint8_t* out = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] * (1 - wx) + p01[c] * wx;
        const float bot = p10[c] * (1 - wx) + p11[c] * wx;
        out[c] = static_cast<uint8_t>(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

bool read_file(const char* path, std::vector<unsigned char>* bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bytes->clear();
  unsigned char chunk[65536];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    bytes->insert(bytes->end(), chunk, chunk + got);
  const bool ok = !std::ferror(f);
  std::fclose(f);
  return ok && !bytes->empty();
}

// One decoding thread's state.
struct Decoder {
  nvjpegHandle_t h = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t dev_bytes = 0;
  std::vector<unsigned char> file;
  std::vector<uint8_t> planes;   // the decoded planes (or RGB) on the host
  std::vector<uint8_t> scratch;  // the full-size RGB image before a resize
  std::vector<int> rows;         // upsampled chroma rows

  // 0 or minus an error code
  int open(nvjpegHandle_t handle_) {
    h = handle_;
    nvjpegStatus_t s = nvjpegJpegStateCreate(h, &state);
    if (s != NVJPEG_STATUS_SUCCESS) return -(kNvjpegBase + s);
    cudaError_t e = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
    return e == cudaSuccess ? 0 : -(kCudaBase + e);
  }

  ~Decoder() {
    if (dev) cudaFree(dev);
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
  }

  // Planes (or RGB) -> interleaved RGB (hh x w) at `rgb`.
  void to_rgb(nvjpegChromaSubsampling_t ss, const int* widths, const int* heights,
              int w, int hh, bool planar, uint8_t* rgb) {
    const size_t npx = static_cast<size_t>(w) * hh;
    if (!planar) {
      std::memcpy(rgb, planes.data(), npx * 3);
      return;
    }
    const uint8_t* cb = planes.data() + npx;
    const uint8_t* cr = cb + static_cast<size_t>(widths[1]) * heights[1];
    ic_planes_to_rgb(planes.data(), ss == NVJPEG_CSS_GRAY ? nullptr : cb, cr, w, hh,
                     widths[1], heights[1], ss == NVJPEG_CSS_444 ? 1 : 2,
                     ss == NVJPEG_CSS_420 ? 2 : 1, rgb, &rows);
  }

  // 1 decoded, 0 the file is rejected, < 0 an error that stops the batch
  int decode(const char* path, uint8_t* out, int H, int W) {
    if (!read_file(path, &file)) return 0;
    int ncomp = 0;
    nvjpegChromaSubsampling_t ss;
    int widths[NVJPEG_MAX_COMPONENT] = {0};
    int heights[NVJPEG_MAX_COMPONENT] = {0};
    nvjpegStatus_t s = nvjpegGetImageInfo(h, file.data(), file.size(), &ncomp, &ss,
                                          widths, heights);
    if (s != NVJPEG_STATUS_SUCCESS)
      return resource_error(s) ? -(kNvjpegBase + s) : 0;
    const int w = widths[0];
    const int hh = heights[0];
    if ((ncomp != 1 && ncomp != 3) || w <= 0 || hh <= 0) return 0;
    const bool planar = (ncomp == 1 && ss == NVJPEG_CSS_GRAY) ||
                        (ncomp == 3 && (ss == NVJPEG_CSS_444 || ss == NVJPEG_CSS_422 ||
                                        ss == NVJPEG_CSS_420));
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    size_t bytes = 0;
    if (planar) {
      for (int c = 0; c < ncomp; ++c)
        bytes += static_cast<size_t>(widths[c]) * heights[c];
    } else {
      bytes = static_cast<size_t>(hh) * w * 3;
    }
    if (bytes > dev_bytes) {
      if (dev) cudaFree(dev);
      dev = nullptr;
      dev_bytes = 0;
      cudaError_t e = cudaMalloc(&dev, bytes);
      if (e != cudaSuccess) return -(kCudaBase + e);
      dev_bytes = bytes;
    }
    if (planar) {
      size_t off = 0;
      for (int c = 0; c < ncomp; ++c) {
        img.channel[c] = dev + off;
        img.pitch[c] = static_cast<size_t>(widths[c]);
        off += static_cast<size_t>(widths[c]) * heights[c];
      }
    } else {
      img.channel[0] = dev;
      img.pitch[0] = static_cast<size_t>(w) * 3;
    }
    s = nvjpegDecode(h, state, file.data(), file.size(),
                     planar ? NVJPEG_OUTPUT_UNCHANGED : NVJPEG_OUTPUT_RGBI,
                     &img, stream);
    if (s != NVJPEG_STATUS_SUCCESS)
      return resource_error(s) ? -(kNvjpegBase + s) : 0;
    planes.resize(bytes);
    cudaError_t e = cudaMemcpyAsync(planes.data(), dev, bytes, cudaMemcpyDeviceToHost,
                                    stream);
    if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
    if (e != cudaSuccess) return -(kCudaBase + e);
    const bool direct = (hh == H && w == W);
    if (!direct) scratch.resize(static_cast<size_t>(hh) * w * 3);
    uint8_t* target = direct ? out : scratch.data();
    to_rgb(ss, widths, heights, w, hh, planar, target);
    if (!direct) resize_bilinear(target, hh, w, out, H, W);
    return 1;
  }
};

// The encoder's state, made on first use and kept for the process.
struct Encoder {
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t dev_bytes = 0;
  std::vector<unsigned char> bits;
};

std::mutex g_encoder_mu;
Encoder* g_encoder = nullptr;

bool encoder_open(nvjpegHandle_t h, Encoder* enc) {
  return cudaStreamCreateWithFlags(&enc->stream, cudaStreamNonBlocking) ==
             cudaSuccess &&
         nvjpegEncoderStateCreate(h, &enc->state, enc->stream) ==
             NVJPEG_STATUS_SUCCESS &&
         nvjpegEncoderParamsCreate(h, &enc->params, enc->stream) ==
             NVJPEG_STATUS_SUCCESS &&
         nvjpegEncoderParamsSetEncoding(enc->params,
                                        NVJPEG_ENCODING_BASELINE_DCT,
                                        enc->stream) == NVJPEG_STATUS_SUCCESS &&
         nvjpegEncoderParamsSetOptimizedHuffman(enc->params, 0, enc->stream) ==
             NVJPEG_STATUS_SUCCESS &&
         nvjpegEncoderParamsSetSamplingFactors(enc->params, NVJPEG_CSS_420,
                                               enc->stream) ==
             NVJPEG_STATUS_SUCCESS;
}

}  // namespace

extern "C" {

// paths[i] == nullptr marks a missing file. status[i]: 1 decoded, 0 failed
// (slot zero-filled). Returns the number of failures, or minus an error code
// (1000 + nvjpegStatus_t, 2000 + cudaError_t) when the batch stopped.
int ic_nvjpeg_decode_batch(const char** paths, int n, uint8_t* out, int H,
                           int W, int n_threads, uint8_t* status) {
  nvjpegHandle_t h = handle();
  if (!h) return -(kNvjpegBase + g_handle_status);
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  std::atomic<int> fatal(0);
  const size_t stride = static_cast<size_t>(H) * W * 3;
  auto worker = [&]() {
    Decoder dec;
    int code = dec.open(h);
    if (code < 0) {
      fatal.store(code);
      return;
    }
    int i;
    while (fatal.load() == 0 && (i = next.fetch_add(1)) < n) {
      uint8_t* dst = out + stride * i;
      const int r = paths[i] ? dec.decode(paths[i], dst, H, W) : 0;
      if (r < 0) {
        fatal.store(r);
        return;
      }
      status[i] = static_cast<uint8_t>(r);
      if (r == 0) {
        std::memset(dst, 0, stride);
        failed.fetch_add(1);
      }
    }
  };
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return fatal.load() < 0 ? fatal.load() : failed.load();
}

// Writes rgb (H, W, 3) uint8, row-major, as a baseline JPEG at `quality`.
// Returns 0 on success, 1 when the file cannot be written, 2 on a CUDA or
// nvJPEG error.
int ic_jpeg_encode_rgb(const char* path, const uint8_t* rgb, int H, int W,
                       int quality) {
  std::lock_guard<std::mutex> lock(g_encoder_mu);
  nvjpegHandle_t h = handle();
  if (!h) return 2;
  if (!g_encoder) {
    Encoder* enc = new Encoder();
    if (!encoder_open(h, enc)) {
      delete enc;
      return 2;
    }
    g_encoder = enc;
  }
  Encoder* enc = g_encoder;
  const size_t bytes = static_cast<size_t>(H) * W * 3;
  if (bytes > enc->dev_bytes) {
    if (enc->dev) cudaFree(enc->dev);
    enc->dev = nullptr;
    enc->dev_bytes = 0;
    if (cudaMalloc(&enc->dev, bytes) != cudaSuccess) return 2;
    enc->dev_bytes = bytes;
  }
  if (nvjpegEncoderParamsSetQuality(enc->params, quality, enc->stream) !=
      NVJPEG_STATUS_SUCCESS)
    return 2;
  if (cudaMemcpyAsync(enc->dev, rgb, bytes, cudaMemcpyHostToDevice,
                      enc->stream) != cudaSuccess)
    return 2;
  nvjpegImage_t src;
  std::memset(&src, 0, sizeof(src));
  src.channel[0] = enc->dev;
  src.pitch[0] = static_cast<size_t>(W) * 3;
  size_t length = 0;
  if (nvjpegEncodeImage(h, enc->state, enc->params, &src, NVJPEG_INPUT_RGBI,
                        W, H, enc->stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncodeRetrieveBitstream(h, enc->state, nullptr, &length,
                                    enc->stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(enc->stream) != cudaSuccess)
    return 2;
  enc->bits.resize(length);
  if (nvjpegEncodeRetrieveBitstream(h, enc->state, enc->bits.data(), &length,
                                    enc->stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(enc->stream) != cudaSuccess)
    return 2;
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  const bool wrote = std::fwrite(enc->bits.data(), 1, length, f) == length;
  return (std::fclose(f) == 0 && wrote) ? 0 : 1;
}

// The library the decoder and encoder were built on, e.g.
// "nvJPEG 12.4.0 (CUDA runtime 12080)".
const char* ic_jpeg_lib_version() {
  static char text[64];
  int major = 0, minor = 0, patch = 0, runtime = 0;
  nvjpegGetProperty(MAJOR_VERSION, &major);
  nvjpegGetProperty(MINOR_VERSION, &minor);
  nvjpegGetProperty(PATCH_LEVEL, &patch);
  cudaRuntimeGetVersion(&runtime);
  std::snprintf(text, sizeof(text), "nvJPEG %d.%d.%d (CUDA runtime %d)", major,
                minor, patch, runtime);
  return text;
}

}  // extern "C"
