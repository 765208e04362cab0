// The host data-loader core of demo2_tpu_torch: JPEG decode, resize, flip,
// pad + crop, normalize and random erasing for a batch of images on a
// std::thread pool, behind a plain C interface bound with ctypes
// (demo2_tpu_torch/data/native.py).
//
// A copy of native/dataloader.cpp (the JAX package's loader, which it binds
// in demo2_tpu/data/native.py), with its pixel contract unchanged: Python
// draws every augmentation parameter, C++ only does the pixel work, erase
// noise comes from a std::mt19937 seeded per image.  Two things differ:
//   * the decoder is chosen where the library is built.  With libjpeg's
//     header present it is libjpeg, as in the JAX package; without it
//     (-DD2T_NVJPEG) it is nvJPEG from the CUDA toolkit, which decodes on the
//     GPU and hands interleaved RGB uint8 to the same resize and augment
//     code.  The two decoders' IDCT and chroma upsampling differ, so their
//     pixels differ by a few levels; everything after the decode is shared.
//   * d2t_encode_jpeg writes an RGB uint8 array to a JPEG file (libjpeg, or
//     nvJPEG's encoder), chroma at full resolution (4:4:4).  It is test support: the tests and chip_smoke.py
//     write their own JPEG trees with it where no PIL is installed.  The
//     loader itself never encodes.
//
// Build (demo2_tpu_torch/data/native.py, at first use):
//   g++ -O3 -march=native -std=c++17 -shared -fPIC dataloader.cpp -ljpeg -lpthread
//   nvcc -O3 -std=c++17 -shared -Xcompiler -fPIC,-march=native -DD2T_NVJPEG
//        dataloader.cpp -lnvjpeg -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#if defined(D2T_NVJPEG)
#include <cuda_runtime_api.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// JPEG decode (RGB, 8-bit) and, for tests, encode
// ---------------------------------------------------------------------------

struct Image {
  int h = 0, w = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

#if defined(D2T_NVJPEG)

bool read_file(const char* path, std::vector<unsigned char>* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  bool ok = n > 0;
  if (ok) {
    data->resize(size_t(n));
    ok = std::fread(data->data(), 1, size_t(n), f) == size_t(n);
  }
  std::fclose(f);
  return ok;
}

// One library handle for the process (created at first use, never
// destroyed); each worker thread decodes with its own state, stream and
// device buffer.
nvjpegHandle_t nvjpeg_handle() {
  static std::once_flag once;
  static nvjpegHandle_t handle = nullptr;
  std::call_once(once, [] {
    if (nvjpegCreateSimple(&handle) != NVJPEG_STATUS_SUCCESS) handle = nullptr;
  });
  return handle;
}

struct DecodeCtx {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* buf = nullptr;  // device, interleaved RGB
  size_t cap = 0;
  bool ok = false;

  DecodeCtx() {
    nvjpegHandle_t h = nvjpeg_handle();
    ok = h != nullptr && nvjpegJpegStateCreate(h, &state) == NVJPEG_STATUS_SUCCESS &&
         cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) == cudaSuccess;
  }
  ~DecodeCtx() {
    if (buf) cudaFree(buf);
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
  }
  DecodeCtx(const DecodeCtx&) = delete;
  DecodeCtx& operator=(const DecodeCtx&) = delete;

  bool reserve(size_t bytes) {
    if (bytes <= cap) return true;
    if (buf) cudaFree(buf);
    buf = nullptr;
    cap = 0;
    if (cudaMalloc(reinterpret_cast<void**>(&buf), bytes) != cudaSuccess) return false;
    cap = bytes;
    return true;
  }
};

bool decode_jpeg_file(const char* path, Image* out, DecodeCtx* ctx) {
  std::vector<unsigned char> data;
  if (!ctx->ok || !read_file(path, &data)) return false;
  nvjpegHandle_t handle = nvjpeg_handle();
  int comps = 0;
  nvjpegChromaSubsampling_t css;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(handle, data.data(), data.size(), &comps, &css, ws, hs) !=
      NVJPEG_STATUS_SUCCESS)
    return false;
  const int w = ws[0], h = hs[0];
  const size_t bytes = size_t(h) * w * 3;
  if (w <= 0 || h <= 0 || !ctx->reserve(bytes)) return false;
  nvjpegImage_t dst;
  std::memset(&dst, 0, sizeof(dst));
  dst.channel[0] = ctx->buf;
  dst.pitch[0] = size_t(w) * 3;
  if (nvjpegDecode(handle, ctx->state, data.data(), data.size(), NVJPEG_OUTPUT_RGBI, &dst,
                   ctx->stream) != NVJPEG_STATUS_SUCCESS)
    return false;
  out->h = h;
  out->w = w;
  out->rgb.resize(bytes);
  if (cudaMemcpyAsync(out->rgb.data(), ctx->buf, bytes, cudaMemcpyDeviceToHost, ctx->stream) !=
      cudaSuccess)
    return false;
  return cudaStreamSynchronize(ctx->stream) == cudaSuccess;
}

bool encode_jpeg_file(const char* path, const uint8_t* rgb, int h, int w, int quality) {
  nvjpegHandle_t handle = nvjpeg_handle();
  DecodeCtx ctx;  // its stream and device buffer
  const size_t bytes = size_t(h) * w * 3;
  if (handle == nullptr || !ctx.ok || !ctx.reserve(bytes)) return false;
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  bool ok = nvjpegEncoderStateCreate(handle, &state, ctx.stream) == NVJPEG_STATUS_SUCCESS &&
            nvjpegEncoderParamsCreate(handle, &params, ctx.stream) == NVJPEG_STATUS_SUCCESS &&
            nvjpegEncoderParamsSetQuality(params, quality, ctx.stream) == NVJPEG_STATUS_SUCCESS &&
            nvjpegEncoderParamsSetSamplingFactors(params, NVJPEG_CSS_444, ctx.stream) ==
                NVJPEG_STATUS_SUCCESS &&
            cudaMemcpyAsync(ctx.buf, rgb, bytes, cudaMemcpyHostToDevice, ctx.stream) ==
                cudaSuccess;
  std::vector<unsigned char> jpeg;
  if (ok) {
    nvjpegImage_t src;
    std::memset(&src, 0, sizeof(src));
    src.channel[0] = ctx.buf;
    src.pitch[0] = size_t(w) * 3;
    size_t length = 0;
    ok = nvjpegEncodeImage(handle, state, params, &src, NVJPEG_INPUT_RGBI, w, h, ctx.stream) ==
             NVJPEG_STATUS_SUCCESS &&
         nvjpegEncodeRetrieveBitstream(handle, state, nullptr, &length, ctx.stream) ==
             NVJPEG_STATUS_SUCCESS &&
         cudaStreamSynchronize(ctx.stream) == cudaSuccess;
    if (ok) {
      jpeg.resize(length);
      ok = nvjpegEncodeRetrieveBitstream(handle, state, jpeg.data(), &length, ctx.stream) ==
               NVJPEG_STATUS_SUCCESS &&
           cudaStreamSynchronize(ctx.stream) == cudaSuccess;
      jpeg.resize(length);
    }
  }
  if (params) nvjpegEncoderParamsDestroy(params);
  if (state) nvjpegEncoderStateDestroy(state);
  if (!ok) return false;
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  ok = std::fwrite(jpeg.data(), 1, jpeg.size(), f) == jpeg.size();
  return std::fclose(f) == 0 && ok;
}

#else  // libjpeg

struct DecodeCtx {
  bool ok = true;
};

bool decode_jpeg_file(const char* path, Image* out, DecodeCtx*) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->rgb.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

bool encode_jpeg_file(const char* path, const uint8_t* rgb, int h, int w, int quality) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.comp_info[0].h_samp_factor = 1;  // 4:4:4: chroma at full resolution
  cinfo.comp_info[0].v_samp_factor = 1;
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) + size_t(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return std::fclose(f) == 0;
}

#endif

// ---------------------------------------------------------------------------
// Resize: separable convolution with a per-axis scaled kernel (the kernel is
// widened by the scale factor when minifying — the antialiasing PIL applies).
// Two filters:
//   INTERP_CUBIC    — cubic a = -0.5, support 2 (train-time augmentation;
//                     close to PIL's antialiased bicubic).
//   INTERP_BILINEAR — triangle, support 1: torchvision's Resize default
//                     (PIL BILINEAR with antialias), used by the reference's
//                     EVAL transform (make_dataloader.py:198-202).  PIL runs
//                     the same separable triangle convolution in uint8
//                     fixed point, so outputs match within ~2/255/pass.
// ---------------------------------------------------------------------------

enum Interp { INTERP_CUBIC = 0, INTERP_BILINEAR = 1 };

inline float cubic(float x) {
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

inline float triangle(float x) {
  x = std::fabs(x);
  return x < 1.0f ? 1.0f - x : 0.0f;
}

// Resize one channel-interleaved RGB image to (oh, ow) with per-axis scaled
// cubic kernels (kernel widened by the scale factor when minifying — this is
// the antialiasing PIL applies).
struct KernelTable {
  std::vector<int> start;      // first source index per output position
  std::vector<float> weights;  // (n_out, ksize) normalized weights
  int ksize = 0;
};

KernelTable make_table(int n_in, int n_out, int interp) {
  const float support = interp == INTERP_BILINEAR ? 1.0f : 2.0f;
  float (*filter)(float) = interp == INTERP_BILINEAR ? triangle : cubic;
  const float s = float(n_in) / n_out;
  const float f = std::max(s, 1.0f);
  const int r = int(std::ceil(support * f));
  KernelTable t;
  t.ksize = 2 * r + 1;
  t.start.resize(n_out);
  t.weights.assign(size_t(n_out) * t.ksize, 0.0f);
  for (int o = 0; o < n_out; ++o) {
    const float center = (o + 0.5f) * s - 0.5f;
    const int x0 = int(std::floor(center)) - r;
    t.start[o] = x0;
    float norm = 0.0f;
    float* w = t.weights.data() + size_t(o) * t.ksize;
    for (int k = 0; k < t.ksize; ++k) {
      const int x = x0 + k;
      if (x < 0 || x >= n_in) continue;
      const float wv = filter((x - center) / f);
      w[k] = wv;
      norm += wv;
    }
    if (norm != 0.0f)
      for (int k = 0; k < t.ksize; ++k) w[k] /= norm;
  }
  return t;
}

// Cache-friendly separable resize: both passes iterate rows in the outer
// loop; inner loops are contiguous and auto-vectorizable.
void resize_sep(const Image& src, int oh, int ow, int interp,
                std::vector<float>* out) {
  const int ih = src.h, iw = src.w;
  const KernelTable tx = make_table(iw, ow, interp);
  const KernelTable ty = make_table(ih, oh, interp);

  // Horizontal pass: (ih, iw, 3) u8 -> (ih, ow, 3) f32, row-major walk.
  std::vector<float> tmp(size_t(ih) * ow * 3);
  for (int y = 0; y < ih; ++y) {
    const uint8_t* srow = src.rgb.data() + size_t(y) * iw * 3;
    float* drow = tmp.data() + size_t(y) * ow * 3;
    for (int ox = 0; ox < ow; ++ox) {
      const int x0 = tx.start[ox];
      const float* w = tx.weights.data() + size_t(ox) * tx.ksize;
      float a0 = 0, a1 = 0, a2 = 0;
      const int kmin = std::max(0, -x0);
      const int kmax = std::min(tx.ksize, iw - x0);
      const uint8_t* px = srow + size_t(x0 + kmin) * 3;
      for (int k = kmin; k < kmax; ++k, px += 3) {
        const float wv = w[k];
        a0 += wv * px[0];
        a1 += wv * px[1];
        a2 += wv * px[2];
      }
      drow[ox * 3 + 0] = a0;
      drow[ox * 3 + 1] = a1;
      drow[ox * 3 + 2] = a2;
    }
  }
  // Vertical pass: accumulate whole rows (contiguous, vectorizes).
  out->assign(size_t(oh) * ow * 3, 0.0f);
  const int rowlen = ow * 3;
  for (int oy = 0; oy < oh; ++oy) {
    float* drow = out->data() + size_t(oy) * rowlen;
    const int y0 = ty.start[oy];
    const float* w = ty.weights.data() + size_t(oy) * ty.ksize;
    const int kmin = std::max(0, -y0);
    const int kmax = std::min(ty.ksize, ih - y0);
    for (int k = kmin; k < kmax; ++k) {
      const float wv = w[k];
      if (wv == 0.0f) continue;
      const float* srow = tmp.data() + size_t(y0 + k) * rowlen;
      for (int i = 0; i < rowlen; ++i) drow[i] += wv * srow[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Per-image transform parameters (decided by Python for determinism).
// ---------------------------------------------------------------------------

struct TransformParams {
  int32_t flip;          // 1 = horizontal flip
  int32_t pad;           // reflection-free zero padding size
  int32_t crop_top;      // crop offset inside padded image
  int32_t crop_left;
  int32_t erase;         // 1 = apply random erasing
  int32_t erase_top, erase_left, erase_h, erase_w;
  uint64_t noise_seed;   // erase noise stream
  int32_t crop_x0, crop_y0, crop_x1, crop_y1;  // pre-crop in source (wide strips); x1==0 -> none
  int32_t interp;        // Interp enum; 0 = cubic (train), 1 = bilinear (eval)
};

// Full pipeline for one image region -> normalized float32 HWC output.
bool process_one(const char* path, const TransformParams& p, int out_h,
                 int out_w, const float* mean, const float* std, float* out,
                 DecodeCtx* ctx) {
  Image img;
  if (!decode_jpeg_file(path, &img, ctx)) return false;
  Image region;
  if (p.crop_x1 > 0) {  // wide-strip modality crop (RGBNT100 layout)
    // Outside the image the crop is zeros, as PIL's Image.crop pads (a
    // single-modal image read as the strip is smaller than the strips; the
    // JAX package's copy reads past the image there).
    const int cw = p.crop_x1 - p.crop_x0, ch = p.crop_y1 - p.crop_y0;
    region.h = ch;
    region.w = cw;
    region.rgb.assign(size_t(ch) * cw * 3, 0);
    const int x0 = std::max(p.crop_x0, 0), x1 = std::min(p.crop_x1, img.w);
    for (int y = 0; y < ch; ++y) {
      const int sy = y + p.crop_y0;
      if (sy < 0 || sy >= img.h || x1 <= x0) continue;
      std::memcpy(region.rgb.data() + (size_t(y) * cw + (x0 - p.crop_x0)) * 3,
                  img.rgb.data() + (size_t(sy) * img.w + x0) * 3, size_t(x1 - x0) * 3);
    }
  } else {
    region = std::move(img);
  }

  std::vector<float> resized;
  resize_sep(region, out_h, out_w, p.interp, &resized);

  if (p.flip) {
    for (int y = 0; y < out_h; ++y) {
      float* row = resized.data() + size_t(y) * out_w * 3;
      for (int x = 0; x < out_w / 2; ++x) {
        for (int c = 0; c < 3; ++c) std::swap(row[x * 3 + c], row[(out_w - 1 - x) * 3 + c]);
      }
    }
  }

  // Pad + crop fused: output pixel (y, x) reads padded (y + crop_top,
  // x + crop_left) which maps to resized (y + crop_top - pad, ...).
  const int pad = p.pad;
  for (int y = 0; y < out_h; ++y) {
    const int sy_ = y + p.crop_top - pad;
    for (int x = 0; x < out_w; ++x) {
      const int sx_ = x + p.crop_left - pad;
      float* dst = out + (size_t(y) * out_w + x) * 3;
      if (sy_ < 0 || sy_ >= out_h || sx_ < 0 || sx_ >= out_w) {
        for (int c = 0; c < 3; ++c) dst[c] = (0.0f - mean[c]) / std[c];
      } else {
        const float* src = resized.data() + (size_t(sy_) * out_w + sx_) * 3;
        for (int c = 0; c < 3; ++c)
          dst[c] = (src[c] / 255.0f - mean[c]) / std[c];
      }
    }
  }

  if (p.erase) {
    std::mt19937 gen(p.noise_seed);
    std::normal_distribution<float> nd(0.0f, 1.0f);
    for (int y = p.erase_top; y < std::min(out_h, p.erase_top + p.erase_h); ++y) {
      for (int x = p.erase_left; x < std::min(out_w, p.erase_left + p.erase_w); ++x) {
        float* dst = out + (size_t(y) * out_w + x) * 3;
        for (int c = 0; c < 3; ++c) dst[c] = nd(gen);
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Thread pool over batch items.
// ---------------------------------------------------------------------------

// fn(worker, i) for i in [0, n) on min(num_threads, n) workers, each with
// its own decode context.
void parallel_for(int n, int num_threads, const std::function<void(DecodeCtx*, int)>& fn) {
  const int nt = std::max(1, std::min(num_threads, n));
  std::vector<DecodeCtx> ctxs(nt);
  if (nt == 1) {
    for (int i = 0; i < n; ++i) fn(&ctxs[0], i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(&ctxs[t], i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Process a batch of images.  paths: n_items C strings; params: n_items
// TransformParams; out: (n_items, out_h, out_w, 3) float32.  Returns the
// number of failures (0 = success).
int d2t_load_batch(const char** paths, const TransformParams* params,
                   int n_items, int out_h, int out_w, const float* mean,
                   const float* std, int num_threads, float* out) {
  std::atomic<int> failures(0);
  parallel_for(n_items, num_threads, [&](DecodeCtx* ctx, int i) {
    float* dst = out + size_t(i) * out_h * out_w * 3;
    if (!process_one(paths[i], params[i], out_h, out_w, mean, std, dst, ctx)) {
      failures.fetch_add(1);
      std::memset(dst, 0, size_t(out_h) * out_w * 3 * sizeof(float));
    }
  });
  return failures.load();
}

// Decode a single JPEG into caller-provided buffer (h*w*3 uint8); returns
// actual dims via out params.  For probing / tests.
int d2t_decode_jpeg(const char* path, uint8_t* out, int max_bytes, int* h,
                    int* w) {
  Image img;
  DecodeCtx ctx;
  if (!decode_jpeg_file(path, &img, &ctx)) return -1;
  *h = img.h;
  *w = img.w;
  const int need = img.h * img.w * 3;
  if (need > max_bytes) return -2;
  std::memcpy(out, img.rgb.data(), need);
  return 0;
}

// Write an (h, w, 3) RGB uint8 array to a JPEG file at `quality` (1-100).
// Test support only (see the top of this file).  Returns 0 on success.
int d2t_encode_jpeg(const char* path, const uint8_t* rgb, int h, int w, int quality) {
  return encode_jpeg_file(path, rgb, h, w, quality) ? 0 : -1;
}

// 1 where the decoder is nvJPEG, 0 where it is libjpeg.
int d2t_decoder() {
#if defined(D2T_NVJPEG)
  return 1;
#else
  return 0;
#endif
}

int d2t_version() { return 2; }  // 2: TransformParams.interp (bilinear eval)

}  // extern "C"
