// zsdl — ZeroShape data loading library (C++, libpng/libjpeg/zlib).
//
// The port's copy of the image decoder of native/zsdl.cpp: PNG/JPEG straight
// into float32 NHWC arrays, exposed as a C ABI consumed through ctypes
// (zeroshape_tpu_torch/data/native.py). Decode work leaves the Python
// interpreter entirely.
//
// Build (done by data/native.py at first use):
//   g++ -O2 -fPIC -std=c++17 -shared -o build/libzsdl.so zsdl.cpp -lpng -ljpeg -lz -pthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, 8-bit
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(size);
  size_t got = fread(out->data(), 1, size, f);
  fclose(f);
  return got == static_cast<size_t>(size);
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

struct PngReadCtx {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t count) {
  PngReadCtx* ctx = static_cast<PngReadCtx*>(png_get_io_ptr(png));
  if (ctx->pos + count > ctx->size) {
    png_error(png, "read past end");
    return;
  }
  memcpy(out, ctx->data + ctx->pos, count);
  ctx->pos += count;
}

bool decode_png(const std::vector<uint8_t>& buf, Image* img) {
  if (buf.size() < 8 || png_sig_cmp(buf.data(), 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadCtx ctx{buf.data(), buf.size(), 0};
  png_set_read_fn(png, &ctx, png_read_fn);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  img->h = h;
  img->w = w;
  img->c = channels;
  img->data.resize(static_cast<size_t>(h) * w * channels);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = img->data.data() + static_cast<size_t>(y) * w * channels;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

bool decode_jpeg(const std::vector<uint8_t>& buf, Image* img) {
  if (buf.size() < 2 || buf[0] != 0xFF || buf[1] != 0xD8) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf.data(), buf.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img->h = cinfo.output_height;
  img->w = cinfo.output_width;
  img->c = 3;
  img->data.resize(static_cast<size_t>(img->h) * img->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img->data.data() + static_cast<size_t>(cinfo.output_scanline) * img->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_any(const char* path, Image* img) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return false;
  if (decode_png(buf, img)) return true;
  return decode_jpeg(buf, img);
}

// Bilinear resize with half-pixel centers (PIL/torch align_corners=False),
// channel fan-out/fold to the requested count, uint8 -> float [0, 1].
void resize_to_float(const Image& img, int out_h, int out_w, int out_c, float* out) {
  const float sy = static_cast<float>(img.h) / out_h;
  const float sx = static_cast<float>(img.w) / out_w;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > img.h - 1) fy = static_cast<float>(img.h - 1);
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < img.h ? y0 + 1 : img.h - 1;
    float wy = fy - y0;
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > img.w - 1) fx = static_cast<float>(img.w - 1);
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < img.w ? x0 + 1 : img.w - 1;
      float wx = fx - x0;
      for (int ch = 0; ch < out_c; ++ch) {
        int src_c = ch < img.c ? ch : img.c - 1;  // gray -> RGB fan-out
        const size_t s00 = (static_cast<size_t>(y0) * img.w + x0) * img.c + src_c;
        const size_t s01 = (static_cast<size_t>(y0) * img.w + x1) * img.c + src_c;
        const size_t s10 = (static_cast<size_t>(y1) * img.w + x0) * img.c + src_c;
        const size_t s11 = (static_cast<size_t>(y1) * img.w + x1) * img.c + src_c;
        float top = img.data[s00] * (1 - wx) + img.data[s01] * wx;
        float bot = img.data[s10] * (1 - wx) + img.data[s11] * wx;
        out[(static_cast<size_t>(oy) * out_w + ox) * out_c + ch] =
            (top * (1 - wy) + bot * wy) / 255.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode one image into float32 [out_h, out_w, channels] in [0, 1].
// out_h/out_w of 0 means "native size" (the caller sized the buffer from
// the file's header). Returns 0 on success.
int zsdl_decode_image(const char* path, int out_h, int out_w, int channels, float* out) {
  Image img;
  if (!decode_any(path, &img)) return -1;
  if (out_h <= 0) out_h = img.h;
  if (out_w <= 0) out_w = img.w;
  resize_to_float(img, out_h, out_w, channels, out);
  return 0;
}

}  // extern "C"
