// Native data-loader hot path for interactvlm_tpu_torch: the port's own
// copy of the JAX package's decoder (``native/ivlm_io.cpp``), built by
// ``runtime/native_image.py`` into ``build/native/``.
//
// The reference's input pipeline decodes PNGs/JPEGs with cv2/PIL inside
// torch DataLoader worker *processes*. Here decode + resize + normalize run
// in C++ (libpng/libjpeg) behind a ctypes boundary that releases the GIL,
// so the Python-side thread pool gets real parallelism without process
// forking.
//
// Exposed C API:
//   ivlm_image_size(path, &h, &w)           -> probe dimensions
//   ivlm_decode_rgb(path, out, h, w)        -> decode to RGB8 (row-major)
//   ivlm_sam_preprocess(path, target, mean[3], std[3], out_f32,
//                       &resized_h, &resized_w)
//       full SAM preprocess: decode, longest-side bilinear resize to
//       `target`, normalize, zero-pad bottom/right into a
//       (target, target, 3) float32 buffer.
// All functions return 0 on success, negative error codes otherwise.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<uint8_t> rgb;  // h * w * 3
};

bool has_suffix(const char* path, const char* a, const char* b) {
  size_t n = strlen(path);
  size_t la = strlen(a), lb = strlen(b);
  auto ieq = [](const char* x, const char* y, size_t l) {
    for (size_t i = 0; i < l; i++) {
      if (tolower(x[i]) != tolower(y[i])) return false;
    }
    return true;
  };
  if (n >= la && ieq(path + n - la, a, la)) return true;
  if (n >= lb && ieq(path + n - lb, b, lb)) return true;
  return false;
}

int decode_png(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // drop alpha
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  else if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->h = (int)h;
  out->w = (int)w;
  out->rgb.resize((size_t)h * w * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++)
    rows[y] = out->rgb.data() + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = (JpegErr*)cinfo->err;
  longjmp(e->jb, 1);
}

int decode_jpeg(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return -4;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->rgb.resize((size_t)out->h * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + (size_t)cinfo.output_scanline * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

int decode(const char* path, Image* out) {
  if (has_suffix(path, ".png", ".PNG")) return decode_png(path, out);
  if (has_suffix(path, ".jpg", ".jpeg")) return decode_jpeg(path, out);
  // sniff magic
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  uint8_t magic[4] = {0};
  size_t got = fread(magic, 1, 4, fp);
  fclose(fp);
  if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P') {
    return decode_png(path, out);
  }
  return decode_jpeg(path, out);
}

// half-pixel-center bilinear resize, matching the python transforms
void bilinear_resize(const Image& src, int out_h, int out_w, float* dst) {
  for (int y = 0; y < out_h; y++) {
    float fy = ((float)y + 0.5f) * src.h / out_h - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    if (y0 < 0) { y0 = 0; wy = 0; }
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    if (y0 >= src.h) { y0 = src.h - 1; wy = 0; }
    for (int x = 0; x < out_w; x++) {
      float fx = ((float)x + 0.5f) * src.w / out_w - 0.5f;
      int x0 = (int)floorf(fx);
      float wx = fx - x0;
      if (x0 < 0) { x0 = 0; wx = 0; }
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      if (x0 >= src.w) { x0 = src.w - 1; wx = 0; }
      for (int c = 0; c < 3; c++) {
        float tl = src.rgb[((size_t)y0 * src.w + x0) * 3 + c];
        float tr = src.rgb[((size_t)y0 * src.w + x1) * 3 + c];
        float bl = src.rgb[((size_t)y1 * src.w + x0) * 3 + c];
        float br = src.rgb[((size_t)y1 * src.w + x1) * 3 + c];
        float top = tl * (1 - wx) + tr * wx;
        float bot = bl * (1 - wx) + br * wx;
        dst[((size_t)y * out_w + x) * 3 + c] = top * (1 - wy) + bot * wy;
      }
    }
  }
}

}  // namespace

extern "C" {

int ivlm_image_size(const char* path, int* h, int* w) {
  Image img;
  int rc = decode(path, &img);  // simple: full decode probe
  if (rc) return rc;
  *h = img.h;
  *w = img.w;
  return 0;
}

int ivlm_decode_rgb(const char* path, uint8_t* out, int h, int w) {
  Image img;
  int rc = decode(path, &img);
  if (rc) return rc;
  if (img.h != h || img.w != w) return -5;
  memcpy(out, img.rgb.data(), (size_t)h * w * 3);
  return 0;
}

int ivlm_sam_preprocess(const char* path, int target, const float* mean,
                        const float* stddev, float* out, int* resized_h,
                        int* resized_w) {
  Image img;
  int rc = decode(path, &img);
  if (rc) return rc;
  float scale = (float)target / (img.h > img.w ? img.h : img.w);
  int nh = (int)(img.h * scale + 0.5f);
  int nw = (int)(img.w * scale + 0.5f);
  std::vector<float> resized((size_t)nh * nw * 3);
  bilinear_resize(img, nh, nw, resized.data());
  memset(out, 0, (size_t)target * target * 3 * sizeof(float));
  for (int y = 0; y < nh; y++) {
    for (int x = 0; x < nw; x++) {
      for (int c = 0; c < 3; c++) {
        out[((size_t)y * target + x) * 3 + c] =
            (resized[((size_t)y * nw + x) * 3 + c] - mean[c]) / stddev[c];
      }
    }
  }
  *resized_h = nh;
  *resized_w = nw;
  return 0;
}

}  // extern "C"
