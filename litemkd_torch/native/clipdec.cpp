// Native clip decoder: JPEG decode + shorter-side bilinear resize + crop +
// horizontal flip, for a whole clip in one call.
//
// This is the data-plane hot path of episode assembly (the reference spends
// its host time in PIL decode inside DataLoader workers, video_reader.py:
// 377-386). Implemented against system libjpeg with no Python object access,
// so the Python wrapper can release the GIL and a thread pool gets true
// parallel decode on many-core hosts.
//
// Exposed C ABI (ctypes):
//   int clipdec_decode_clip(const char** paths, int n_frames, int resize_to,
//                           int crop_y, int crop_x, int crop_size, int flip,
//                           unsigned char* out /* n*crop*crop*3 */);
// returns 0 on success, a negative frame-indexed error code otherwise.

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one in-memory JPEG to an RGB buffer. Returns true on success.
bool decode_jpeg_mem(const unsigned char* buf, unsigned long len,
                     std::vector<unsigned char>& rgb,
                     int* width, int* height) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *width = cinfo.output_width;
  *height = cinfo.output_height;
  rgb.resize(static_cast<size_t>(*width) * *height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() +
        static_cast<size_t>(cinfo.output_scanline) * *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Decode one JPEG file to an RGB buffer (file bytes → memory decoder; frame
// files are ~tens of KB so the extra copy is noise next to the IDCT).
bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb,
                 int* width, int* height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) { fclose(f); return false; }
  std::vector<unsigned char> bytes(static_cast<size_t>(sz));
  size_t got = fread(bytes.data(), 1, bytes.size(), f);
  fclose(f);
  if (got != bytes.size()) return false;
  return decode_jpeg_mem(bytes.data(), bytes.size(), rgb, width, height);
}

// Plain bilinear resize (half-pixel centers) of an RGB buffer.
void resize_bilinear(const unsigned char* src, int sw, int sh,
                     unsigned char* dst, int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float p00 = src[(static_cast<size_t>(y0) * sw + x0) * 3 + c];
        const float p01 = src[(static_cast<size_t>(y0) * sw + x1) * 3 + c];
        const float p10 = src[(static_cast<size_t>(y1) * sw + x0) * 3 + c];
        const float p11 = src[(static_cast<size_t>(y1) * sw + x1) * 3 + c];
        const float v = p00 * (1 - wy) * (1 - wx) + p01 * (1 - wy) * wx +
                        p10 * wy * (1 - wx) + p11 * wy * wx;
        dst[(static_cast<size_t>(y) * dw + x) * 3 + c] =
            static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

// Shared per-frame tail: shorter-side resize (identity if already at target,
// like the reference), bounds-checked crop, optional horizontal flip.
// Returns 0 on success, -1001 if the crop falls outside the resized image.
int process_frame(const std::vector<unsigned char>& rgb, int w, int h,
                  int resize_to, int crop_y, int crop_x, int crop_size,
                  int flip, unsigned char* dst,
                  std::vector<unsigned char>& resized) {
  const unsigned char* img = rgb.data();
  int iw = w, ih = h;
  if (!((w <= h && w == resize_to) || (h <= w && h == resize_to))) {
    int dw, dh;
    if (w < h) {
      dw = resize_to;
      dh = static_cast<int>(static_cast<long long>(resize_to) * h / w);
    } else {
      dh = resize_to;
      dw = static_cast<int>(static_cast<long long>(resize_to) * w / h);
    }
    resized.resize(static_cast<size_t>(dw) * dh * 3);
    resize_bilinear(rgb.data(), w, h, resized.data(), dw, dh);
    img = resized.data();
    iw = dw;
    ih = dh;
  }
  if (crop_y < 0 || crop_x < 0 || crop_y + crop_size > ih ||
      crop_x + crop_size > iw) {
    return -1001;  // crop out of bounds
  }
  for (int y = 0; y < crop_size; ++y) {
    const unsigned char* src_row =
        img + (static_cast<size_t>(crop_y + y) * iw + crop_x) * 3;
    unsigned char* dst_row = dst + static_cast<size_t>(y) * crop_size * 3;
    if (!flip) {
      memcpy(dst_row, src_row, static_cast<size_t>(crop_size) * 3);
    } else {
      for (int x = 0; x < crop_size; ++x) {
        const unsigned char* px = src_row + (crop_size - 1 - x) * 3;
        dst_row[x * 3 + 0] = px[0];
        dst_row[x * 3 + 1] = px[1];
        dst_row[x * 3 + 2] = px[2];
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" int clipdec_decode_clip(const char** paths, int n_frames,
                                   int resize_to, int crop_y, int crop_x,
                                   int crop_size, int flip,
                                   unsigned char* out) {
  std::vector<unsigned char> rgb, resized;
  for (int t = 0; t < n_frames; ++t) {
    int w = 0, h = 0;
    if (!decode_jpeg(paths[t], rgb, &w, &h)) return -(t + 1);
    int rc = process_frame(rgb, w, h, resize_to, crop_y, crop_x, crop_size,
                           flip,
                           out + static_cast<size_t>(t) * crop_size *
                               crop_size * 3,
                           resized);
    if (rc != 0) return rc - t;  // frame-indexed: -(t + 1001)
  }
  return 0;
}

// In-memory variant for zip-backed frame stores (the reference's in-RAM
// 'szip' path, video_reader.py:120-172): bufs[t]/lens[t] hold each frame's
// raw JPEG bytes.
extern "C" int clipdec_decode_clip_mem(const unsigned char** bufs,
                                       const unsigned long* lens,
                                       int n_frames, int resize_to,
                                       int crop_y, int crop_x, int crop_size,
                                       int flip, unsigned char* out) {
  std::vector<unsigned char> rgb, resized;
  for (int t = 0; t < n_frames; ++t) {
    int w = 0, h = 0;
    if (!decode_jpeg_mem(bufs[t], lens[t], rgb, &w, &h)) return -(t + 1);
    int rc = process_frame(rgb, w, h, resize_to, crop_y, crop_x, crop_size,
                           flip,
                           out + static_cast<size_t>(t) * crop_size *
                               crop_size * 3,
                           resized);
    if (rc != 0) return rc - t;
  }
  return 0;
}
