// Native asset loader of tiny_renderer_tpu_torch (the same C++ as the JAX
// package's native/asset_loader.cpp; assets/native.py builds this copy
// with g++ into tiny_renderer_tpu_torch/_build/ and binds it with ctypes).
//
// The reference renderer's asset path is native code (the Rust `image` crate
// for TGA with RLE, `obj-rs` for OBJ; reference Cargo.toml:8-10, used at
// src/app.rs:94-131).  This is a tiny dependency-free C++ TGA decoder and
// OBJ parser exposed over a C ABI for ctypes.
//
// Output contract (must match tiny_renderer_tpu_torch/assets/tga.py exactly,
// which itself matches image::open(..).into_rgb8()):
//   * (H, W, 3) RGB u8, rows top-to-bottom (bottom-left-origin files flipped)
//   * 24bpp BGR->RGB, 32bpp BGRA->RGB (alpha dropped), 8bpp gray replicated.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct TgaHeader {
  uint8_t id_len;
  uint8_t cmap_type;
  uint8_t img_type;
  uint16_t cmap_first;
  uint16_t cmap_len;
  uint8_t cmap_bpp;
  uint16_t x0, y0;
  uint16_t width, height;
  uint8_t bpp;
  uint8_t desc;
};

bool read_header(const uint8_t* p, size_t n, TgaHeader* h) {
  if (n < 18) return false;
  h->id_len = p[0];
  h->cmap_type = p[1];
  h->img_type = p[2];
  h->cmap_first = static_cast<uint16_t>(p[3] | (p[4] << 8));
  h->cmap_len = static_cast<uint16_t>(p[5] | (p[6] << 8));
  h->cmap_bpp = p[7];
  h->x0 = static_cast<uint16_t>(p[8] | (p[9] << 8));
  h->y0 = static_cast<uint16_t>(p[10] | (p[11] << 8));
  h->width = static_cast<uint16_t>(p[12] | (p[13] << 8));
  h->height = static_cast<uint16_t>(p[14] | (p[15] << 8));
  h->bpp = p[16];
  h->desc = p[17];
  return true;
}

// Expand one raw pixel (bytes_pp bytes) to RGB.
inline void expand_pixel(const uint8_t* src, int bytes_pp, int bpp, uint8_t* dst) {
  switch (bpp) {
    case 8:
      dst[0] = dst[1] = dst[2] = src[0];
      break;
    case 24:
    case 32:  // BGR(A)
      dst[0] = src[2];
      dst[1] = src[1];
      dst[2] = src[0];
      break;
    case 15:
    case 16: {
      uint16_t v = static_cast<uint16_t>(src[0] | (src[1] << 8));
      uint8_t r = (v >> 10) & 0x1F, g = (v >> 5) & 0x1F, b = v & 0x1F;
      dst[0] = static_cast<uint8_t>((r * 255 + 15) / 31);
      dst[1] = static_cast<uint8_t>((g * 255 + 15) / 31);
      dst[2] = static_cast<uint8_t>((b * 255 + 15) / 31);
      break;
    }
    default:
      dst[0] = dst[1] = dst[2] = 0;
  }
  (void)bytes_pp;
}

}  // namespace

extern "C" {

// Returns 0 on success.  *out_buf is malloc'd (h*w*3 bytes); free with trt_free.
int trt_decode_tga(const char* path, int32_t* out_h, int32_t* out_w, void** out_buf) {
  *out_buf = nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 18) {
    std::fclose(f);
    return 2;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return 3;
  }
  std::fclose(f);

  TgaHeader h;
  if (!read_header(buf.data(), buf.size(), &h)) return 2;
  size_t pos = 18 + h.id_len;

  // Colormap (supported for completeness; asset files don't use one).
  std::vector<uint8_t> cmap_rgb;
  if (h.cmap_type == 1) {
    int centry = (h.cmap_bpp + 7) / 8;
    size_t cbytes = static_cast<size_t>(h.cmap_len) * centry;
    if (pos + cbytes > buf.size()) return 4;
    cmap_rgb.resize(static_cast<size_t>(h.cmap_len) * 3);
    for (int i = 0; i < h.cmap_len; ++i) {
      expand_pixel(buf.data() + pos + static_cast<size_t>(i) * centry, centry, h.cmap_bpp,
                   cmap_rgb.data() + static_cast<size_t>(i) * 3);
    }
    pos += cbytes;
  }

  const size_t npix = static_cast<size_t>(h.width) * h.height;
  const int bytes_pp = (h.bpp + 7) / 8;
  const bool rle = h.img_type == 9 || h.img_type == 10 || h.img_type == 11;
  const bool mapped = h.img_type == 1 || h.img_type == 9;
  if (h.img_type == 0 || h.img_type > 11 || (h.img_type > 3 && !rle)) return 5;

  std::vector<uint8_t> raw(npix * bytes_pp);
  if (rle) {
    size_t written = 0;
    const size_t total = npix * bytes_pp;
    while (written < total) {
      if (pos >= buf.size()) return 6;
      uint8_t packet = buf[pos++];
      int count = (packet & 0x7F) + 1;
      if (packet & 0x80) {
        if (pos + bytes_pp > buf.size()) return 6;
        // A run past the pixel total is malformed input — error like the
        // Python decoder (tga.py), don't silently truncate.
        if (written + static_cast<size_t>(count) * bytes_pp > total) return 6;
        for (int c = 0; c < count; ++c) {
          std::memcpy(raw.data() + written, buf.data() + pos, bytes_pp);
          written += bytes_pp;
        }
        pos += bytes_pp;
      } else {
        size_t n = static_cast<size_t>(count) * bytes_pp;
        if (pos + n > buf.size() || written + n > total) return 6;
        std::memcpy(raw.data() + written, buf.data() + pos, n);
        pos += n;
        written += n;
      }
    }
  } else {
    size_t n = npix * bytes_pp;
    if (pos + n > buf.size()) return 6;
    std::memcpy(raw.data(), buf.data() + pos, n);
  }

  uint8_t* rgb = static_cast<uint8_t*>(std::malloc(npix * 3));
  if (!rgb) return 7;
  if (mapped) {
    for (size_t i = 0; i < npix; ++i) {
      int idx = raw[i * bytes_pp] - h.cmap_first;
      if (idx < 0 || idx >= h.cmap_len) idx = 0;
      std::memcpy(rgb + i * 3, cmap_rgb.data() + static_cast<size_t>(idx) * 3, 3);
    }
  } else {
    for (size_t i = 0; i < npix; ++i) {
      expand_pixel(raw.data() + i * bytes_pp, bytes_pp, h.bpp, rgb + i * 3);
    }
  }

  // Normalize to top-left origin to match image::open / tga.py.
  const bool bottom_origin = (h.desc & 0x20) == 0;
  const bool right_to_left = (h.desc & 0x10) != 0;
  if (bottom_origin || right_to_left) {
    uint8_t* fixed = static_cast<uint8_t*>(std::malloc(npix * 3));
    if (!fixed) {
      std::free(rgb);
      return 7;
    }
    for (int y = 0; y < h.height; ++y) {
      int sy = bottom_origin ? (h.height - 1 - y) : y;
      for (int x = 0; x < h.width; ++x) {
        int sx = right_to_left ? (h.width - 1 - x) : x;
        std::memcpy(fixed + (static_cast<size_t>(y) * h.width + x) * 3,
                    rgb + (static_cast<size_t>(sy) * h.width + sx) * 3, 3);
      }
    }
    std::free(rgb);
    rgb = fixed;
  }

  *out_h = h.height;
  *out_w = h.width;
  *out_buf = rgb;
  return 0;
}

void trt_free(void* p) { std::free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// OBJ parser (counterpart of tiny_renderer_tpu_torch/assets/obj.py).
//
// Returns dense arrays: positions (V,3) f32, tex_coords (VT,2) f32, normals
// (VN,3) f32, and per-triangle index arrays (T,3) i32 for each attribute.
// Faces must be position/texture/normal triplets; like the reference
// (src/scene.rs:224-226) only the first three corners of a polygon are used.
// ---------------------------------------------------------------------------

namespace {

struct Floats {
  std::vector<float> v;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

}  // namespace

extern "C" {

// Returns 0 on success; arrays are malloc'd, free each with trt_free.
int trt_parse_obj(const char* path,
                  int32_t* out_nv, float** out_pos,
                  int32_t* out_nvt, float** out_uv,
                  int32_t* out_nvn, float** out_norm,
                  int32_t* out_nf, int32_t** out_pos_idx,
                  int32_t** out_tex_idx, int32_t** out_norm_idx) {
  *out_pos = *out_uv = *out_norm = nullptr;
  *out_pos_idx = *out_tex_idx = *out_norm_idx = nullptr;

  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  // +1: NUL-terminate so strtof/strtol on a file ending mid-number cannot
  // read past the allocation.
  std::vector<char> buf(static_cast<size_t>(size) + 1, '\0');
  if (size > 0 &&
      std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
          static_cast<size_t>(size)) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);

  std::vector<float> pos, uv, norm;
  std::vector<int32_t> pi, ti, ni;
  const char* p = buf.data();
  const char* end = buf.data() + static_cast<size_t>(size);

  while (p < end) {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    p = skip_ws(p, line_end);
    if (line_end - p >= 2 && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* q = const_cast<char*>(p + 1);
      for (int i = 0; i < 3; ++i) pos.push_back(std::strtof(q, &q));
    } else if (line_end - p >= 3 && p[0] == 'v' && p[1] == 't') {
      char* q = const_cast<char*>(p + 2);
      uv.push_back(std::strtof(q, &q));
      uv.push_back(std::strtof(q, &q));
    } else if (line_end - p >= 3 && p[0] == 'v' && p[1] == 'n') {
      char* q = const_cast<char*>(p + 2);
      for (int i = 0; i < 3; ++i) norm.push_back(std::strtof(q, &q));
    } else if (line_end - p >= 2 && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      char* q = const_cast<char*>(p + 1);
      int32_t corners[3][3];
      int got = 0;
      for (int c = 0; c < 3; ++c) {
        q = const_cast<char*>(skip_ws(q, line_end));
        if (q >= line_end) break;
        long a = std::strtol(q, &q, 10);
        if (q >= line_end || *q != '/') return 3;  // PTN required
        ++q;
        long b = std::strtol(q, &q, 10);
        if (q >= line_end || *q != '/') return 3;
        ++q;
        long cc = std::strtol(q, &q, 10);
        long nvp = static_cast<long>(pos.size() / 3);
        long nvt = static_cast<long>(uv.size() / 2);
        long nvn = static_cast<long>(norm.size() / 3);
        corners[c][0] = static_cast<int32_t>(a > 0 ? a - 1 : nvp + a);
        corners[c][1] = static_cast<int32_t>(b > 0 ? b - 1 : nvt + b);
        corners[c][2] = static_cast<int32_t>(cc > 0 ? cc - 1 : nvn + cc);
        ++got;
      }
      if (got == 3) {
        for (int c = 0; c < 3; ++c) pi.push_back(corners[c][0]);
        for (int c = 0; c < 3; ++c) ti.push_back(corners[c][1]);
        for (int c = 0; c < 3; ++c) ni.push_back(corners[c][2]);
      } else {
        return 4;
      }
    }
    p = next_line(line_end, end);
  }

  auto alloc_f = [](const std::vector<float>& src) -> float* {
    float* out = static_cast<float*>(std::malloc(src.size() * sizeof(float) + 1));
    if (out) std::memcpy(out, src.data(), src.size() * sizeof(float));
    return out;
  };
  auto alloc_i = [](const std::vector<int32_t>& src) -> int32_t* {
    int32_t* out = static_cast<int32_t*>(std::malloc(src.size() * sizeof(int32_t) + 1));
    if (out) std::memcpy(out, src.data(), src.size() * sizeof(int32_t));
    return out;
  };

  *out_nv = static_cast<int32_t>(pos.size() / 3);
  *out_nvt = static_cast<int32_t>(uv.size() / 2);
  *out_nvn = static_cast<int32_t>(norm.size() / 3);
  *out_nf = static_cast<int32_t>(pi.size() / 3);
  *out_pos = alloc_f(pos);
  *out_uv = alloc_f(uv);
  *out_norm = alloc_f(norm);
  *out_pos_idx = alloc_i(pi);
  *out_tex_idx = alloc_i(ti);
  *out_norm_idx = alloc_i(ni);
  if (!*out_pos || !*out_uv || !*out_norm || !*out_pos_idx || !*out_tex_idx || !*out_norm_idx) {
    trt_free(*out_pos); trt_free(*out_uv); trt_free(*out_norm);
    trt_free(*out_pos_idx); trt_free(*out_tex_idx); trt_free(*out_norm_idx);
    return 5;
  }
  return 0;
}

}  // extern "C"
