// PNG codec of the port's frames on disk, over zlib alone: a thread pool
// that decodes and crops a batch of frames into one contiguous uint8
// buffer, a header reader and an encoder, called from Python via ctypes
// (native/__init__.py).
//
// Counterpart of pfnl_tpu/native/loader.cc, which asks libpng for the same
// work.  The GPU machines the port runs on carry zlib but no libpng, so
// this file reads the format itself: the chunk stream (the CRC of every
// critical chunk checked), inflate, the five row filters, Adam7
// interlacing, and the normalisation the JAX loader asks libpng for
// (loader.cc:58-67 there): palette, gray and gray+alpha to RGB, gray of
// 1, 2 or 4 bits scaled to 8, 16-bit samples stripped to their high byte,
// alpha (and with it tRNS) dropped.  The encoder writes 8-bit RGB or gray,
// filter 0 (None) on every row, deflate level 1 (speed over size, as the
// JAX encoder's png_set_compression_level(1)).
//
// Two repairs over the JAX loader: in full-frame mode every image must
// have the size the caller sized `out` for, and a crop must lie inside
// its image (no negative offset); either fault fails that frame, as an
// unreadable file does, and its status says which.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr unsigned char kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};
constexpr uint32_t kMaxChunk = 0x7fffffffu;  // the format's chunk length limit

// per-frame status of pfnl_decode_crop_batch
enum Status { kOk = 0, kUnreadable = 1, kNotPng = 2, kOutOfBounds = 3 };

struct Header {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
};

struct Image {
  std::vector<unsigned char> rgb;  // [h, w, 3]
  uint32_t w = 0, h = 0;
};

uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

void put_be32(unsigned char* p, uint32_t v) {
  p[0] = v >> 24;
  p[1] = v >> 16;
  p[2] = v >> 8;
  p[3] = v;
}

int channels(int color) {
  switch (color) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

bool valid_depth(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

bool crc_ok(const unsigned char* type_and_data, uint32_t len) {
  uint32_t crc = crc32(0L, type_and_data, len + 4);
  return crc == be32(type_and_data + 4 + len);
}

// The signature and the IHDR chunk (the first 33 bytes of a file).
bool parse_header(const unsigned char* p, size_t n, Header* hd) {
  if (n < 33 || std::memcmp(p, kSignature, 8) != 0) return false;
  if (be32(p + 8) != 13 || std::memcmp(p + 12, "IHDR", 4) != 0) return false;
  if (!crc_ok(p + 12, 13)) return false;
  const unsigned char* d = p + 16;
  hd->w = be32(d);
  hd->h = be32(d + 4);
  hd->depth = d[8];
  hd->color = d[9];
  hd->interlace = d[12];
  if (hd->w == 0 || hd->h == 0 || hd->w > kMaxChunk || hd->h > kMaxChunk) return false;
  if (d[10] != 0 || d[11] != 0 || hd->interlace > 1) return false;  // compression, filter
  return valid_depth(hd->color, hd->depth);
}

bool read_file(const char* path, std::vector<unsigned char>* buf) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  bool ok = std::fseek(fp, 0, SEEK_END) == 0;
  long size = ok ? std::ftell(fp) : -1;
  ok = ok && size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(static_cast<size_t>(size));
    ok = std::fread(buf->data(), 1, buf->size(), fp) == buf->size();
  }
  std::fclose(fp);
  return ok;
}

size_t row_bytes(uint64_t width, const Header& hd) {
  return static_cast<size_t>((width * channels(hd.color) * hd.depth + 7) / 8);
}

// Adam7: (x0, y0, dx, dy) of each pass; a non-interlaced image is one pass.
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                              {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

struct Pass {
  uint32_t x0, y0, dx, dy, w, h;
};

std::vector<Pass> passes(const Header& hd) {
  std::vector<Pass> out;
  if (!hd.interlace) {
    out.push_back({0, 0, 1, 1, hd.w, hd.h});
    return out;
  }
  for (const auto& a : kAdam7) {
    uint32_t x0 = a[0], y0 = a[1], dx = a[2], dy = a[3];
    uint32_t w = hd.w > x0 ? (hd.w - x0 + dx - 1) / dx : 0;
    uint32_t h = hd.h > y0 ? (hd.h - y0 + dy - 1) / dy : 0;
    if (w && h) out.push_back({x0, y0, dx, dy, w, h});
  }
  return out;
}

bool inflate_all(const std::vector<unsigned char>& in, std::vector<unsigned char>* out,
                 size_t want) {
  if (in.size() > 0xffffffffu || want > 0xffffffffu) return false;
  out->resize(want);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(want);
  int rc = inflate(&zs, Z_FINISH);
  size_t got = want - zs.avail_out;
  inflateEnd(&zs);
  // data past the image (libpng warns and reads on) is ignored; a stream
  // that ends early or is corrupt fails
  return got == want && rc != Z_DATA_ERROR && rc != Z_MEM_ERROR && rc != Z_STREAM_ERROR &&
         rc != Z_NEED_DICT;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the row filters of one pass in place: `rows` rows of a filter byte
// then `rb` bytes; bpp is the bytes of a whole pixel (at least 1).
bool unfilter(unsigned char* data, uint32_t rows, size_t rb, size_t bpp) {
  std::vector<unsigned char> zero(rb, 0);
  const unsigned char* prev = zero.data();
  for (uint32_t r = 0; r < rows; ++r) {
    unsigned char* line = data + r * (rb + 1);
    int filter = line[0];
    unsigned char* x = line + 1;
    switch (filter) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < rb; ++i) x[i] += x[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < rb; ++i) x[i] += prev[i];
        break;
      case 3:  // the first pixel has no left neighbour
        for (size_t i = 0; i < bpp && i < rb; ++i) x[i] += prev[i] >> 1;
        for (size_t i = bpp; i < rb; ++i) x[i] += (x[i - bpp] + prev[i]) >> 1;
        break;
      case 4:
        for (size_t i = 0; i < bpp && i < rb; ++i) x[i] += prev[i];
        for (size_t i = bpp; i < rb; ++i)
          x[i] += static_cast<unsigned char>(paeth(x[i - bpp], prev[i], prev[i - bpp]));
        break;
      default:
        return false;
    }
    prev = x;
  }
  return true;
}

// One unfiltered row of `n` pixels to RGB8, pixel i at dst + i * step.
void to_rgb(const unsigned char* src, uint32_t n, const Header& hd, const unsigned char* pal,
            unsigned char* dst, size_t step) {
  const int ch = channels(hd.color);
  const int d = hd.depth;
  for (uint32_t i = 0; i < n; ++i, dst += step) {
    if (d < 8) {  // gray or palette, one sample packed MSB first
      size_t bit = static_cast<size_t>(i) * d;
      int v = (src[bit >> 3] >> (8 - d - (bit & 7))) & ((1 << d) - 1);
      if (hd.color == 3) {
        std::memcpy(dst, pal + 3 * v, 3);
      } else {
        unsigned char g = static_cast<unsigned char>(v * 255 / ((1 << d) - 1));
        dst[0] = dst[1] = dst[2] = g;
      }
      continue;
    }
    // 8 or 16 bits: the sample's first (high) byte
    const unsigned char* s = src + static_cast<size_t>(i) * ch * (d / 8);
    const size_t stride = d / 8;
    switch (hd.color) {
      case 0: case 4:
        dst[0] = dst[1] = dst[2] = s[0];
        break;
      case 3:
        std::memcpy(dst, pal + 3 * s[0], 3);
        break;
      default:  // 2, 6
        dst[0] = s[0];
        dst[1] = s[stride];
        dst[2] = s[2 * stride];
    }
  }
}

bool decode_png_file(const char* path, Image* img, Status* why) {
  std::vector<unsigned char> buf;
  *why = kUnreadable;
  if (!read_file(path, &buf)) return false;
  *why = kNotPng;
  Header hd;
  if (!parse_header(buf.data(), buf.size(), &hd)) return false;
  // a palette of 256 entries, those the file leaves out black, as libpng keeps it
  std::vector<unsigned char> pal(256 * 3, 0);
  bool have_pal = false, ended = false;
  std::vector<unsigned char> idat;
  size_t pos = 33;
  while (pos + 12 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    const unsigned char* type = &buf[pos + 4];
    if (len > kMaxChunk || pos + 12 + len > buf.size()) return false;
    bool critical = !(type[0] & 0x20);
    if (critical && !crc_ok(type, len)) return false;
    const unsigned char* data = type + 4;
    if (!std::memcmp(type, "IEND", 4)) {
      ended = true;
      break;
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (len % 3 || len == 0 || len > 256 * 3) return false;
      std::memcpy(pal.data(), data, len);
      have_pal = true;
    } else if (critical) {
      return false;  // IHDR twice, or a critical chunk this reader does not know
    }
    pos += 12 + len;
  }
  if (!ended || idat.empty() || (hd.color == 3 && !have_pal)) return false;

  std::vector<Pass> ps = passes(hd);
  size_t raw_size = 0;
  for (const Pass& p : ps) raw_size += static_cast<size_t>(p.h) * (row_bytes(p.w, hd) + 1);
  std::vector<unsigned char> raw;
  if (!inflate_all(idat, &raw, raw_size)) return false;
  idat.clear();
  idat.shrink_to_fit();

  const size_t bpp = std::max<size_t>(1, channels(hd.color) * hd.depth / 8);
  img->w = hd.w;
  img->h = hd.h;
  img->rgb.resize(static_cast<size_t>(hd.h) * hd.w * 3);
  unsigned char* at = raw.data();
  for (const Pass& p : ps) {
    size_t rb = row_bytes(p.w, hd);
    if (!unfilter(at, p.h, rb, bpp)) return false;
    for (uint32_t r = 0; r < p.h; ++r) {
      size_t y = p.y0 + static_cast<size_t>(r) * p.dy;
      to_rgb(at + r * (rb + 1) + 1, p.w, hd, pal.data(),
             img->rgb.data() + (y * hd.w + p.x0) * 3, 3 * static_cast<size_t>(p.dx));
    }
    at += static_cast<size_t>(p.h) * (rb + 1);
  }
  *why = kOk;
  return true;
}

bool write_chunk(FILE* fp, const char* type, const unsigned char* data, uint32_t len) {
  unsigned char head[8];
  put_be32(head, len);
  std::memcpy(head + 4, type, 4);
  uint32_t crc = crc32(0L, head + 4, 4);
  if (len) crc = crc32(crc, data, len);
  unsigned char tail[4];
  put_be32(tail, crc);
  return std::fwrite(head, 1, 8, fp) == 8 && (len == 0 || std::fwrite(data, 1, len, fp) == len) &&
         std::fwrite(tail, 1, 4, fp) == 4;
}

}  // namespace

extern "C" {

// The codec this library was built on: "zlib <version>".
const char* pfnl_png_codec() {
  static char name[64];
  std::snprintf(name, sizeof(name), "zlib %s", zlibVersion());
  return name;
}

// Reads only the signature and IHDR; returns 0 on success, else a Status.
int pfnl_png_size(const char* path, int* h, int* w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return kUnreadable;
  unsigned char head[33];
  size_t got = std::fread(head, 1, sizeof(head), fp);
  std::fclose(fp);
  Header hd;
  if (!parse_header(head, got, &hd)) return kNotPng;
  *h = static_cast<int>(hd.h);
  *w = static_cast<int>(hd.w);
  return kOk;
}

// Decode n PNGs over num_threads threads into out, contiguous [n, out_h,
// out_w, 3] RGB8.  crop != 0: frame i is the window [y0[i], y0[i] + out_h)
// x [x0[i], x0[i] + out_w) of its image, which must lie inside it;
// crop == 0: the whole image, which must be out_h x out_w.  status[i] is
// frame i's Status; returns the number of frames that failed.
int pfnl_decode_crop_batch(const char** paths, int n, const int* y0, const int* x0, int out_h,
                           int out_w, int crop, unsigned char* out, int* status,
                           int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t frame = static_cast<size_t>(out_h) * out_w * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img;
      Status why;
      if (!decode_png_file(paths[i], &img, &why)) {
        status[i] = why;
        failures.fetch_add(1);
        continue;
      }
      int64_t oy = crop ? y0[i] : 0;
      int64_t ox = crop ? x0[i] : 0;
      bool inside = crop ? (oy >= 0 && ox >= 0 && oy + out_h <= img.h && ox + out_w <= img.w)
                         : (img.h == static_cast<uint32_t>(out_h) &&
                            img.w == static_cast<uint32_t>(out_w));
      if (!inside) {
        status[i] = kOutOfBounds;
        failures.fetch_add(1);
        continue;
      }
      unsigned char* dst = out + static_cast<size_t>(i) * frame;
      for (int r = 0; r < out_h; ++r)
        std::memcpy(dst + static_cast<size_t>(r) * out_w * 3,
                    img.rgb.data() + ((oy + r) * img.w + ox) * 3, static_cast<size_t>(out_w) * 3);
      status[i] = kOk;
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Encode [h, w, channels] uint8 (channels 3: RGB, 1: gray) to a PNG file.
// Returns 0 on success, 1 if the file cannot be opened, 2 if compressing
// or writing fails, 3 for arguments out of range.
int pfnl_encode_png(const char* path, const unsigned char* data, int h, int w, int channels_) {
  if (h <= 0 || w <= 0 || (channels_ != 1 && channels_ != 3)) return 3;
  const size_t rb = static_cast<size_t>(w) * channels_;
  std::vector<unsigned char> raw(static_cast<size_t>(h) * (rb + 1));
  for (int r = 0; r < h; ++r) {
    raw[r * (rb + 1)] = 0;  // filter None
    std::memcpy(&raw[r * (rb + 1) + 1], data + r * rb, rb);
  }
  uLongf zlen = compressBound(raw.size());
  if (zlen > kMaxChunk) return 3;
  std::vector<unsigned char> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), raw.size(), 1) != Z_OK) return 2;

  unsigned char ihdr[13];
  put_be32(ihdr, static_cast<uint32_t>(w));
  put_be32(ihdr + 4, static_cast<uint32_t>(h));
  ihdr[8] = 8;                          // bit depth
  ihdr[9] = channels_ == 3 ? 2 : 0;     // colour type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;   // deflate, adaptive filtering, no interlace
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 1;
  bool ok = std::fwrite(kSignature, 1, 8, fp) == 8 && write_chunk(fp, "IHDR", ihdr, 13) &&
            write_chunk(fp, "IDAT", z.data(), static_cast<uint32_t>(zlen)) &&
            write_chunk(fp, "IEND", nullptr, 0);
  ok = (std::fclose(fp) == 0) && ok;
  return ok ? 0 : 2;
}

}  // extern "C"
