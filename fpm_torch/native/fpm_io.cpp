// fpm_io.cpp — native ingestion runtime for fpm-tpu.
//
// TPU-native equivalent of the reference's C++ ingestion path
// (loadFPMDataset, fpmMain.cpp:36-271: cv::imread TIFF decode + ROI crop +
// darkfield exposure divide + two-window background estimate/subtract),
// which accounted for ~12% of the reference's runtime (cv::imread 11.9%,
// TIFFReadEncodedStrip 10.4% — BASELINE.md). This library decodes a stack of
// TIFF frames and runs the full preprocess pipeline across a thread pool,
// writing directly into a caller-provided uint16 buffer that is shipped to
// the TPU once (the reference instead re-touched host memory per LED inside
// its hot loop, fpmMain.cpp:380-381).
//
// Supported input: classic TIFF (II/MM), 8/16-bit, grayscale or chunky RGB
// (the reference's datasets are 16-bit TIFFs; fpmMain.cpp:119), in strip or
// tile organization, uncompressed / LZW / Deflate (zlib), with horizontal
// predictor — i.e. the encodings real microscope acquisition software
// writes. Anything else is flagged per-file and falls back to the Python
// (PIL) path in the caller. Exposed via a C ABI consumed with ctypes
// (fpm_tpu/native/__init__.py).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  std::vector<uint16_t> data;  // plane-major (planes, h, w), row-major planes
  int w = 0, h = 0;
  int planes = 1;  // 1 (single kept channel) or 3 (RGB planes, all-channel mode)

  const uint16_t* plane(int c) const {
    return data.data() + (size_t)(c < planes ? c : 0) * w * h;
  }
};

struct Reader {
  const uint8_t* p;
  size_t n;
  bool big_endian;

  uint16_t u16(size_t off) const {
    if (off + 2 > n) return 0;
    return big_endian ? (uint16_t)((p[off] << 8) | p[off + 1])
                      : (uint16_t)(p[off] | (p[off + 1] << 8));
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > n) return 0;
    return big_endian
               ? ((uint32_t)p[off] << 24) | ((uint32_t)p[off + 1] << 16) |
                     ((uint32_t)p[off + 2] << 8) | p[off + 3]
               : (uint32_t)p[off] | ((uint32_t)p[off + 1] << 8) |
                     ((uint32_t)p[off + 2] << 16) | ((uint32_t)p[off + 3] << 24);
  }
};

constexpr int kTypeSizes[] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8};

// Read the i-th value of an IFD entry (SHORT or LONG).
uint32_t entry_value(const Reader& r, size_t entry_off, uint32_t index) {
  uint16_t type = r.u16(entry_off + 2);
  uint32_t count = r.u32(entry_off + 4);
  size_t tsz = (type < 13) ? kTypeSizes[type] : 1;
  size_t total = (size_t)count * tsz;
  size_t base = (total <= 4) ? entry_off + 8 : r.u32(entry_off + 8);
  size_t off = base + (size_t)index * tsz;
  if (type == 3) return r.u16(off);
  if (type == 4) return r.u32(off);
  if (type == 1) return (off < r.n) ? r.p[off] : 0;
  return 0;
}

// TIFF LZW decompression (spec §13): MSB-first variable-width codes 9→12
// bits with the "early change" width bump at next_code == (1<<width)-1,
// code 256 = clear, 257 = end-of-information.
bool lzw_decode(const uint8_t* p, size_t n, uint8_t* dst, size_t cap) {
  static thread_local std::vector<int> prefix(4096);
  static thread_local std::vector<uint8_t> suffix(4096), stack(4096);
  int width = 9, next = 258, prev = -1;
  uint64_t bitbuf = 0;
  int bits = 0;
  size_t pos = 0, out = 0;

  auto getcode = [&]() -> int {
    while (bits < width) {
      if (pos >= n) return 257;
      bitbuf = (bitbuf << 8) | p[pos++];
      bits += 8;
    }
    bits -= width;
    return (int)((bitbuf >> bits) & ((1u << width) - 1));
  };
  auto first_of = [&](int code) -> uint8_t {
    while (code >= 258) code = prefix[code];
    return (uint8_t)code;
  };
  auto emit = [&](int code) -> bool {  // write string(code), return ok
    int sp = 0;
    while (code >= 258) {
      if (sp >= 4096) return false;
      stack[sp++] = suffix[code];
      code = prefix[code];
    }
    if (out + sp + 1 > cap) return false;
    dst[out++] = (uint8_t)code;
    while (sp) dst[out++] = stack[--sp];
    return true;
  };

  for (;;) {
    int code = getcode();
    if (code == 257) break;
    if (code == 256) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255 || out >= cap) return false;
      dst[out++] = (uint8_t)code;
    } else {
      if (code > next || next >= 4096) return false;
      if (code == next) {  // KwKwK: string(prev) + first(string(prev))
        prefix[next] = prev;
        suffix[next] = first_of(prev);
        next++;
        if (!emit(code)) return false;
      } else {
        if (!emit(code)) return false;
        prefix[next] = prev;
        suffix[next] = first_of(code);
        next++;
      }
      if (next == (1 << width) - 1 && width < 12) width++;  // early change
    }
    prev = code;
  }
  return out == cap;
}

bool zlib_decode(const uint8_t* p, size_t n, uint8_t* dst, size_t cap) {
  uLongf out_len = cap;
  return uncompress(dst, &out_len, p, n) == Z_OK && out_len == cap;
}

// Horizontal-differencing predictor (TIFF tag 317 == 2): samples are stored
// as deltas from the previous pixel's same channel; integrate per row.
// 16-bit samples are differenced as u16 values in FILE byte order.
void undo_predictor2(uint8_t* data, size_t nrows, size_t width, int spp,
                     int bits, bool big_endian) {
  size_t row_bytes = width * spp * (bits / 8);
  for (size_t r = 0; r < nrows; r++) {
    uint8_t* row = data + r * row_bytes;
    if (bits == 8) {
      for (size_t i = spp; i < width * spp; i++) row[i] = (uint8_t)(row[i] + row[i - spp]);
    } else {
      for (size_t i = spp; i < width * spp; i++) {
        size_t a = 2 * (i - spp), b = 2 * i;
        uint16_t pv = big_endian ? (uint16_t)((row[a] << 8) | row[a + 1])
                                 : (uint16_t)(row[a] | (row[a + 1] << 8));
        uint16_t cv = big_endian ? (uint16_t)((row[b] << 8) | row[b + 1])
                                 : (uint16_t)(row[b] | (row[b + 1] << 8));
        uint16_t s = (uint16_t)(cv + pv);
        if (big_endian) {
          row[b] = (uint8_t)(s >> 8);
          row[b + 1] = (uint8_t)s;
        } else {
          row[b] = (uint8_t)s;
          row[b + 1] = (uint8_t)(s >> 8);
        }
      }
    }
  }
}

// Decode first IFD of a classic TIFF. channel_rgb: -1 = grayscale/first,
// -2 = keep ALL channels as planes (RGB decode-once mode), else RGB channel
// index to keep.
bool decode_tiff(const std::string& path, Image& out, int channel_rgb) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)sz);
  if (fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    fclose(f);
    return false;
  }
  fclose(f);
  if (sz < 8) return false;

  Reader r{buf.data(), (size_t)sz, false};
  if (buf[0] == 'M' && buf[1] == 'M')
    r.big_endian = true;
  else if (!(buf[0] == 'I' && buf[1] == 'I'))
    return false;
  if (r.u16(2) != 42) return false;

  size_t ifd = r.u32(4);
  uint16_t n_entries = r.u16(ifd);
  uint32_t width = 0, height = 0, bits = 1, compression = 1, spp = 1;
  uint32_t rows_per_strip = 0xFFFFFFFF, predictor = 1;
  uint32_t tile_w = 0, tile_h = 0;
  size_t strip_offsets_entry = 0, strip_counts_entry = 0;
  size_t tile_offsets_entry = 0, tile_counts_entry = 0;
  uint32_t n_strips = 0, n_tiles = 0;

  for (uint16_t i = 0; i < n_entries; i++) {
    size_t e = ifd + 2 + (size_t)i * 12;
    uint16_t tag = r.u16(e);
    switch (tag) {
      case 256: width = entry_value(r, e, 0); break;
      case 257: height = entry_value(r, e, 0); break;
      case 258: bits = entry_value(r, e, 0); break;
      case 259: compression = entry_value(r, e, 0); break;
      case 277: spp = entry_value(r, e, 0); break;
      case 278: rows_per_strip = entry_value(r, e, 0); break;
      case 273:
        strip_offsets_entry = e;
        n_strips = r.u32(e + 4);
        break;
      case 279: strip_counts_entry = e; break;
      case 317: predictor = entry_value(r, e, 0); break;
      case 322: tile_w = entry_value(r, e, 0); break;
      case 323: tile_h = entry_value(r, e, 0); break;
      case 324:
        tile_offsets_entry = e;
        n_tiles = r.u32(e + 4);
        break;
      case 325: tile_counts_entry = e; break;
      default: break;
    }
  }
  // Compression 1 = none, 5 = LZW, 8/32946 = Deflate (zlib). Predictor 2 =
  // horizontal differencing (the only one LZW/Deflate writers use for
  // integer data). Anything else → per-file Python fallback.
  const bool tiled = tile_offsets_entry != 0;
  if (!width || !height || (!strip_offsets_entry && !tiled)) return false;
  if (compression != 1 && compression != 5 && compression != 8 &&
      compression != 32946)
    return false;
  if (predictor != 1 && predictor != 2) return false;
  if (bits != 8 && bits != 16) return false;
  if (spp != 1 && spp != 3) return false;
  if (rows_per_strip == 0) rows_per_strip = height;
  if (tiled && (!tile_w || !tile_h)) return false;

  bool all_channels = (channel_rgb == -2);
  out.w = (int)width;
  out.h = (int)height;
  out.planes = all_channels ? (int)spp : 1;
  out.data.assign((size_t)width * height * out.planes, 0);

  int ch0 = (spp == 3) ? ((channel_rgb >= 0 && channel_rgb < 3) ? channel_rgb : 0) : 0;
  size_t bytes_per_px = (bits / 8) * spp;
  size_t plane_px = (size_t)width * height;
  std::vector<uint8_t> scratch;

  // Copy a decoded block of rows into the output planes, clipping to the
  // image. src rows are (block_w * bytes_per_px) apart, chunky layout.
  auto blit = [&](const uint8_t* src, size_t block_w, size_t row0,
                  size_t col0, size_t nrows, size_t ncols) {
    for (size_t dy = 0; dy < nrows && row0 + dy < height; dy++) {
      const uint8_t* srow = src + dy * block_w * bytes_per_px;
      for (int c = 0; c < out.planes; c++) {
        int ch = all_channels ? c : ch0;
        uint16_t* dst =
            out.data.data() + (size_t)c * plane_px + (row0 + dy) * width + col0;
        size_t nx = ncols;
        if (col0 + nx > width) nx = width - col0;
        for (size_t x = 0; x < nx; x++) {
          const uint8_t* px = srow + x * bytes_per_px + (size_t)ch * (bits / 8);
          if (bits == 8)
            dst[x] = px[0];
          else
            dst[x] = r.big_endian ? (uint16_t)((px[0] << 8) | px[1])
                                  : (uint16_t)(px[0] | (px[1] << 8));
        }
      }
    }
  };

  // Decode one compressed (or raw) block of `nrows` rows of `block_w`
  // pixels; returns the pointer to decoded bytes (file buffer for raw,
  // scratch for compressed) or nullptr.
  auto decode_block = [&](size_t off, size_t cnt, size_t block_w,
                          size_t nrows) -> const uint8_t* {
    size_t want = block_w * bytes_per_px * nrows;
    if (compression == 1) {
      if (off + want > (size_t)sz) return nullptr;
      if (predictor == 2) {
        scratch.assign(buf.data() + off, buf.data() + off + want);
        undo_predictor2(scratch.data(), nrows, block_w, (int)spp, (int)bits,
                        r.big_endian);
        return scratch.data();
      }
      return buf.data() + off;
    }
    if (off + cnt > (size_t)sz) return nullptr;
    scratch.resize(want);
    bool ok = (compression == 5)
                  ? lzw_decode(buf.data() + off, cnt, scratch.data(), want)
                  : zlib_decode(buf.data() + off, cnt, scratch.data(), want);
    if (!ok) return nullptr;
    if (predictor == 2)
      undo_predictor2(scratch.data(), nrows, block_w, (int)spp, (int)bits,
                      r.big_endian);
    return scratch.data();
  };

  if (tiled) {
    size_t across = (width + tile_w - 1) / tile_w;
    size_t down = (height + tile_h - 1) / tile_h;
    if (n_tiles < across * down) return false;
    for (size_t t = 0; t < across * down; t++) {
      size_t off = entry_value(r, tile_offsets_entry, (uint32_t)t);
      size_t cnt = tile_counts_entry
                       ? entry_value(r, tile_counts_entry, (uint32_t)t)
                       : (size_t)tile_w * tile_h * bytes_per_px;
      const uint8_t* src = decode_block(off, cnt, tile_w, tile_h);
      if (!src) return false;
      blit(src, tile_w, (t / across) * tile_h, (t % across) * tile_w, tile_h,
           tile_w);
    }
    return true;
  }

  size_t row_bytes = (size_t)width * bytes_per_px;
  // Coverage check (mirrors the tiled path): a truncated IFD can leave
  // n_strips == 0, which would make the loop below a vacuous success over
  // the zero-filled buffer — silent corruption instead of a flagged file.
  if ((size_t)n_strips * rows_per_strip < height) return false;
  for (uint32_t s = 0; s < n_strips; s++) {
    size_t off = entry_value(r, strip_offsets_entry, s);
    size_t row0 = (size_t)s * rows_per_strip;
    if (row0 >= height) break;
    size_t nrows = rows_per_strip;
    if (row0 + nrows > height) nrows = height - row0;
    size_t cnt = strip_counts_entry ? entry_value(r, strip_counts_entry, s)
                                    : row_bytes * nrows;
    if (compression == 1 && cnt < row_bytes * nrows)
      nrows = cnt / row_bytes;  // tolerate short raw strips
    const uint8_t* src = decode_block(off, cnt, width, nrows);
    if (!src) return false;
    blit(src, width, row0, 0, nrows, width);
  }
  return true;
}

// Mean over a window clamped to image bounds (matches the Python loader's
// clamped-slice mean; the reference assumes in-bounds windows).
double window_mean(const Image& im, int c, int x0, int y0, int n) {
  const uint16_t* p = im.plane(c);
  long long sum = 0;
  long count = 0;
  for (int y = y0; y < y0 + n && y < im.h; y++) {
    if (y < 0) continue;
    for (int x = x0; x < x0 + n && x < im.w; x++) {
      if (x < 0) continue;
      sum += p[(size_t)y * im.w + x];
      count++;
    }
  }
  return count ? (double)sum / count : 0.0;
}

struct Job {
  const char** paths;
  int n, crop_x, crop_y, np_size, bk1x, bk1y, bk2x, bk2y;
  double bg_threshold;
  int darkfield_mult;
  const uint8_t* is_darkfield;
  int color_channel;  // BGR index, -1 = grayscale, -2 = all 3 RGB planes
  // Full-frame mode (large-FOV ingest): skip the ROI crop, write whole
  // (frame_h, frame_w) frames; frames of any other size are flagged for
  // the caller's Python fallback. frame_w == 0 selects ROI mode.
  int frame_w = 0, frame_h = 0;
  uint16_t* out_images;
  int16_t* out_bgs;
  uint8_t* out_status;  // per image: 0 = ok, 1 = decode/crop failed
  std::atomic<int> next{0};
  std::atomic<int> n_failed{0};
};

void worker(Job* job) {
  // The reference keeps OpenCV BGR channel 2 = red (fpmMain.cpp:115,
  // quirk 3); TIFF stores RGB, so BGR idx 2 → RGB idx 0. color_channel -2
  // selects the RGB decode-once mode: one decode per file, all 3 planes
  // preprocessed independently and written as (i, 3, h, w).
  bool rgb_all = job->color_channel == -2;
  int channel_rgb = rgb_all ? -2 : -1;
  if (job->color_channel >= 0) channel_rgb = 2 - job->color_channel;
  bool full_frame = job->frame_w > 0;
  int out_planes = rgb_all ? 3 : 1;

  for (;;) {
    int i = job->next.fetch_add(1);
    if (i >= job->n) break;
    job->out_status[i] = 0;
    Image im;
    int n = job->np_size;
    // Unsupported encodings (compressed/tiled TIFF, other formats) are
    // flagged per-file; the caller re-decodes those through the Python
    // path instead of failing the whole stack.
    bool ok = decode_tiff(job->paths[i], im, channel_rgb);
    if (ok) {
      ok = full_frame ? (im.w == job->frame_w && im.h == job->frame_h)
                      : (job->crop_x + n <= im.w && job->crop_y + n <= im.h);
    }
    if (!ok) {
      job->out_status[i] = 1;
      for (int c = 0; c < out_planes; c++) job->out_bgs[i * out_planes + c] = 0;
      job->n_failed.fetch_add(1);
      continue;
    }
    bool dark = job->is_darkfield[i] != 0 && job->darkfield_mult != 1;
    int out_h = full_frame ? im.h : n;
    int out_w = full_frame ? im.w : n;
    int y0 = full_frame ? 0 : job->crop_y;
    int x0 = full_frame ? 0 : job->crop_x;

    for (int c = 0; c < out_planes; c++) {
      // Per-plane background estimate from that plane's full frame
      // (fpmMain.cpp:131-140) — bit-identical to running the single-channel
      // pipeline once per channel.
      double bg = 0.5 * (window_mean(im, c, job->bk1x, job->bk1y, n) +
                         window_mean(im, c, job->bk2x, job->bk2y, n));
      if (bg > job->bg_threshold) bg = job->bg_threshold;
      int bg_i = (int)lround(bg);
      job->out_bgs[i * out_planes + c] = (int16_t)bg_i;

      const uint16_t* plane = im.plane(c);
      uint16_t* dst =
          job->out_images + ((size_t)i * out_planes + c) * out_h * out_w;
      for (int y = 0; y < out_h; y++) {
        const uint16_t* src = plane + (size_t)(y0 + y) * im.w + x0;
        for (int x = 0; x < out_w; x++) {
          double v = src[x];
          if (dark) v = std::nearbyint(v / job->darkfield_mult);  // cvRound
          v -= bg_i;                                              // saturating
          if (v < 0) v = 0;
          if (v > 65535) v = 65535;
          dst[(size_t)y * out_w + x] = (uint16_t)v;
        }
      }
    }
  }
}

}  // namespace

namespace {

int run_job(Job& job, int n, int num_threads) {
  int nt = num_threads > 0 ? num_threads
                           : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; t++) threads.emplace_back(worker, &job);
  for (auto& t : threads) t.join();
  return job.n_failed.load();  // count of per-file failures (see out_status)
}

}  // namespace

// ABI version for the ctypes binding (fpm_tpu/native/__init__.py refuses a
// stale prebuilt library instead of calling it with the wrong signature).
// v4: color_channel == -2 selects RGB decode-once mode — out_images must be
// (n, 3, np, np) and out_bgs (n, 3), RGB plane order.
extern "C" int fpm_abi_version() { return 4; }

extern "C" int fpm_load_stack(
    const char** paths, int n, int crop_x, int crop_y, int np_size, int bk1x,
    int bk1y, int bk2x, int bk2y, double bg_threshold, int darkfield_mult,
    const uint8_t* is_darkfield, int color_channel, int num_threads,
    uint16_t* out_images, int16_t* out_bgs, uint8_t* out_status) {
  Job job;
  job.paths = paths;
  job.n = n;
  job.crop_x = crop_x;
  job.crop_y = crop_y;
  job.np_size = np_size;
  job.bk1x = bk1x;
  job.bk1y = bk1y;
  job.bk2x = bk2x;
  job.bk2y = bk2y;
  job.bg_threshold = bg_threshold;
  job.darkfield_mult = darkfield_mult;
  job.is_darkfield = is_darkfield;
  job.color_channel = color_channel;
  job.out_images = out_images;
  job.out_bgs = out_bgs;
  job.out_status = out_status;
  return run_job(job, n, num_threads);
}

// Full-frame variant for the large-FOV ingest (models/largefov.py): same
// decode + darkfield + background-subtract pipeline, no ROI crop. Frames
// must all be (frame_h, frame_w); others are flagged for Python fallback.
extern "C" int fpm_load_frames(
    const char** paths, int n, int frame_w, int frame_h, int np_size,
    int bk1x, int bk1y, int bk2x, int bk2y, double bg_threshold,
    int darkfield_mult, const uint8_t* is_darkfield, int color_channel,
    int num_threads, uint16_t* out_images, int16_t* out_bgs,
    uint8_t* out_status) {
  Job job;
  job.paths = paths;
  job.n = n;
  job.crop_x = 0;
  job.crop_y = 0;
  job.np_size = np_size;  // background windows stay Np-sized
  job.bk1x = bk1x;
  job.bk1y = bk1y;
  job.bk2x = bk2x;
  job.bk2y = bk2y;
  job.bg_threshold = bg_threshold;
  job.darkfield_mult = darkfield_mult;
  job.is_darkfield = is_darkfield;
  job.color_channel = color_channel;
  job.frame_w = frame_w;
  job.frame_h = frame_h;
  job.out_images = out_images;
  job.out_bgs = out_bgs;
  job.out_status = out_status;
  return run_job(job, n, num_threads);
}
