// Native data-loader runtime for modular_slam_tpu.
//
// The reference's data path is C++ (RgbdFileProvider decoding PNGs with
// cv::imread on the caller thread, rgbd_file_provider.cpp:55-102).  This
// rebuild keeps the loader native but makes it *asynchronous*: a
// libpng decoder plus a multi-threaded prefetch ring so host decode
// overlaps device compute — the host must never starve the device.
//
// C ABI (ctypes-friendly), see modular_slam_tpu/io/native.py:
//   msl_png_info(path, &w, &h, &channels, &bit_depth) -> 0 on success
//   msl_png_read(path, out_buffer)                    -> 0 on success
//       (buffer layout: row-major; 8-bit RGB -> uint8 [h][w][3],
//        16-bit gray -> uint16 [h][w] host-endian)
//   msl_prefetch_create(rgb_paths, depth_paths, n, n_threads, ring) -> handle
//   msl_prefetch_get(handle, idx, rgb_out, depth_out, &w, &h) -> 0
//       (blocks until frame idx is decoded; idx must be consumed in order
//        of request, arbitrary strides supported)
//   msl_prefetch_destroy(handle)

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, channels = 0, bit_depth = 0;
  std::vector<uint8_t> data;  // 8-bit: RGB interleaved; 16-bit: native u16
};

bool read_png(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int w = png_get_image_width(png, info);
  int h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // normalize: palettes -> RGB, gray8 expand, strip alpha; keep 16-bit gray
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (depth == 16) png_set_swap(png);  // little-endian host
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  depth = png_get_bit_depth(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);

  out->w = w;
  out->h = h;
  out->channels = channels;
  out->bit_depth = depth;
  out->data.resize(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

// Luma conversion IN THE DECODE THREADS (wire-format streaming,
// io/tum.py wire_iter): 0.299/0.587/0.114 rounded to uint8 — the
// reference's own grayscale semantics (frame.cpp toGrayScale, CV_8U).
// Doing it here overlaps the ~1 ms/frame conversion with PNG decode
// instead of spending main-thread time per chunk.
void rgb_to_luma(Image* img) {
  if (img->channels != 3 || img->bit_depth != 8) return;
  const size_t n = static_cast<size_t>(img->w) * img->h;
  std::vector<uint8_t> gray(n);
  const uint8_t* src = img->data.data();
  for (size_t i = 0; i < n; ++i) {
    const float v = 0.299f * src[3 * i] + 0.587f * src[3 * i + 1] +
                    0.114f * src[3 * i + 2];
    gray[i] = static_cast<uint8_t>(v + 0.5f);
  }
  img->data = std::move(gray);
  img->channels = 1;
}

struct Prefetcher {
  std::vector<std::string> rgb_paths, depth_paths;
  int ring = 8;
  bool to_gray = false;
  std::map<int, std::pair<Image, Image>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<int> next_to_decode{0};
  std::atomic<int> consumed{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      if (stop.load()) return;
      int idx = next_to_decode.fetch_add(1);
      if (idx >= static_cast<int>(rgb_paths.size())) return;
      Image rgb, dep;
      bool ok = read_png(rgb_paths[idx].c_str(), &rgb) &&
                read_png(depth_paths[idx].c_str(), &dep);
      (void)ok;  // failed frames surface as w==0 at get()
      if (to_gray) rgb_to_luma(&rgb);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() ||
               idx < consumed.load() + ring;  // bounded ring
      });
      if (stop.load()) return;
      ready.emplace(idx, std::make_pair(std::move(rgb), std::move(dep)));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int msl_png_info(const char* path, int* w, int* h, int* channels,
                 int* bit_depth) {
  Image img;
  if (!read_png(path, &img)) return -1;
  *w = img.w;
  *h = img.h;
  *channels = img.channels;
  *bit_depth = img.bit_depth;
  return 0;
}

int msl_png_read(const char* path, uint8_t* out) {
  Image img;
  if (!read_png(path, &img)) return -1;
  std::memcpy(out, img.data.data(), img.data.size());
  return 0;
}

void* msl_prefetch_create2(const char** rgb_paths, const char** depth_paths,
                           int n, int n_threads, int ring, int to_gray) {
  auto* p = new Prefetcher();
  p->rgb_paths.assign(rgb_paths, rgb_paths + n);
  p->depth_paths.assign(depth_paths, depth_paths + n);
  p->ring = ring > 0 ? ring : 8;
  p->to_gray = to_gray != 0;
  int nt = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

void* msl_prefetch_create(const char** rgb_paths, const char** depth_paths,
                          int n, int n_threads, int ring) {
  return msl_prefetch_create2(rgb_paths, depth_paths, n, n_threads, ring, 0);
}

int msl_prefetch_get(void* handle, int idx, uint8_t* rgb_out,
                     uint8_t* depth_out, int* w, int* h) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] { return p->ready.count(idx) > 0; });
  auto it = p->ready.find(idx);
  Image& rgb = it->second.first;
  Image& dep = it->second.second;
  if (rgb.w == 0 || dep.w == 0) {
    p->ready.erase(it);
    return -1;
  }
  *w = rgb.w;
  *h = rgb.h;
  std::memcpy(rgb_out, rgb.data.data(), rgb.data.size());
  std::memcpy(depth_out, dep.data.data(), dep.data.size());
  p->ready.erase(it);
  p->consumed.store(idx + 1);
  p->cv_space.notify_all();
  return 0;
}

void msl_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
