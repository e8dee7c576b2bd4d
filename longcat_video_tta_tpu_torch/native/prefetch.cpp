// Threaded video-clip prefetch loader (C++17, no external deps), the
// PyTorch port's copy of longcat_video_tta_tpu/native/prefetch.cpp built
// without its libav decoder: the port reads .npy clips only.
//
// Worker threads read .npy clips (uint8 [T, H, W, 3]), select/pad the
// requested frame window, bilinear-resize to the target geometry, and
// normalize to float32 [-1, 1] in [3, T, H, W] layout. Prepared clips
// park in a bounded ring; the consumer (the runner's per-video loop)
// pops without ever blocking on disk or resize work.
//
// C ABI (driven from Python via ctypes — see data/native_loader.py):
//   pf_create(paths, n, num_frames, start_frame, height, width,
//             workers, queue_cap, target_fps) -> handle
//   pf_next(handle, out_float32, index_out) -> 0 ok / 1 done / <0 error
//     (-2 = this clip failed to decode; index_out names it and the
//      stream continues with the next clip — per-clip fault tolerance)
//   pf_destroy(handle)
//
// target_fps > 0 subsamples by stride round(24 / target_fps) (.npy clips
// carry no fps: 24 by convention), with start_frame counted in the
// SUBSAMPLED timebase (matches data/video_io.py::decode_frames).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>


namespace {

struct Clip {
  long index = -1;
  std::vector<float> data;  // [3, T, H, W]
  bool ok = false;
};

// ---------------------------------------------------------------------
// Minimal .npy reader: uint8, C-order, shape (T, H, W, 3)
// ---------------------------------------------------------------------
bool read_npy_u8(const std::string& path, std::vector<uint8_t>& out,
                 long shape[4]) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char magic[6];
  f.read(magic, 6);
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  uint8_t ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t header_len = 0;
  if (ver[0] == 1) {
    uint16_t h16;
    f.read(reinterpret_cast<char*>(&h16), 2);
    header_len = h16;
  } else {
    f.read(reinterpret_cast<char*>(&header_len), 4);
  }
  std::string header(header_len, '\0');
  f.read(header.data(), header_len);
  if (header.find("'|u1'") == std::string::npos &&
      header.find("'uint8'") == std::string::npos)
    return false;
  if (header.find("'fortran_order': True") != std::string::npos) return false;
  auto lp = header.find('(');
  auto rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string dims = header.substr(lp + 1, rp - lp - 1);
  int nd = 0;
  size_t pos = 0;
  while (nd < 4 && pos < dims.size()) {
    size_t end = dims.find(',', pos);
    std::string tok = dims.substr(pos, end == std::string::npos
                                           ? std::string::npos
                                           : end - pos);
    // trim
    size_t a = tok.find_first_not_of(" \t");
    if (a != std::string::npos) {
      shape[nd++] = std::stol(tok.substr(a));
    }
    if (end == std::string::npos) break;
    pos = end + 1;
  }
  if (nd != 4 || shape[3] != 3) return false;
  size_t total = 1;
  for (int i = 0; i < 4; i++) total *= static_cast<size_t>(shape[i]);
  out.resize(total);
  f.read(reinterpret_cast<char*>(out.data()),
         static_cast<std::streamsize>(total));
  return static_cast<size_t>(f.gcount()) == total;
}

// Bilinear resize one frame [h, w, 3] u8 -> [H, W] float per channel,
// written into planes[c][t] at CHW-by-frame offsets.
void resize_frame_to(const uint8_t* src, long sh, long sw, float* dst_c0,
                     float* dst_c1, float* dst_c2, long H, long W) {
  const float sy = static_cast<float>(sh) / static_cast<float>(H);
  const float sx = static_cast<float>(sw) / static_cast<float>(W);
  for (long y = 0; y < H; ++y) {
    float fy = (static_cast<float>(y) + 0.5f) * sy - 0.5f;
    long y0 = fy < 0 ? 0 : static_cast<long>(fy);
    long y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - static_cast<float>(y0);
    if (wy < 0) wy = 0;
    for (long x = 0; x < W; ++x) {
      float fx = (static_cast<float>(x) + 0.5f) * sx - 0.5f;
      long x0 = fx < 0 ? 0 : static_cast<long>(fx);
      long x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - static_cast<float>(x0);
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * sw + x0) * 3 + c];
        float v01 = src[(y0 * sw + x1) * 3 + c];
        float v10 = src[(y1 * sw + x0) * 3 + c];
        float v11 = src[(y1 * sw + x1) * 3 + c];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                  wy * ((1 - wx) * v10 + wx * v11);
        float* dst = c == 0 ? dst_c0 : (c == 1 ? dst_c1 : dst_c2);
        dst[y * W + x] = v / 255.0f * 2.0f - 1.0f;
      }
    }
  }
}


struct Prefetcher {
  std::vector<std::string> paths;
  long num_frames, start_frame, H, W;
  double target_fps;
  size_t queue_cap;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Clip> ready;
  std::atomic<long> next_job{0};
  long next_emit = 0;  // clips are emitted in order
  std::vector<Clip> staging;  // out-of-order completion buffer
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  Prefetcher(std::vector<std::string> p, long nf, long sf, long h, long w,
             int n_workers, size_t cap, double fps)
      : paths(std::move(p)), num_frames(nf), start_frame(sf), H(h), W(w),
        target_fps(fps), queue_cap(cap) {
    for (int i = 0; i < n_workers; ++i)
      workers.emplace_back([this] { this->work(); });
  }

  ~Prefetcher() {
    stop = true;
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers) t.join();
  }

  Clip load(long idx) {
    Clip c;
    c.index = idx;
    const std::string& path = paths[static_cast<size_t>(idx)];
    bool is_npy = path.size() > 4 &&
                  path.compare(path.size() - 4, 4, ".npy") == 0;
    if (!is_npy) return c;  // .npy clips only: any other file fails
    std::vector<uint8_t> raw;
    long shape[4];
    if (!read_npy_u8(path, raw, shape)) return c;
    long T_src = shape[0], sh = shape[1], sw = shape[2];
    long T = num_frames;
    long stride = 1;
    if (target_fps > 0) {
      // npy clips carry no fps metadata: 24 fps by convention
      // (matches data/video_io.py::decode_frames); half-to-even like
      // Python's round()
      stride = static_cast<long>(std::nearbyint(24.0 / target_fps));
      if (stride < 1) stride = 1;
    }
    if (start_frame * stride >= T_src) {
      // the subsampled window starts past EOF: the Python loader
      // raises ('No frames decoded') and the clip fails with
      // attribution — silently padding a frozen last-frame clip here
      // would train/evaluate on garbage instead
      return c;
    }
    c.data.resize(static_cast<size_t>(3 * T * H * W));
    float* base = c.data.data();
    size_t plane = static_cast<size_t>(T * H * W);
    for (long t = 0; t < T; ++t) {
      // start_frame skip (subsampled timebase) + pad-last-frame
      // (reference decode contract); pad repeats the last frame ON the
      // stride grid, matching video_io.py's frames[-1]
      long src_t = (start_frame + t) * stride;
      if (src_t >= T_src) {
        // pad repeats the last frame ON the stride grid (frames[-1])
        long base_off = start_frame * stride;
        src_t = base_off + ((T_src - 1 - base_off) / stride) * stride;
      }
      if (src_t < 0) src_t = 0;
      const uint8_t* frame = raw.data() + src_t * sh * sw * 3;
      size_t off = static_cast<size_t>(t * H * W);
      resize_frame_to(frame, sh, sw, base + off, base + plane + off,
                      base + 2 * plane + off, H, W);
    }
    c.ok = true;
    return c;
  }

  void work() {
    while (!stop) {
      long idx = next_job.fetch_add(1);
      if (idx >= static_cast<long>(paths.size())) return;
      Clip c = load(idx);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [this] {
        return stop || ready.size() + staging.size() < queue_cap + 4;
      });
      if (stop) return;
      staging.push_back(std::move(c));
      // drain staging in index order
      bool moved = true;
      while (moved) {
        moved = false;
        for (size_t i = 0; i < staging.size(); ++i) {
          if (staging[i].index == next_emit) {
            ready.push_back(std::move(staging[i]));
            staging.erase(staging.begin() + static_cast<long>(i));
            ++next_emit;
            moved = true;
            break;
          }
        }
      }
      cv_pop.notify_all();
    }
  }

  // 0 ok, 1 exhausted
  int next(float* out, long* index_out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [this] {
      return stop || !ready.empty() ||
             (next_emit >= static_cast<long>(paths.size()) &&
              staging.empty() && ready.empty());
    });
    if (ready.empty()) return 1;
    Clip c = std::move(ready.front());
    ready.pop_front();
    cv_push.notify_all();
    lk.unlock();
    // name the clip even on failure so the caller can attribute the
    // error to ONE video and keep consuming the stream
    *index_out = c.index;
    if (!c.ok) return -2;
    std::memcpy(out, c.data.data(), c.data.size() * sizeof(float));
    return 0;
  }
};

}  // namespace

extern "C" {

void* pf_create(const char** paths, long n_paths, long num_frames,
                long start_frame, long height, long width, int workers,
                long queue_cap, double target_fps) {
  std::vector<std::string> p;
  p.reserve(static_cast<size_t>(n_paths));
  for (long i = 0; i < n_paths; ++i) p.emplace_back(paths[i]);
  return new Prefetcher(std::move(p), num_frames, start_frame, height,
                        width, workers > 0 ? workers : 2,
                        queue_cap > 0 ? static_cast<size_t>(queue_cap) : 4,
                        target_fps);
}

int pf_next(void* handle, float* out, long* index_out) {
  return static_cast<Prefetcher*>(handle)->next(out, index_out);
}

void pf_destroy(void* handle) { delete static_cast<Prefetcher*>(handle); }

}  // extern "C"
