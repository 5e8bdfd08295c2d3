// Native EuRoC data loader: CSV parsing, grayscale PNG decode, threaded
// prefetch ring. Native equivalent of the reference driver's host-side IO
// (Examples/Monocular/mono_EuRoC_vins.cc LoadImages/LoadImus + the per-frame
// IMU slicing) — the reference decodes images synchronously on the tracking
// thread; here a worker pool decodes ahead of the consumer so the device never
// waits on the host (the SLAM loop's only host-side cost).
//
// PNG support: 8-bit greyscale or RGB(A) (converted to grey), non-interlaced —
// the EuRoC camera format. Decode = zlib inflate + per-row unfiltering
// (filters 0-4 incl. Paeth), implemented from scratch against the PNG spec.
//
// C API (ctypes-friendly), thread-safe for one consumer:
//   el_open(mav0_path, n_prefetch) -> handle
//   el_num_frames(h), el_imu_count(h), el_imu_data(h) -> double[M*7]
//   el_next(h, img_out_f32, imu_out_f32, imu_cap) -> n_imu (>=0) or -1 at end
//   el_frame_time(h, idx), el_width(h), el_height(h)
//   el_close(h)
#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Png {
  int w = 0, h = 0;
  std::vector<float> grey;
  bool ok = false;
};

static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
      pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

Png decode_png(const std::string& path) {
  Png out;
  std::ifstream f(path, std::ios::binary);
  if (!f) return out;
  std::vector<uint8_t> data((std::istreambuf_iterator<char>(f)),
                            std::istreambuf_iterator<char>());
  if (data.size() < 8 || data[0] != 0x89 || data[1] != 'P') return out;

  size_t pos = 8;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= data.size()) {
    uint32_t len = be32(&data[pos]);
    std::string type(reinterpret_cast<char*>(&data[pos + 4]), 4);
    const uint8_t* body = &data[pos + 8];
    if (type == "IHDR") {
      out.w = int(be32(body));
      out.h = int(be32(&body[4]));
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (type == "IDAT") {
      idat.insert(idat.end(), body, body + len);
    } else if (type == "IEND") {
      break;
    }
    pos += 12 + len;
  }
  if (out.w <= 0 || out.h <= 0 || bit_depth != 8 || interlace != 0) return out;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // grey
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // grey+alpha
    case 6: ch = 4; break;  // rgba
    default: return out;
  }
  const size_t stride = size_t(out.w) * ch;
  std::vector<uint8_t> raw((stride + 1) * out.h);
  {
    z_stream zs{};
    if (inflateInit(&zs) != Z_OK) return out;
    zs.next_in = idat.data();
    zs.avail_in = uInt(idat.size());
    zs.next_out = raw.data();
    zs.avail_out = uInt(raw.size());
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END && rc != Z_OK) return out;
  }
  // unfilter in place into `img`
  std::vector<uint8_t> img(stride * out.h);
  for (int y = 0; y < out.h; y++) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &img[stride * y];
    const uint8_t* up = y ? &img[stride * (y - 1)] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= size_t(ch) ? dst[x - ch] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(ch)) ? up[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return out;
      }
      dst[x] = uint8_t(v);
    }
  }
  out.grey.resize(size_t(out.w) * out.h);
  for (int y = 0; y < out.h; y++) {
    for (int x = 0; x < out.w; x++) {
      const uint8_t* px = &img[stride * y + size_t(x) * ch];
      float g;
      if (ch == 1 || ch == 2)
        g = float(px[0]);
      else
        g = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
      out.grey[size_t(y) * out.w + x] = g;
    }
  }
  out.ok = true;
  return out;
}

struct Frame {
  int idx = -1;
  Png png;
  std::vector<float> imu;  // rows of [gyro(3), acc(3), dt]
};

struct Loader {
  std::vector<double> img_times;
  std::vector<std::string> img_paths;
  std::vector<double> imu;  // rows of [t, wx, wy, wz, ax, ay, az]
  int width = 0, height = 0;

  // prefetch machinery
  std::deque<Frame> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::thread worker;
  std::atomic<bool> stop{false};
  size_t n_prefetch = 4;
  int next_out = 0;

  ~Loader() {
    stop = true;
    cv_space.notify_all();
    if (worker.joinable()) worker.join();
  }

  void producer() {
    size_t imu_pos = 0;
    double prev_t = -1.0;
    for (size_t i = 0; i < img_paths.size() && !stop; i++) {
      Frame fr;
      fr.idx = int(i);
      fr.png = decode_png(img_paths[i]);
      // IMU strictly before the frame time (driver :165-172)
      double tf = img_times[i];
      while (imu_pos < imu.size() / 7 && imu[imu_pos * 7] < tf) {
        double t = imu[imu_pos * 7];
        double dt = prev_t < 0 ? 0.0 : t - prev_t;
        if (prev_t < 0) dt = 0.005;
        for (int k = 1; k <= 6; k++)
          fr.imu.push_back(float(imu[imu_pos * 7 + k]));
        fr.imu.push_back(float(dt > 0 ? dt : 0.0));
        prev_t = t;
        imu_pos++;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < n_prefetch || stop; });
      if (stop) return;
      ready.push_back(std::move(fr));
      cv_ready.notify_one();
    }
  }
};

bool parse_csvs(Loader* L, const std::string& root) {
  {
    std::ifstream f(root + "/cam0/data.csv");
    if (!f) return false;
    std::string line;
    while (std::getline(f, line)) {
      if (line.empty() || line[0] == '#') continue;
      auto comma = line.find(',');
      if (comma == std::string::npos) continue;
      double t_ns = std::stod(line.substr(0, comma));
      std::string name = line.substr(comma + 1);
      while (!name.empty() && (name.back() == '\r' || name.back() == '\n' ||
                               name.back() == ' '))
        name.pop_back();
      L->img_times.push_back(t_ns / 1e9);
      L->img_paths.push_back(root + "/cam0/data/" + name);
    }
  }
  {
    std::ifstream f(root + "/imu0/data.csv");
    if (!f) return false;
    std::string line;
    while (std::getline(f, line)) {
      if (line.empty() || line[0] == '#') continue;
      std::stringstream ss(line);
      std::string tok;
      std::vector<double> vals;
      while (std::getline(ss, tok, ',')) vals.push_back(std::stod(tok));
      if (vals.size() < 7) continue;
      L->imu.push_back(vals[0] / 1e9);
      for (int k = 1; k < 7; k++) L->imu.push_back(vals[k]);
    }
  }
  // align start index: skip images before the first IMU sample
  if (!L->imu.empty()) {
    double t0 = L->imu[0];
    size_t first = 0;
    while (first < L->img_times.size() && L->img_times[first] < t0) first++;
    L->img_times.erase(L->img_times.begin(), L->img_times.begin() + first);
    L->img_paths.erase(L->img_paths.begin(), L->img_paths.begin() + first);
  }
  if (L->img_paths.empty()) return false;
  Png probe = decode_png(L->img_paths[0]);
  if (!probe.ok) return false;
  L->width = probe.w;
  L->height = probe.h;
  return true;
}

}  // namespace

extern "C" {

void* el_open(const char* mav0_path, int n_prefetch) {
  auto* L = new Loader();
  if (!parse_csvs(L, mav0_path)) {
    delete L;
    return nullptr;
  }
  L->n_prefetch = n_prefetch > 0 ? size_t(n_prefetch) : 4;
  L->worker = std::thread([L] { L->producer(); });
  return L;
}

int el_num_frames(void* h) { return int(static_cast<Loader*>(h)->img_times.size()); }
int el_width(void* h) { return static_cast<Loader*>(h)->width; }
int el_height(void* h) { return static_cast<Loader*>(h)->height; }
double el_frame_time(void* h, int idx) {
  auto* L = static_cast<Loader*>(h);
  if (idx < 0 || size_t(idx) >= L->img_times.size()) return -1.0;
  return L->img_times[idx];
}

// Blocks until the next frame is decoded. Copies the image into img_out
// (width*height floats) and up to imu_cap IMU rows ([gyro, acc, dt] each)
// into imu_out. Returns the number of IMU rows, or -1 at end of sequence,
// -2 on decode failure.
int el_next(void* h, float* img_out, float* imu_out, int imu_cap) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  if (size_t(L->next_out) >= L->img_paths.size()) return -1;
  L->cv_ready.wait(lk, [&] { return !L->ready.empty(); });
  Frame fr = std::move(L->ready.front());
  L->ready.pop_front();
  L->cv_space.notify_one();
  lk.unlock();
  L->next_out = fr.idx + 1;
  if (!fr.png.ok) return -2;
  std::memcpy(img_out, fr.png.grey.data(), fr.png.grey.size() * sizeof(float));
  int n = int(fr.imu.size() / 7);
  if (n > imu_cap) n = imu_cap;
  std::memcpy(imu_out, fr.imu.data(), size_t(n) * 7 * sizeof(float));
  return n;
}

void el_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
