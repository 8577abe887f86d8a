// wsdl_io — the port's asynchronous PNG writer: a thread pool that encodes
// and writes pseudo-mask and image PNGs (a copy of the JAX package's
// native/wsdl_io.cpp, built on its own by native/__init__.py).
//
// In the reference, pseudo-mask PNG directories are the durable pipeline
// state (PsuedoMasks.py:31-36,68-74; refinement overwrites masks in place at
// AlternatingDirectionCutLoss.py:808-809), and a reference-protocol run
// writes thousands of them. The Python loop that drives the card should not
// wait on zlib: `wsdl_io_submit` copies the pixels and returns, a worker
// pool encodes and writes, and `wsdl_io_flush` is the durability barrier a
// stage calls before it hands a directory to the next one.
//
// The PNG encoder is minimal and spec-compliant (IHDR, one zlib-deflated
// IDAT of filter-0 scanlines, IEND, CRCs from zlib): masks are {0,255}
// 8-bit greyscale and images 8-bit RGB, where filter prediction buys
// little; compression level 1. Files decode with any reader.
//
// C ABI for ctypes; no Python headers.

#include <zlib.h>

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uLong crc = crc32(0L, out.data() + start, static_cast<uInt>(4 + len));
  put_be32(out, static_cast<uint32_t>(crc));
}

// Encode H×W×C (C=1 gray, C=3 RGB) 8-bit pixels into a PNG byte stream.
bool png_encode(int H, int W, int C, const uint8_t* pixels,
                std::vector<uint8_t>& out, int level) {
  if (C != 1 && C != 3) return false;
  const size_t row = static_cast<size_t>(W) * C;
  std::vector<uint8_t> raw((row + 1) * H);  // filter byte 0 + scanline
  for (int y = 0; y < H; y++) {
    raw[y * (row + 1)] = 0;
    std::memcpy(&raw[y * (row + 1) + 1], pixels + y * row, row);
  }
  uLongf comp_cap = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(),
                static_cast<uLong>(raw.size()), level) != Z_OK)
    return false;

  out.clear();
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (W >> 24) & 0xff; ihdr[1] = (W >> 16) & 0xff;
  ihdr[2] = (W >> 8) & 0xff;  ihdr[3] = W & 0xff;
  ihdr[4] = (H >> 24) & 0xff; ihdr[5] = (H >> 16) & 0xff;
  ihdr[6] = (H >> 8) & 0xff;  ihdr[7] = H & 0xff;
  ihdr[8] = 8;                       // bit depth
  ihdr[9] = (C == 1) ? 0 : 2;        // color type: gray / truecolor
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", comp.data(), comp_cap);
  put_chunk(out, "IEND", nullptr, 0);
  return true;
}

struct IoJob {
  std::string path;
  int H, W, C;
  std::vector<uint8_t> pixels;
};

std::mutex g_mu;
std::condition_variable g_cv;       // workers wait for jobs
std::condition_variable g_done_cv;  // flush waits for drain
std::deque<IoJob> g_queue;
std::vector<std::thread> g_workers;
int g_active = 0;
bool g_stop = false;
std::atomic<int> g_failures{0};
std::vector<std::string> g_failed;  // "<path>: <reason>", first few only
constexpr size_t kMaxFailDetail = 8;
int g_level = 1;

// Returns empty string on success, else a human-readable reason — a failed
// durability barrier must name the file and errno, not just count failures.
std::string write_file(const IoJob& job) {
  std::vector<uint8_t> png;
  if (!png_encode(job.H, job.W, job.C, job.pixels.data(), png, g_level))
    return "PNG encode failed (bad shape or zlib error)";
  std::FILE* f = std::fopen(job.path.c_str(), "wb");
  if (!f) return std::string("fopen: ") + std::strerror(errno);
  size_t n = std::fwrite(png.data(), 1, png.size(), f);
  int close_rc = std::fclose(f);
  if (n != png.size()) return "short write";
  if (close_rc != 0) return std::string("fclose: ") + std::strerror(errno);
  return "";
}

void worker_loop() {
  for (;;) {
    IoJob job;
    {
      std::unique_lock<std::mutex> lk(g_mu);
      g_cv.wait(lk, [] { return g_stop || !g_queue.empty(); });
      if (g_stop && g_queue.empty()) return;
      job = std::move(g_queue.front());
      g_queue.pop_front();
      g_active++;
    }
    std::string err = write_file(job);
    {
      std::unique_lock<std::mutex> lk(g_mu);
      g_active--;
      if (!err.empty()) {
        g_failures.fetch_add(1);
        if (g_failed.size() < kMaxFailDetail)
          g_failed.push_back(job.path + ": " + err);
      }
      if (g_queue.empty() && g_active == 0) g_done_cv.notify_all();
    }
  }
}

void stop_pool() {
  {
    std::unique_lock<std::mutex> lk(g_mu);
    if (g_workers.empty()) return;
    g_stop = true;
  }
  g_cv.notify_all();
  for (auto& t : g_workers) t.join();
  g_workers.clear();
}

void ensure_pool(int threads) {
  std::unique_lock<std::mutex> lk(g_mu);
  if (!g_workers.empty()) return;
  g_stop = false;
  if (threads <= 0) threads = 4;
  for (int i = 0; i < threads; i++) g_workers.emplace_back(worker_loop);
  // joinable std::threads in a static vector would std::terminate the
  // process during static destruction — drain and join them at exit instead
  static bool registered = (std::atexit(stop_pool), true);
  (void)registered;
}

}  // namespace

extern "C" {

// Start the writer pool explicitly (optional: submit auto-starts 4 threads).
void wsdl_io_start(int threads, int zlib_level) {
  if (zlib_level >= 0 && zlib_level <= 9) g_level = zlib_level;
  ensure_pool(threads);
}

// Enqueue one PNG write. Copies `pixels` (H*W*C bytes, C∈{1,3}) and returns
// immediately. Returns 0 on success, -1 on invalid arguments.
int wsdl_io_submit(const char* path, int H, int W, int C,
                   const uint8_t* pixels) {
  if (!path || H <= 0 || W <= 0 || (C != 1 && C != 3) || !pixels) return -1;
  ensure_pool(0);
  IoJob job;
  job.path = path;
  job.H = H; job.W = W; job.C = C;
  job.pixels.assign(pixels, pixels + static_cast<size_t>(H) * W * C);
  {
    std::unique_lock<std::mutex> lk(g_mu);
    g_queue.push_back(std::move(job));
  }
  g_cv.notify_one();
  return 0;
}

// Durability barrier: block until every submitted write has completed.
// Returns the number of failed writes since the last flush (and resets it).
int wsdl_io_flush() {
  std::unique_lock<std::mutex> lk(g_mu);
  g_done_cv.wait(lk, [] { return g_queue.empty() && g_active == 0; });
  g_failed.clear();
  return g_failures.exchange(0);
}

// Durability barrier with diagnostics: like wsdl_io_flush, but first copies
// "<path>: <reason>" lines (newline-joined, first few failures) into `buf`.
int wsdl_io_flush_errors(char* buf, int cap) {
  std::unique_lock<std::mutex> lk(g_mu);
  g_done_cv.wait(lk, [] { return g_queue.empty() && g_active == 0; });
  if (buf && cap > 0) {
    std::string joined;
    for (const auto& s : g_failed) {
      if (!joined.empty()) joined += "\n";
      joined += s;
    }
    size_t n = joined.size() < static_cast<size_t>(cap - 1)
                   ? joined.size()
                   : static_cast<size_t>(cap - 1);
    std::memcpy(buf, joined.data(), n);
    buf[n] = '\0';
  }
  g_failed.clear();
  return g_failures.exchange(0);
}

// Synchronous single-shot encode+write (no pool) — used when callers want
// strict write-then-read ordering without the barrier.
int wsdl_png_write(const char* path, int H, int W, int C,
                   const uint8_t* pixels) {
  if (!path || H <= 0 || W <= 0 || (C != 1 && C != 3) || !pixels) return -1;
  IoJob job;
  job.path = path;
  job.H = H; job.W = W; job.C = C;
  job.pixels.assign(pixels, pixels + static_cast<size_t>(H) * W * C);
  return write_file(job).empty() ? 0 : -1;
}

// Stop the pool (joins workers after draining the queue).
void wsdl_io_stop() { stop_pool(); }

}  // extern "C"
