/* Asynchronous frame-writer pipeline.
 *
 * During animation rendering (the reference's 100-frame 1024x1024 runs,
 * reference README.md:8-9) the host-side work per frame -- tonemap,
 * quantize, PNG encode, disk write -- is comparable to the device render
 * time at small sizes.  This thread pool takes a copied framebuffer off the
 * render thread so device compute and host IO fully overlap (the
 * counterpart of the reference's progressive RenderResult
 * flushing, RelativisticRenderEngine.py:158-168).
 */
#include "bgc.h"

#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
  std::string path;
  std::vector<float> data;      /* float path: quantized in the worker */
  std::vector<uint8_t> data_u8; /* u8 path: device-side quantized frames
                                   (4x smaller host transfer) */
  int32_t h, w, c, srgb;
};

}  // namespace

struct BgcWriter {
  std::mutex mu;
  std::condition_variable cv_push;  /* workers wait for jobs */
  std::condition_variable cv_done;  /* waiters wait for drain */
  std::deque<Job> queue;
  std::vector<std::thread> pool;
  int in_flight = 0;
  int failures = 0;
  bool stopping = false;

  explicit BgcWriter(int n_threads) {
    if (n_threads < 1) n_threads = 2;
    pool.reserve(n_threads);
    for (int i = 0; i < n_threads; ++i)
      pool.emplace_back([this]() { run(); });
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return stopping || !queue.empty(); });
        if (queue.empty()) return; /* stopping and drained */
        job = std::move(queue.front());
        queue.pop_front();
      }
      std::vector<uint8_t> u8;
      if (!job.data_u8.empty()) {
        u8 = std::move(job.data_u8);
      } else {
        u8.resize((size_t)job.h * job.w * job.c);
        bgc_quantize(job.data.data(), u8.data(), (int64_t)job.h * job.w,
                     job.c, job.srgb);
      }
      /* Atomic publish: encode to path+".tmp" and rename into place, so a
       * crash/kill mid-write never leaves a truncated frame that a resumed
       * animation (cli animate --resume) would treat as complete. */
      std::string tmp = job.path + ".tmp";
      int rc = bgc_write_png(tmp.c_str(), u8.data(), job.h, job.w,
                             job.c, 6);
      if (rc == 0 && std::rename(tmp.c_str(), job.path.c_str()) != 0) rc = 3;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (rc != 0) failures += 1;
        in_flight -= 1;
        if (in_flight == 0 && queue.empty()) cv_done.notify_all();
      }
    }
  }
};

extern "C" {

BgcWriter* bgc_writer_create(int n_threads) {
  return new BgcWriter(n_threads);
}

int bgc_writer_submit(BgcWriter* wr, const char* path, const float* data,
                      int32_t h, int32_t w, int32_t c, int32_t srgb) {
  if (!wr || !path || !data || h < 1 || w < 1 || (c != 3 && c != 4)) return 1;
  Job job;
  job.path = path;
  job.data.assign(data, data + (size_t)h * w * c);
  job.h = h;
  job.w = w;
  job.c = c;
  job.srgb = srgb;
  {
    std::lock_guard<std::mutex> lk(wr->mu);
    if (wr->stopping) return 2;
    wr->queue.push_back(std::move(job));
    wr->in_flight += 1;
  }
  wr->cv_push.notify_one();
  return 0;
}

int bgc_writer_submit_u8(BgcWriter* wr, const char* path,
                         const uint8_t* data, int32_t h, int32_t w,
                         int32_t c) {
  if (!wr || !path || !data || h < 1 || w < 1 || (c != 3 && c != 4)) return 1;
  Job job;
  job.path = path;
  job.data_u8.assign(data, data + (size_t)h * w * c);
  job.h = h;
  job.w = w;
  job.c = c;
  job.srgb = 0;
  {
    std::lock_guard<std::mutex> lk(wr->mu);
    if (wr->stopping) return 2;
    wr->queue.push_back(std::move(job));
    wr->in_flight += 1;
  }
  wr->cv_push.notify_one();
  return 0;
}

int bgc_writer_wait(BgcWriter* wr) {
  if (!wr) return -1;
  std::unique_lock<std::mutex> lk(wr->mu);
  wr->cv_done.wait(lk, [&] { return wr->in_flight == 0 && wr->queue.empty(); });
  int f = wr->failures;
  wr->failures = 0;
  return f;
}

void bgc_writer_destroy(BgcWriter* wr) {
  if (!wr) return;
  {
    std::lock_guard<std::mutex> lk(wr->mu);
    wr->stopping = true;
  }
  wr->cv_push.notify_all();
  for (auto& t : wr->pool) t.join();
  delete wr;
}

}  // extern "C"
