// Host-side clustered-KV buffer for the offload path (port of
// native/wave_buffer.cpp, which the JAX package builds and loads itself).
//
// Cluster-major K/V bytes live in host RAM, so the device keeps only the
// centroids and a tail of the newest rows; a decode step gathers the
// selected clusters' bytes into one contiguous staging area (a pinned host
// tensor on the GPU path) with a parallel memcpy fan-out over a small
// thread pool. Plain C++ with a C interface, loaded with ctypes by
// engine/wave_buffer.py; no CUDA here: the staging area crosses to the
// device with one asynchronous copy made by the caller.
//
// Build (ops/_build.py, at first use, into magicdec_tpu_torch/build/):
//   g++ -O3 -std=c++17 -fPIC -shared -pthread -o libwave_buffer-<digest>.so
//       wave_buffer.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false), inflight_(0) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
          if (--inflight_ == 0) {
            std::lock_guard<std::mutex> lk(mu_);
            done_cv_.notify_all();
          }
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void Submit(std::function<void()> job) {
    ++inflight_;
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

  void Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return inflight_.load() == 0; });
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::atomic<bool> stop_;
  std::atomic<int> inflight_;
};

// One buffer = [n_slots] clusters of fixed byte size (cluster-major layout).
struct WaveBuffer {
  int64_t n_slots;
  int64_t slot_bytes;
  std::vector<uint8_t> data;
  ThreadPool* pool;
  std::atomic<int64_t> gathered_slots{0};  // stats
};

}  // namespace

extern "C" {

void* wave_create(int64_t n_slots, int64_t slot_bytes, int n_threads) {
  auto* b = new WaveBuffer();
  b->n_slots = n_slots;
  b->slot_bytes = slot_bytes;
  b->data.resize(static_cast<size_t>(n_slots * slot_bytes));
  b->pool = new ThreadPool(n_threads > 0 ? n_threads : 1);
  return b;
}

void wave_destroy(void* h) {
  auto* b = static_cast<WaveBuffer*>(h);
  delete b->pool;
  delete b;
}

// Bulk upload of a contiguous range of slots (prefill-time cluster store).
void wave_put(void* h, int64_t first_slot, int64_t n, const uint8_t* src) {
  auto* b = static_cast<WaveBuffer*>(h);
  std::memcpy(b->data.data() + first_slot * b->slot_bytes, src,
              static_cast<size_t>(n * b->slot_bytes));
}

// Gather `n` slots (by id) into a contiguous staging buffer, fanned out over
// the pool in tasks of kChunk slots; returns when every task is done.
void wave_gather(void* h, const int64_t* slot_ids, int64_t n, uint8_t* dst) {
  auto* b = static_cast<WaveBuffer*>(h);
  const int64_t kChunk = 16;  // slots per task
  for (int64_t i = 0; i < n; i += kChunk) {
    const int64_t hi = i + kChunk < n ? i + kChunk : n;
    b->pool->Submit([b, slot_ids, dst, i, hi] {
      for (int64_t j = i; j < hi; ++j) {
        std::memcpy(dst + j * b->slot_bytes,
                    b->data.data() + slot_ids[j] * b->slot_bytes,
                    static_cast<size_t>(b->slot_bytes));
      }
    });
  }
  b->pool->Wait();
  b->gathered_slots += n;
}

int64_t wave_stats_gathered(void* h) {
  return static_cast<WaveBuffer*>(h)->gathered_slots.load();
}

}  // extern "C"
