// Threaded host embedding-bag gather/scatter for HOST-RESIDENT tables.
//
// The reference's hetero path runs embedding lookups on the CPU with
// hand-blocked AVX2/FMA kernels specialized per width
// (reference: src/ops/embedding_avx2.cc:1-296, block sizes 128/64/32/16).
// This is the port's equivalent: the compiler auto-vectorizes the
// inner width loop (restrict + contiguous rows), and the sample loop is
// spread over a persistent thread pool. The scatter partitions the TABLE
// ROWS across threads (each thread applies every update falling in its
// row range), which makes duplicate indices race-free without atomics —
// the host-side analog of the scatter kernels' one owner per row.
//
// Exposed C ABI (ctypes-bound in native/__init__.py):
//   ffemb_bag_gather  : out[b] = sum/mean of table[g[b*bag + j]]
//   ffemb_bag_scatter : table[g[b*bag + j]] -= lr * ct[b] (/bag if avg)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Persistent pool: the host ops run every training step, so per-call
// std::thread spawns (~100 us x threads) would eat the win for small
// batches. One pool, lazily sized to the hardware concurrency.
class Pool {
 public:
  static Pool& instance() {
    static Pool p;
    return p;
  }

  int size() const { return static_cast<int>(workers_.size()); }

  // run fn(t) for t in [0, ntasks) across the pool, blocking until done.
  // Serialized across callers (call_m_): the async host pipeline may
  // issue a gather from the main thread while a scatter thread is still
  // in flight — each pool call then runs atomically, so a racing gather
  // sees the table fully before or fully after the scatter, never torn.
  void parallel_for(int ntasks, const std::function<void(int)>& fn) {
    std::lock_guard<std::mutex> call_lk(call_m_);
    if (ntasks <= 1) {
      for (int t = 0; t < ntasks; ++t) fn(t);
      return;
    }
    std::unique_lock<std::mutex> lk(m_);
    fn_ = &fn;
    total_ = ntasks;
    next_ = 0;
    pending_ = ntasks;
    ++epoch_;
    cv_work_.notify_all();
    cv_done_.wait(lk, [&] { return pending_ == 0; });
    fn_ = nullptr;
  }

 private:
  Pool() {
    int n = static_cast<int>(std::thread::hardware_concurrency());
    const char* env = std::getenv("FFEMB_THREADS");
    if (env && *env) n = std::atoi(env);
    if (n < 1) n = 1;
    // oversubscription on shared/cgroup-limited hosts degrades sharply
    // (measured: 32 threads 4x slower than 8 on a 4-core quota)
    if (n > 16) n = 16;
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { worker(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
      cv_work_.notify_all();
    }
    for (auto& w : workers_) w.join();
  }

  void worker() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(m_);
    for (;;) {
      cv_work_.wait(lk, [&] { return stop_ || epoch_ != seen; });
      if (stop_) return;
      seen = epoch_;
      while (next_ < total_) {
        int t = next_++;
        lk.unlock();
        (*fn_)(t);
        lk.lock();
        if (--pending_ == 0) cv_done_.notify_all();
      }
    }
  }

  std::vector<std::thread> workers_;
  std::mutex call_m_;
  std::mutex m_;
  std::condition_variable cv_work_, cv_done_;
  const std::function<void(int)>* fn_ = nullptr;
  int total_ = 0, next_ = 0, pending_ = 0;
  uint64_t epoch_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

// table  : (rows, d) float32, row-major
// g      : (n, bag) int64 GLOBAL row ids (caller applies offsets/modulo)
// out    : (n, d) float32
// avg    : 1 = mean over the bag, 0 = sum
void ffemb_bag_gather(const float* table, int64_t rows, int64_t d,
                      const int64_t* g, int64_t n, int64_t bag, int avg,
                      float* out) {
  Pool& pool = Pool::instance();
  int nt = std::min<int64_t>(pool.size(), std::max<int64_t>(n / 64, 1));
  const float scale = avg ? 1.0f / static_cast<float>(bag) : 1.0f;
  pool.parallel_for(nt, [&](int t) {
    int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
    for (int64_t i = lo; i < hi; ++i) {
      float* __restrict__ o = out + i * d;
      const int64_t* gi = g + i * bag;
      {
        const float* __restrict__ r0 = table + gi[0] * d;
        for (int64_t k = 0; k < d; ++k) o[k] = r0[k];
      }
      for (int64_t j = 1; j < bag; ++j) {
        const float* __restrict__ r = table + gi[j] * d;
        for (int64_t k = 0; k < d; ++k) o[k] += r[k];
      }
      if (avg)
        for (int64_t k = 0; k < d; ++k) o[k] *= scale;
    }
  });
}

// table[g[i*bag + j]] -= lr * ct[i]  (ct scaled by 1/bag when avg).
// Threads own disjoint ROW RANGES of the table and each scans all
// updates, applying only those in range — duplicate rows never race.
void ffemb_bag_scatter(float* table, int64_t rows, int64_t d,
                       const int64_t* g, int64_t n, int64_t bag, int avg,
                       const float* ct, float lr) {
  Pool& pool = Pool::instance();
  const float scale = lr * (avg ? 1.0f / static_cast<float>(bag) : 1.0f);
  int nt = std::min<int64_t>(pool.size(),
                             std::max<int64_t>(n * bag / 256, 1));
  pool.parallel_for(nt, [&](int t) {
    int64_t rlo = rows * t / nt, rhi = rows * (t + 1) / nt;
    for (int64_t i = 0; i < n; ++i) {
      const float* __restrict__ c = ct + i * d;
      const int64_t* gi = g + i * bag;
      for (int64_t j = 0; j < bag; ++j) {
        int64_t row = gi[j];
        if (row < rlo || row >= rhi) continue;
        float* __restrict__ w = table + row * d;
        for (int64_t k = 0; k < d; ++k) w[k] -= scale * c[k];
      }
    }
  });
}

}  // extern "C"
