// Native prefetching data loader (the port's own copy of
// dlrm_flexflow_tpu/native/ffloader.cc; the same algorithm, so both
// packages deliver the same batches in the same order).
//
// The host half of the input pipeline: the dataset stays mmap'd, a
// background thread assembles (optionally shuffled) batches into a ring
// of reusable host buffers, and the caller copies the next one out. The
// copy to the card (pinned host memory, a non-blocking copy on a side
// CUDA stream) happens above it, in data/prefetch.py.
//
// Dataset file format (.ffbin, written by data/dataloader.py):
//   magic "FFB1" | int64 n_samples | int64 dense_dim | int64 n_sparse
//   | dense  float32 [n_samples, dense_dim]
//   | sparse int32   [n_samples, n_sparse]
//   | label  float32 [n_samples]
//
// C ABI (ctypes, see native/__init__.py): ffloader_open/meta/next/close.
// Built with g++ at first use into build/native/ (native/__init__.py).
//
// A row window (row_lo, rows) copies only rows [row_lo, row_lo + rows)
// of each global batch: one rank's share when ranks train on their rows
// of a global batch. The order of the samples (the shuffle's
// permutation, from the seed and the epoch alone) does not depend on the
// window, so the ranks' windows, joined in rank order, are the whole
// batch.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr int kSlots = 4;  // prefetch ring depth

struct Loader {
  // dataset (mmap'd)
  int fd = -1;
  size_t file_bytes = 0;
  const uint8_t* base = nullptr;
  int64_t n_samples = 0, dense_dim = 0, n_sparse = 0;
  const float* dense = nullptr;
  const int32_t* sparse = nullptr;
  const float* label = nullptr;

  // batching: global batches of batch_size, of which this reader copies
  // rows [row_lo, row_lo + rows)
  int64_t batch_size = 0;
  int64_t row_lo = 0, rows = 0;
  int64_t batches_per_epoch = 0;
  bool shuffle = false;
  uint64_t seed = 0;
  std::vector<int64_t> perm;

  // prefetch ring
  struct Slot {
    std::vector<float> dense;
    std::vector<int32_t> sparse;
    std::vector<float> label;
    int64_t batch_index = -1;
    bool full = false;
  };
  Slot slots[kSlots];
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  int64_t produced = 0, consumed = 0;
  std::atomic<bool> stop{false};
  std::thread worker;

  void fill(Slot& s, int64_t global_batch) {
    const int64_t epoch = global_batch / batches_per_epoch;
    const int64_t b = global_batch % batches_per_epoch;
    if (shuffle && b == 0) {
      std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
      std::iota(perm.begin(), perm.end(), 0);
      for (int64_t i = n_samples - 1; i > 0; --i) {
        const int64_t j = static_cast<int64_t>(rng() % (i + 1));
        std::swap(perm[i], perm[j]);
      }
    }
    for (int64_t r = 0; r < rows; ++r) {
      // wrap within the epoch so every batch is full-size, like the
      // reference's next_batch which assumes batch | num_samples
      const int64_t idx = (b * batch_size + row_lo + r) % n_samples;
      const int64_t s_idx = shuffle ? perm[idx] : idx;
      std::memcpy(&s.dense[r * dense_dim], &dense[s_idx * dense_dim],
                  sizeof(float) * dense_dim);
      if (n_sparse > 0) {  // image datasets store a zero-width block
        std::memcpy(&s.sparse[r * n_sparse], &sparse[s_idx * n_sparse],
                    sizeof(int32_t) * n_sparse);
      }
      s.label[r] = label[s_idx];
    }
    s.batch_index = global_batch;
  }

  void run() {
    while (!stop.load()) {
      std::unique_lock<std::mutex> lk(mu);
      cv_empty.wait(lk, [&] {
        return stop.load() || produced - consumed < kSlots;
      });
      if (stop.load()) return;
      Slot& s = slots[produced % kSlots];
      const int64_t gb = produced;
      lk.unlock();
      fill(s, gb);  // heavy copy outside the lock
      lk.lock();
      s.full = true;
      ++produced;
      cv_full.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// rows <= 0 reads whole batches (row_lo 0).
void* ffloader_open(const char* path, int64_t batch_size, int32_t shuffle,
                    uint64_t seed, int64_t row_lo, int64_t rows) {
  Loader* L = new Loader();
  L->fd = open(path, O_RDONLY);
  if (L->fd < 0) {
    delete L;
    return nullptr;
  }
  struct stat st;
  fstat(L->fd, &st);
  L->file_bytes = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, L->file_bytes, PROT_READ, MAP_PRIVATE, L->fd, 0);
  if (m == MAP_FAILED) {
    close(L->fd);
    delete L;
    return nullptr;
  }
  L->base = static_cast<const uint8_t*>(m);
  if (L->file_bytes < 28 || std::memcmp(L->base, "FFB1", 4) != 0) {
    munmap(m, L->file_bytes);
    close(L->fd);
    delete L;
    return nullptr;
  }
  const int64_t* hdr = reinterpret_cast<const int64_t*>(L->base + 4);
  L->n_samples = hdr[0];
  L->dense_dim = hdr[1];
  L->n_sparse = hdr[2];
  if (rows <= 0) {
    row_lo = 0;
    rows = batch_size;
  }
  if (L->n_samples <= 0 || L->dense_dim < 0 || L->n_sparse < 0 ||
      batch_size <= 0 || row_lo < 0 || row_lo + rows > batch_size) {
    munmap(m, L->file_bytes);
    close(L->fd);
    delete L;
    return nullptr;
  }
  const uint8_t* p = L->base + 4 + 3 * sizeof(int64_t);
  L->dense = reinterpret_cast<const float*>(p);
  p += sizeof(float) * L->n_samples * L->dense_dim;
  L->sparse = reinterpret_cast<const int32_t*>(p);
  p += sizeof(int32_t) * L->n_samples * L->n_sparse;
  L->label = reinterpret_cast<const float*>(p);
  const size_t need = (p + sizeof(float) * L->n_samples) - L->base;
  if (need > L->file_bytes) {
    munmap(m, L->file_bytes);
    close(L->fd);
    delete L;
    return nullptr;
  }

  L->batch_size = batch_size;
  L->row_lo = row_lo;
  L->rows = rows;
  L->batches_per_epoch =
      (L->n_samples + batch_size - 1) / batch_size;
  L->shuffle = shuffle != 0;
  L->seed = seed;
  if (L->shuffle) L->perm.resize(L->n_samples);
  for (auto& s : L->slots) {
    s.dense.resize(rows * L->dense_dim);
    s.sparse.resize(rows * L->n_sparse);
    s.label.resize(rows);
  }
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// out_meta = {n_samples, dense_dim, n_sparse, batches_per_epoch}
void ffloader_meta(void* handle, int64_t* out_meta) {
  Loader* L = static_cast<Loader*>(handle);
  out_meta[0] = L->n_samples;
  out_meta[1] = L->dense_dim;
  out_meta[2] = L->n_sparse;
  out_meta[3] = L->batches_per_epoch;
}

// Blocks until the next prefetched batch is ready, copies its window's
// rows into the caller's buffers. Returns the global batch index (epoch *
// bpe + b).
int64_t ffloader_next(void* handle, float* out_dense, int32_t* out_sparse,
                      float* out_label) {
  Loader* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_full.wait(lk, [&] {
    return L->stop.load() || L->slots[L->consumed % kSlots].full;
  });
  if (L->stop.load()) return -1;
  Loader::Slot& s = L->slots[L->consumed % kSlots];
  const int64_t bi = s.batch_index;
  std::memcpy(out_dense, s.dense.data(), sizeof(float) * s.dense.size());
  if (!s.sparse.empty()) {
    std::memcpy(out_sparse, s.sparse.data(),
                sizeof(int32_t) * s.sparse.size());
  }
  std::memcpy(out_label, s.label.data(), sizeof(float) * s.label.size());
  s.full = false;
  ++L->consumed;
  L->cv_empty.notify_one();
  return bi;
}

void ffloader_close(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_full.notify_all();
  L->cv_empty.notify_all();
  if (L->worker.joinable()) L->worker.join();
  munmap(const_cast<uint8_t*>(L->base), L->file_bytes);
  close(L->fd);
  delete L;
}

}  // extern "C"
