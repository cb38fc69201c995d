// Out-of-core minibatch loader: the host-side C++ runtime of
// henbun_tpu_torch's io package (the same source as henbun_tpu's loader).
//
// Streams datasets larger than RAM from disk: worker threads gather random
// rows (sampling with replacement, matching the Indexer's semantics) from an
// mmap'd float32 file into a ring of megabatch buffers, overlapping disk I/O
// with device compute. Python binds it via ctypes (io/loader.py), which
// builds it with g++ at first use.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread dataloader.cpp -o dataloader.so

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Loader {
  // dataset
  int fd = -1;
  const float* data = nullptr;  // mmap'd [n_rows, row_floats]
  int64_t n_rows = 0;
  int64_t row_floats = 0;
  int64_t batch_rows = 0;
  int64_t train_rows = 0;  // sampling restricted to the first train_rows rows
  int64_t block_rows = 0;  // >0: sample contiguous row blocks (sequential IO)

  // buffer pool
  std::vector<float*> buffers;
  std::deque<float*> free_q;
  std::deque<float*> ready_q;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::atomic<bool> stop{false};
  int waiters = 0;  // consumers blocked in hb_loader_next (guarded by mu)
  std::condition_variable cv_drain;
  std::vector<std::thread> workers;
  uint64_t seed = 0;

  void worker(int tid) {
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + tid + 1);
    std::uniform_int_distribution<int64_t> pick(0, train_rows - 1);
    const size_t row_bytes = static_cast<size_t>(row_floats) * sizeof(float);
    while (true) {
      float* buf;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_q.empty(); });
        if (stop.load()) return;
        buf = free_q.front();
        free_q.pop_front();
      }
      if (block_rows > 0) {
        // Block-then-row sampling: random row reads on 40-byte rows touch a
        // whole 4KB page each (measured ~100x IO amplification on a >RAM
        // file); copying random CONTIGUOUS blocks makes the disk reads
        // sequential. Rows within a block are file-neighbors, so this
        // assumes a pre-shuffled file — the same contract as the on-device
        // 'block' minibatch mode.
        std::uniform_int_distribution<int64_t> pick_start(
            0, train_rows - block_rows);
        for (int64_t i = 0; i < batch_rows; i += block_rows) {
          const int64_t g = std::min(block_rows, batch_rows - i);
          const int64_t s = pick_start(rng);
          std::memcpy(buf + i * row_floats, data + s * row_floats,
                      static_cast<size_t>(g) * row_bytes);
        }
      } else {
        for (int64_t i = 0; i < batch_rows; ++i) {
          const int64_t r = pick(rng);
          std::memcpy(buf + i * row_floats, data + r * row_floats, row_bytes);
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_q.push_back(buf);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* hb_loader_open(const char* path, int64_t n_rows, int64_t row_floats,
                     int64_t batch_rows, int n_buffers, int n_threads,
                     uint64_t seed, int64_t train_rows, int64_t block_rows) {
  if (n_rows <= 0 || row_floats <= 0 || batch_rows <= 0 || n_buffers <= 0 ||
      n_threads <= 0) {
    return nullptr;
  }
  auto* L = new Loader();
  L->fd = ::open(path, O_RDONLY);
  if (L->fd < 0) {
    delete L;
    return nullptr;
  }
  const size_t bytes = static_cast<size_t>(n_rows) * row_floats * sizeof(float);
  // a short file would SIGBUS on first touch past EOF in the mmap — refuse
  // at open instead
  struct stat st;
  if (::fstat(L->fd, &st) != 0 ||
      static_cast<size_t>(st.st_size) < bytes) {
    ::close(L->fd);
    delete L;
    return nullptr;
  }
  void* p = ::mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, L->fd, 0);
  if (p == MAP_FAILED) {
    ::close(L->fd);
    delete L;
    return nullptr;
  }
  L->data = static_cast<const float*>(p);
  L->n_rows = n_rows;
  L->row_floats = row_floats;
  L->batch_rows = batch_rows;
  L->train_rows = (train_rows > 0 && train_rows <= n_rows) ? train_rows : n_rows;
  L->block_rows = block_rows > 0 ? std::min(block_rows, L->train_rows) : 0;
  // block mode reads sequential runs — let the kernel readahead work
  ::madvise(p, bytes, L->block_rows > 0 ? MADV_NORMAL : MADV_RANDOM);
  L->seed = seed;
  for (int i = 0; i < n_buffers; ++i) {
    float* buf = new float[static_cast<size_t>(batch_rows) * row_floats];
    L->buffers.push_back(buf);
    L->free_q.push_back(buf);
  }
  for (int t = 0; t < n_threads; ++t) {
    L->workers.emplace_back([L, t] { L->worker(t); });
  }
  return L;
}

float* hb_loader_next(void* h) {
  // Stop-aware: returns nullptr when the loader is closed while (or before)
  // waiting, instead of deadlocking against joined workers.
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  ++L->waiters;
  L->cv_ready.wait(lk, [&] { return L->stop.load() || !L->ready_q.empty(); });
  --L->waiters;
  if (L->waiters == 0) L->cv_drain.notify_all();
  if (L->ready_q.empty()) return nullptr;  // stopped
  float* buf = L->ready_q.front();
  L->ready_q.pop_front();
  return buf;
}

void hb_loader_release(void* h, float* buf) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_q.push_back(buf);
  }
  L->cv_free.notify_one();
}

void hb_loader_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  L->stop.store(true);
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& w : L->workers) w.join();
  {
    // don't tear down while a consumer is still inside hb_loader_next
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_drain.wait(lk, [&] { return L->waiters == 0; });
  }
  const size_t bytes =
      static_cast<size_t>(L->n_rows) * L->row_floats * sizeof(float);
  ::munmap(const_cast<float*>(static_cast<const float*>(L->data)), bytes);
  ::close(L->fd);
  for (float* b : L->buffers) delete[] b;
  delete L;
}

}  // extern "C"
