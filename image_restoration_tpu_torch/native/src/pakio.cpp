// pakio: native packed-record reader for the .pak store.
//
// One mmap'ed blob served by a pthread pool for batched random reads,
// exposed through a minimal C ABI that `native/pakio.py` binds with ctypes.
// A copy of image_restoration_tpu/native/src/pakio.cpp.
//
// Built at first use by `native/pakio.py` with
//   g++ -O3 -fPIC -std=c++17 -Wall -shared -pthread -o _build/libpakio_<hash>.so

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Reader {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
};

struct Task {
  const Reader* reader;
  uint64_t offset;
  uint64_t length;
  uint8_t* dst;
};

class ThreadPool {
 public:
  explicit ThreadPool(int workers) : stop_(false), pending_(0) {
    for (int i = 0; i < workers; ++i) {
      threads_.emplace_back([this] { Run(); });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  void Submit(Task task) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      tasks_.push(task);
      ++pending_;
    }
    cv_.notify_one();
  }

  void Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

 private:
  void Run() {
    for (;;) {
      Task task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        task = tasks_.front();
        tasks_.pop();
      }
      std::memcpy(task.dst, task.reader->data + task.offset, task.length);
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::queue<Task> tasks_;
  std::vector<std::thread> threads_;
  bool stop_;
  int pending_;
};

ThreadPool* pool = nullptr;
std::mutex pool_mu;

ThreadPool* GetPool(int workers) {
  std::lock_guard<std::mutex> lk(pool_mu);
  if (pool == nullptr) pool = new ThreadPool(workers > 0 ? workers : 4);
  return pool;
}

}  // namespace

extern "C" {

void* pak_open(const char* path) {
  auto* r = new Reader();
  r->fd = ::open(path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  if (fstat(r->fd, &st) != 0) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  r->size = static_cast<size_t>(st.st_size);
  void* p = mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0);
  if (p == MAP_FAILED) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  madvise(p, r->size, MADV_RANDOM);
  r->data = static_cast<const uint8_t*>(p);
  return r;
}

int64_t pak_size(void* handle) {
  return handle ? static_cast<Reader*>(handle)->size : -1;
}

// Copy one record into dst. Returns bytes copied or -1.
int64_t pak_read(void* handle, uint64_t offset, uint64_t length,
                 uint8_t* dst) {
  auto* r = static_cast<Reader*>(handle);
  if (r == nullptr || offset + length > r->size) return -1;
  std::memcpy(dst, r->data + offset, length);
  return static_cast<int64_t>(length);
}

// Batched multi-threaded read: n records into one packed dst buffer laid
// out back-to-back at dst_offsets. Returns 0 on success.
int pak_read_batch(void* handle, int n, const uint64_t* offsets,
                   const uint64_t* lengths, uint8_t* dst,
                   const uint64_t* dst_offsets, int workers) {
  auto* r = static_cast<Reader*>(handle);
  if (r == nullptr) return -1;
  for (int i = 0; i < n; ++i) {
    if (offsets[i] + lengths[i] > r->size) return -1;
  }
  ThreadPool* tp = GetPool(workers);
  for (int i = 0; i < n; ++i) {
    tp->Submit(Task{r, offsets[i], lengths[i], dst + dst_offsets[i]});
  }
  tp->Wait();
  return 0;
}

void pak_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r == nullptr) return;
  munmap(const_cast<uint8_t*>(r->data), r->size);
  ::close(r->fd);
  delete r;
}

}  // extern "C"
