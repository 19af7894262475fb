// I/O thread pool with per-node CPU pinning.  Same shape as the
// reference's pool (csrc/storage/thread_pool.cpp) minus CUDA streams and
// pinned staging: the device<->host copies happen in Python (torch), so
// workers only ever touch host memory and files.

#include "kvtpu_native.hpp"

namespace kvtpu {

ThreadPool::ThreadPool(size_t n_threads, int numa_node) {
  if (n_threads == 0) n_threads = 1;
  threads_.reserve(n_threads);
  for (size_t i = 0; i < n_threads; ++i) {
    threads_.emplace_back([this, i, numa_node] { worker(i, numa_node); });
  }
}

ThreadPool::~ThreadPool() {
  {
    std::lock_guard<std::mutex> lock(mu_);
    stopping_ = true;
  }
  cv_.notify_all();
  for (auto& thread : threads_) {
    if (thread.joinable()) thread.join();
  }
}

void ThreadPool::enqueue(std::function<void()> task) {
  {
    std::lock_guard<std::mutex> lock(mu_);
    queue_.push_back(std::move(task));
  }
  cv_.notify_one();
}

void ThreadPool::worker(size_t index, int numa_node) {
  if (numa_node >= 0) {
    const auto cpus = cpus_in_numa_node(numa_node);
    if (!cpus.empty()) {
      // Round-robin across the node's CPUs, one per worker.
      pin_thread_to_cpus({cpus[index % cpus.size()]});
    }
  }
  for (;;) {
    std::function<void()> task;
    {
      std::unique_lock<std::mutex> lock(mu_);
      cv_.wait(lock, [this] { return stopping_ || !queue_.empty(); });
      if (stopping_ && queue_.empty()) return;
      task = std::move(queue_.front());
      queue_.pop_front();
    }
    task();
  }
}

}  // namespace kvtpu
