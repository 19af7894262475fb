// kvtpu native runtime: block hashing + host-side KV offload engine.
//
// The PyTorch port's copy of the JAX package's engine, the counterpart of
// the reference's C++/CUDA storage connector (reference:
// kv_connectors/llmd_fs_backend/csrc/storage/).  The CUDA pieces (side
// streams, events, pinned staging, device copies) live in Python, in the
// port's models/kv_cache_pool.py and offload/staging_engine.py, so this
// engine's job is everything *after* the host buffer: NUMA-aware I/O
// threading, atomic file persistence, async job tracking, and the hot
// hash chain.  It never touches the GPU.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <deque>
#include <functional>
#include <future>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace kvtpu {

// ---------------------------------------------------------------------------
// Hashing (see token_processor.py for the contract)
// ---------------------------------------------------------------------------

uint64_t fnv1a64(const uint8_t* data, size_t len);

// Appends the canonical-CBOR encoding of [parent, tokens, null] to `out`.
void encode_chunk_payload(uint64_t parent, const uint32_t* tokens,
                          size_t n_tokens, std::vector<uint8_t>& out);

// Chained block hashing: writes one key per full block_size chunk into
// out_keys (capacity n_tokens / block_size), returns the number written.
size_t hash_chain(uint64_t parent_hash, const uint32_t* tokens,
                  size_t n_tokens, size_t block_size, uint64_t* out_keys);

// XXH64 of `len` bytes with `seed` (Yann Collet's xxHash, 64-bit): the
// prefix store's chained text-chunk keys (tokenization/prefixstore).
uint64_t xxh64(const uint8_t* data, size_t len, uint64_t seed);

// ---------------------------------------------------------------------------
// NUMA
// ---------------------------------------------------------------------------

// CPUs of a NUMA node, parsed from
// /sys/devices/system/node/node<N>/cpulist; empty if unknown.
std::vector<int> cpus_in_numa_node(int node);

// Pin the calling thread to the given CPUs (no-op on empty/failure).
bool pin_thread_to_cpus(const std::vector<int>& cpus);

// ---------------------------------------------------------------------------
// Thread pool
// ---------------------------------------------------------------------------

class ThreadPool {
 public:
  // numa_node < 0: no pinning. Threads are round-robin pinned to the
  // node's CPUs (reference: csrc/storage/thread_pool.cpp:55-112).
  ThreadPool(size_t n_threads, int numa_node);
  ~ThreadPool();

  void enqueue(std::function<void()> task);
  size_t size() const { return threads_.size(); }

 private:
  void worker(size_t index, int numa_node);

  std::vector<std::thread> threads_;
  std::deque<std::function<void()>> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stopping_ = false;
};

// ---------------------------------------------------------------------------
// File I/O
// ---------------------------------------------------------------------------

// Atomic write: temp file with a thread-unique suffix, then rename()
// (reference: csrc/storage/file_io.cpp:40-99).  Creates parent dirs.
bool write_buffer_to_file(const std::string& path, const uint8_t* data,
                          size_t size);

// Full-file read with exact-size validation
// (reference: csrc/storage/file_io.cpp:103-140).
bool read_buffer_from_file(const std::string& path, uint8_t* data,
                           size_t size);

bool file_exists(const std::string& path);

// Size in bytes, or -1 when the file does not exist.
int64_t file_size(const std::string& path);

// Refresh atime+mtime so recency-based sweepers on shared storage (and
// noatime mounts) see recent use.  The reference intended atime-only but
// actually updated mtime (file_io.cpp:143-148, noted doc/code mismatch);
// we update both deliberately and match the Python fallback.
bool touch_file(const std::string& path);

// ---------------------------------------------------------------------------
// Offload engine
// ---------------------------------------------------------------------------

enum class JobStatus : int32_t {
  kPending = 0,
  kSucceeded = 1,
  kFailed = 2,
  kUnknown = 3,
};

// Async store/load between caller-owned host buffers and files.  One job =
// many file tasks; get_finished() harvests completed jobs like the
// reference engine (csrc/storage/storage_offload.cpp:89-113).
class OffloadEngine {
 public:
  OffloadEngine(size_t n_threads, int numa_node);

  // Buffers must stay alive until the job finishes. skip_existing
  // implements cross-pod dedupe on shared storage.
  void store(int64_t job_id, const std::vector<std::string>& paths,
             const std::vector<const uint8_t*>& buffers,
             const std::vector<size_t>& sizes, bool skip_existing);

  void load(int64_t job_id, const std::vector<std::string>& paths,
            const std::vector<uint8_t*>& buffers,
            const std::vector<size_t>& sizes);

  // Harvest up to max_out finished jobs (each reported once; the rest
  // stay resident for the next poll).
  std::vector<std::pair<int64_t, JobStatus>> get_finished(size_t max_out);

  // Block until a job finishes; returns its status.
  JobStatus wait(int64_t job_id);

 private:
  struct Job {
    size_t total_tasks = 0;
    std::atomic<size_t> completed{0};
    std::atomic<size_t> failed{0};
    std::promise<void> done;
    std::shared_future<void> done_future;
  };

  std::shared_ptr<Job> register_job(int64_t job_id, size_t n_tasks);
  void finish_task(int64_t job_id, const std::shared_ptr<Job>& job,
                   bool ok);

  ThreadPool pool_;
  std::mutex jobs_mu_;
  std::unordered_map<int64_t, std::shared_ptr<Job>> jobs_;
};

}  // namespace kvtpu
