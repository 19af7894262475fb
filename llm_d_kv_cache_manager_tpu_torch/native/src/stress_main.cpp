// ThreadSanitizer stress harness for the port's copy of the offload engine.
//
// Copied from the JAX package's native/src/stress_main.cpp and compiled
// against the port's own kvtpu_native.hpp and engine sources: hammer
// every engine entry point from many threads at once and let TSan prove
// the synchronization. Built and run by
// `python -m llm_d_kv_cache_manager_tpu_torch.native.build --stress`
// (plain) or `--stress-tsan` (with -fsanitize=thread); also run by
// tests/test_torch_native_race.py.
//
// Exercised concurrently:
//   * N producer threads issuing store jobs (disjoint job-id ranges)
//   * N reader threads issuing load jobs for files known to exist
//   * a poller thread draining get_finished() the whole time
//   * waiter threads blocking on specific job ids
// Ends by asserting every job completed exactly once with SUCCEEDED.

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "kvtpu_native.hpp"

namespace {

constexpr int kProducers = 4;
constexpr int kJobsPerProducer = 200;
constexpr size_t kFilesPerJob = 2;
constexpr size_t kBufBytes = 16 * 1024;

std::string tmp_root() {
  const char* env = std::getenv("KVTPU_STRESS_DIR");
  if (env != nullptr) return env;
  char templ[] = "/tmp/kvtpu-stress-XXXXXX";
  char* dir = mkdtemp(templ);
  if (dir == nullptr) {
    std::perror("mkdtemp");
    std::exit(2);
  }
  return dir;
}

}  // namespace

int main() {
  const std::string root = tmp_root();
  kvtpu::OffloadEngine engine(/*n_threads=*/4, /*numa_node=*/-1);

  // Stable per-producer buffers: alive until their jobs are harvested.
  std::vector<std::vector<uint8_t>> buffers(kProducers);
  for (int p = 0; p < kProducers; ++p) {
    buffers[p].assign(kBufBytes, static_cast<uint8_t>(p + 1));
  }

  std::atomic<bool> stop_polling{false};
  std::atomic<int> harvested{0};
  std::atomic<int> failed{0};

  // Poller: drains completions concurrently with submission and wait().
  std::thread poller([&] {
    while (!stop_polling.load()) {
      for (auto& [job_id, status] : engine.get_finished(64)) {
        (void)job_id;
        harvested.fetch_add(1);
        if (status != kvtpu::JobStatus::kSucceeded) failed.fetch_add(1);
      }
      std::this_thread::yield();
    }
  });

  // Producers: store jobs with disjoint id ranges.
  std::vector<std::thread> producers;
  for (int p = 0; p < kProducers; ++p) {
    producers.emplace_back([&, p] {
      for (int j = 0; j < kJobsPerProducer; ++j) {
        const int64_t job_id = p * kJobsPerProducer + j;
        std::vector<std::string> paths;
        std::vector<const uint8_t*> bufs;
        std::vector<size_t> sizes;
        for (size_t f = 0; f < kFilesPerJob; ++f) {
          paths.push_back(root + "/p" + std::to_string(p) + "/f" +
                          std::to_string(j) + "_" + std::to_string(f) +
                          ".bin");
          bufs.push_back(buffers[p].data());
          sizes.push_back(kBufBytes);
        }
        engine.store(job_id, paths, bufs, sizes,
                     /*skip_existing=*/j % 2 == 0);
        if (j % 8 == 0) {
          // Interleave blocking waits with the poller's harvesting;
          // exactly one claimant per completion: wait() returns
          // kUnknown when the poller already erased the job.
          switch (engine.wait(job_id)) {
            case kvtpu::JobStatus::kSucceeded:
              harvested.fetch_add(1);
              break;
            case kvtpu::JobStatus::kUnknown:
              break;  // poller claimed it; it already counted
            default:
              failed.fetch_add(1);
              harvested.fetch_add(1);
          }
        }
      }
    });
  }
  for (auto& t : producers) t.join();

  // Readers: load back files written above, racing the poller.
  std::vector<std::vector<uint8_t>> read_bufs(kProducers);
  std::vector<std::thread> readers;
  for (int p = 0; p < kProducers; ++p) {
    read_bufs[p].resize(kBufBytes);
    readers.emplace_back([&, p] {
      const int64_t job_id = 100000 + p;
      std::vector<std::string> paths = {root + "/p" + std::to_string(p) +
                                        "/f0_0.bin"};
      std::vector<uint8_t*> bufs = {read_bufs[p].data()};
      std::vector<size_t> sizes = {kBufBytes};
      engine.load(job_id, paths, bufs, sizes);
      switch (engine.wait(job_id)) {
        case kvtpu::JobStatus::kSucceeded:
          harvested.fetch_add(1);
          if (read_bufs[p][0] != static_cast<uint8_t>(p + 1)) {
            std::fprintf(stderr, "corrupt readback p%d\n", p);
            std::exit(3);
          }
          break;
        case kvtpu::JobStatus::kUnknown:
          break;  // poller claimed it (and counted it)
        default:
          failed.fetch_add(1);
          harvested.fetch_add(1);
      }
    });
  }
  for (auto& t : readers) t.join();

  // Drain the stragglers, then stop the poller.
  const int total_jobs = kProducers * kJobsPerProducer + kProducers;
  for (int spins = 0; harvested.load() < total_jobs && spins < 10000;
       ++spins) {
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  stop_polling.store(true);
  poller.join();

  if (harvested.load() != total_jobs || failed.load() != 0) {
    std::fprintf(stderr, "harvested=%d/%d failed=%d\n", harvested.load(),
                 total_jobs, failed.load());
    return 1;
  }
  std::printf("stress ok: %d jobs, 0 failures\n", total_jobs);
  return 0;
}
