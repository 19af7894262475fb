// Async offload job engine + C ABI for ctypes.
//
// Job model follows the reference engine (csrc/storage/
// storage_offload.cpp): a job fans out to one task per file on the I/O
// pool; an atomic completion counter resolves the job's future; finished
// jobs are harvested once via get_finished() or awaited via wait().
// Unlike the reference, *failures are counted and reported* — the
// reference silently ignored read failures (its TODOs at :202-204,
// :261-263).

#include <cstring>

#include "debug_utils.hpp"
#include "kvtpu_native.hpp"

namespace kvtpu {

OffloadEngine::OffloadEngine(size_t n_threads, int numa_node)
    : pool_(n_threads, numa_node) {}

std::shared_ptr<OffloadEngine::Job> OffloadEngine::register_job(
    int64_t job_id, size_t n_tasks) {
  auto job = std::make_shared<Job>();
  job->total_tasks = n_tasks;
  job->done_future = job->done.get_future().share();
  std::lock_guard<std::mutex> lock(jobs_mu_);
  jobs_[job_id] = job;
  return job;
}

void OffloadEngine::finish_task(int64_t /*job_id*/,
                                const std::shared_ptr<Job>& job, bool ok) {
  if (!ok) job->failed.fetch_add(1);
  if (job->completed.fetch_add(1) + 1 == job->total_tasks) {
    job->done.set_value();
  }
}

void OffloadEngine::store(int64_t job_id,
                          const std::vector<std::string>& paths,
                          const std::vector<const uint8_t*>& buffers,
                          const std::vector<size_t>& sizes,
                          bool skip_existing) {
  auto job = register_job(job_id, paths.size());
  if (paths.empty()) {
    job->done.set_value();
    return;
  }
  for (size_t i = 0; i < paths.size(); ++i) {
    const std::string path = paths[i];
    const uint8_t* buffer = buffers[i];
    const size_t size = sizes[i];
    pool_.enqueue([this, job_id, job, path, buffer, size, skip_existing] {
      // Another pod already persisted this (or a larger) group:
      // refresh recency so storage sweepers keep it.  A smaller file is
      // a partial head group, upgraded by rewriting.  If the touch
      // races a sweeper delete, fall through and write the bytes we
      // already hold instead of failing the job.
      bool ok = skip_existing &&
                file_size(path) >= static_cast<int64_t>(size) &&
                touch_file(path);
      if (!ok) {
        KVTPU_TIME_EXPR("store:write_file",
                        ok = write_buffer_to_file(path, buffer, size));
      } else {
        KVTPU_DEBUG_PRINT("store:skip_existing %s", path.c_str());
      }
      finish_task(job_id, job, ok);
    });
  }
}

void OffloadEngine::load(int64_t job_id,
                         const std::vector<std::string>& paths,
                         const std::vector<uint8_t*>& buffers,
                         const std::vector<size_t>& sizes) {
  auto job = register_job(job_id, paths.size());
  if (paths.empty()) {
    job->done.set_value();
    return;
  }
  for (size_t i = 0; i < paths.size(); ++i) {
    const std::string path = paths[i];
    uint8_t* buffer = buffers[i];
    const size_t size = sizes[i];
    pool_.enqueue([this, job_id, job, path, buffer, size] {
      bool ok = false;
      KVTPU_TIME_EXPR("load:read_file",
                      ok = read_buffer_from_file(path, buffer, size));
      finish_task(job_id, job, ok);
    });
  }
}

std::vector<std::pair<int64_t, JobStatus>> OffloadEngine::get_finished(
    size_t max_out) {
  std::vector<std::pair<int64_t, JobStatus>> finished;
  std::lock_guard<std::mutex> lock(jobs_mu_);
  for (auto it = jobs_.begin();
       it != jobs_.end() && finished.size() < max_out;) {
    auto& job = it->second;
    if (job->completed.load() == job->total_tasks) {
      finished.emplace_back(it->first, job->failed.load() == 0
                                           ? JobStatus::kSucceeded
                                           : JobStatus::kFailed);
      it = jobs_.erase(it);
    } else {
      ++it;
    }
  }
  return finished;
}

JobStatus OffloadEngine::wait(int64_t job_id) {
  std::shared_ptr<Job> job;
  {
    std::lock_guard<std::mutex> lock(jobs_mu_);
    auto it = jobs_.find(job_id);
    if (it == jobs_.end()) return JobStatus::kUnknown;
    job = it->second;
  }
  job->done_future.wait();
  // Exactly-once claim: a concurrent get_finished() poller may have
  // harvested (erased) the job between our lookup and the future
  // firing.  Only the claimant that removes the map entry reports the
  // status; the loser sees kUnknown, exactly as if it had arrived
  // after the harvest.  (The TSan stress harness, stress_main.cpp,
  // caught the pre-fix double-report.)
  JobStatus status = job->failed.load() == 0 ? JobStatus::kSucceeded
                                             : JobStatus::kFailed;
  {
    std::lock_guard<std::mutex> lock(jobs_mu_);
    if (jobs_.erase(job_id) == 0) return JobStatus::kUnknown;
  }
  return status;
}

}  // namespace kvtpu

// ---------------------------------------------------------------------------
// C ABI (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

uint64_t kvtpu_fnv1a64(const uint8_t* data, size_t len) {
  return kvtpu::fnv1a64(data, len);
}

// Returns the number of keys written (n_tokens / block_size).
size_t kvtpu_hash_chain(uint64_t parent_hash, const uint32_t* tokens,
                        size_t n_tokens, size_t block_size,
                        uint64_t* out_keys) {
  return kvtpu::hash_chain(parent_hash, tokens, n_tokens, block_size,
                           out_keys);
}

uint64_t kvtpu_xxh64(const uint8_t* data, size_t len, uint64_t seed) {
  return kvtpu::xxh64(data, len, seed);
}

void* kvtpu_engine_create(size_t n_threads, int numa_node) {
  return new kvtpu::OffloadEngine(n_threads, numa_node);
}

void kvtpu_engine_destroy(void* engine) {
  delete static_cast<kvtpu::OffloadEngine*>(engine);
}

static std::vector<std::string> collect_paths(const char** paths,
                                              size_t n) {
  std::vector<std::string> out;
  out.reserve(n);
  for (size_t i = 0; i < n; ++i) out.emplace_back(paths[i]);
  return out;
}

void kvtpu_engine_store(void* engine, int64_t job_id, const char** paths,
                        const uint8_t** buffers, const size_t* sizes,
                        size_t n_files, int skip_existing) {
  auto* e = static_cast<kvtpu::OffloadEngine*>(engine);
  e->store(job_id, collect_paths(paths, n_files),
           std::vector<const uint8_t*>(buffers, buffers + n_files),
           std::vector<size_t>(sizes, sizes + n_files),
           skip_existing != 0);
}

void kvtpu_engine_load(void* engine, int64_t job_id, const char** paths,
                       uint8_t** buffers, const size_t* sizes,
                       size_t n_files) {
  auto* e = static_cast<kvtpu::OffloadEngine*>(engine);
  e->load(job_id, collect_paths(paths, n_files),
          std::vector<uint8_t*>(buffers, buffers + n_files),
          std::vector<size_t>(sizes, sizes + n_files));
}

// Fills out_job_ids/out_statuses (capacity max_out); returns count.
// Jobs beyond max_out remain harvestable on the next call.
size_t kvtpu_engine_get_finished(void* engine, int64_t* out_job_ids,
                                 int32_t* out_statuses, size_t max_out) {
  auto* e = static_cast<kvtpu::OffloadEngine*>(engine);
  const auto finished = e->get_finished(max_out);
  const size_t n = finished.size();
  for (size_t i = 0; i < n; ++i) {
    out_job_ids[i] = finished[i].first;
    out_statuses[i] = static_cast<int32_t>(finished[i].second);
  }
  return n;
}

int32_t kvtpu_engine_wait(void* engine, int64_t job_id) {
  auto* e = static_cast<kvtpu::OffloadEngine*>(engine);
  return static_cast<int32_t>(e->wait(job_id));
}

int kvtpu_file_exists(const char* path) {
  return kvtpu::file_exists(path) ? 1 : 0;
}

}  // extern "C"
