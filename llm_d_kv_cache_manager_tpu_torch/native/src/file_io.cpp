// Atomic file persistence for KV blocks on shared storage.
// Write = temp + rename so concurrent pods never observe torn files;
// read validates exact size (reference: csrc/storage/file_io.cpp).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdio>
#include <filesystem>
#include <fstream>

#include "kvtpu_native.hpp"

namespace kvtpu {

namespace {
std::atomic<uint64_t> g_tmp_counter{0};
}

bool file_exists(const std::string& path) {
  struct stat st;
  return ::stat(path.c_str(), &st) == 0;
}

// -1 when the file does not exist.
int64_t file_size(const std::string& path) {
  struct stat st;
  if (::stat(path.c_str(), &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

bool write_buffer_to_file(const std::string& path, const uint8_t* data,
                          size_t size) {
  namespace fs = std::filesystem;
  std::error_code ec;
  const fs::path target(path);
  if (target.has_parent_path()) {
    fs::create_directories(target.parent_path(), ec);  // ok if exists
  }

  // Thread-unique temp name in the same directory (rename must not cross
  // filesystems).
  const uint64_t unique = g_tmp_counter.fetch_add(1);
  std::string tmp = path + ".tmp." + std::to_string(::getpid()) + "." +
                    std::to_string(unique);

  {
    std::ofstream out(tmp, std::ios::binary | std::ios::trunc);
    if (!out) return false;
    out.write(reinterpret_cast<const char*>(data),
              static_cast<std::streamsize>(size));
    if (!out) {
      out.close();
      ::unlink(tmp.c_str());
      return false;
    }
  }
  if (::rename(tmp.c_str(), path.c_str()) != 0) {
    ::unlink(tmp.c_str());
    return false;
  }
  return true;
}

bool read_buffer_from_file(const std::string& path, uint8_t* data,
                           size_t size) {
  struct stat st;
  if (::stat(path.c_str(), &st) != 0) return false;
  // Head-of-group semantics: a partial request reads the head of a
  // (possibly larger) group file; a smaller file is a miss.
  if (static_cast<size_t>(st.st_size) < size) return false;
  std::ifstream in(path, std::ios::binary);
  if (!in) return false;
  in.read(reinterpret_cast<char*>(data),
          static_cast<std::streamsize>(size));
  return static_cast<size_t>(in.gcount()) == size;
}

bool touch_file(const std::string& path) {
  // nullptr = set both atime and mtime to now (matches os.utime()).
  // False when the file vanished (store-dedupe racing a sweeper
  // delete): the job must fail rather than advertise a gone block.
  return ::utimensat(AT_FDCWD, path.c_str(), nullptr, 0) == 0;
}

}  // namespace kvtpu
