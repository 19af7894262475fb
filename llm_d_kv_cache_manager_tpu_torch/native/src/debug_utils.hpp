// Env-gated debug logging + phase timing for the native engine.
//
// Capability parity with the reference's debug utils
// (csrc/storage/debug_utils.hpp): set KVTPU_NATIVE_DEBUG=1 to get
// per-phase timing lines on stderr; zero overhead when unset beyond
// one cached getenv check.

#pragma once

#include <chrono>
#include <cstdio>
#include <cstdlib>

namespace kvtpu {

inline bool debug_enabled() {
  static const bool enabled = [] {
    const char* env = std::getenv("KVTPU_NATIVE_DEBUG");
    return env != nullptr && env[0] != '\0' && env[0] != '0';
  }();
  return enabled;
}

#define KVTPU_DEBUG_PRINT(...)                  \
  do {                                          \
    if (::kvtpu::debug_enabled()) {             \
      std::fprintf(stderr, "[kvtpu] " __VA_ARGS__); \
      std::fputc('\n', stderr);                 \
    }                                           \
  } while (0)

// Evaluates expr; when debugging, also logs its wall time under `label`.
#define KVTPU_TIME_EXPR(label, expr)                                     \
  do {                                                                   \
    if (::kvtpu::debug_enabled()) {                                      \
      auto kvtpu_t0 = std::chrono::steady_clock::now();                  \
      expr;                                                              \
      auto kvtpu_us = std::chrono::duration_cast<std::chrono::microseconds>( \
                          std::chrono::steady_clock::now() - kvtpu_t0)   \
                          .count();                                      \
      std::fprintf(stderr, "[kvtpu] %s: %lld us\n", label,               \
                   static_cast<long long>(kvtpu_us));                    \
    } else {                                                             \
      expr;                                                              \
    }                                                                    \
  } while (0)

}  // namespace kvtpu
