// Chained CBOR/FNV block hashing — native fast path for the contract
// implemented in kvcache/kvblock/token_processor.py (see its docstring for
// the cross-system semantics; parity is enforced by tests that compare
// this implementation against the Python one) — and XXH64, which keys the
// prefix store's text chunks (tokenization/prefixstore/lru_store.py).

#include "kvtpu_native.hpp"

namespace kvtpu {

namespace {

constexpr uint64_t kFnvOffset = 0xcbf29ce484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001b3ULL;

// Canonical CBOR head: shortest-form unsigned argument.
void encode_head(uint8_t major, uint64_t value, std::vector<uint8_t>& out) {
  const uint8_t mt = static_cast<uint8_t>(major << 5);
  if (value < 24) {
    out.push_back(mt | static_cast<uint8_t>(value));
  } else if (value < 0x100) {
    out.push_back(mt | 24);
    out.push_back(static_cast<uint8_t>(value));
  } else if (value < 0x10000) {
    out.push_back(mt | 25);
    out.push_back(static_cast<uint8_t>(value >> 8));
    out.push_back(static_cast<uint8_t>(value));
  } else if (value < 0x100000000ULL) {
    out.push_back(mt | 26);
    for (int shift = 24; shift >= 0; shift -= 8)
      out.push_back(static_cast<uint8_t>(value >> shift));
  } else {
    out.push_back(mt | 27);
    for (int shift = 56; shift >= 0; shift -= 8)
      out.push_back(static_cast<uint8_t>(value >> shift));
  }
}

}  // namespace

uint64_t fnv1a64(const uint8_t* data, size_t len) {
  uint64_t h = kFnvOffset;
  for (size_t i = 0; i < len; ++i) {
    h ^= data[i];
    h *= kFnvPrime;
  }
  return h;
}

void encode_chunk_payload(uint64_t parent, const uint32_t* tokens,
                          size_t n_tokens, std::vector<uint8_t>& out) {
  out.push_back(0x83);  // array(3)
  encode_head(0, parent, out);
  encode_head(4, n_tokens, out);  // array(n_tokens)
  for (size_t i = 0; i < n_tokens; ++i) encode_head(0, tokens[i], out);
  out.push_back(0xf6);  // null extra
}

size_t hash_chain(uint64_t parent_hash, const uint32_t* tokens,
                  size_t n_tokens, size_t block_size, uint64_t* out_keys) {
  if (block_size == 0) return 0;
  const size_t n_chunks = n_tokens / block_size;
  uint64_t prefix = parent_hash;
  std::vector<uint8_t> payload;
  payload.reserve(3 + 9 + 5 + 5 * block_size);
  for (size_t c = 0; c < n_chunks; ++c) {
    payload.clear();
    encode_chunk_payload(prefix, tokens + c * block_size, block_size,
                         payload);
    prefix = fnv1a64(payload.data(), payload.size());
    out_keys[c] = prefix;
  }
  return n_chunks;
}

namespace {

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kP3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

// Little-endian loads, whatever the host's byte order.
inline uint64_t load64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

inline uint32_t load32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * kP2;
  return rotl(acc, 31) * kP1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  acc ^= xxh_round(0, val);
  return acc * kP1 + kP4;
}

}  // namespace

uint64_t xxh64(const uint8_t* data, size_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* const end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + kP1 + kP2;
    uint64_t v2 = seed + kP2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - kP1;
    const uint8_t* const limit = end - 32;
    do {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint64_t>(len);
  for (; p + 8 <= end; p += 8) {
    h ^= xxh_round(0, load64(p));
    h = rotl(h, 27) * kP1 + kP4;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(load32(p)) * kP1;
    h = rotl(h, 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; ++p) {
    h ^= static_cast<uint64_t>(*p) * kP5;
    h = rotl(h, 11) * kP1;
  }
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

}  // namespace kvtpu
