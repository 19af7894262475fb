// Chained CBOR/FNV block hashing — native fast path for the contract
// implemented in kvcache/kvblock/token_processor.py (see its docstring for
// the cross-system semantics; parity is enforced by tests that compare
// this implementation against the Python one).

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

}  // namespace kvtpu
