// Native tokenizer engine for pydynet_tpu_torch (a copy of the JAX
// package's pydynet_tpu/native/tokenizer.cpp).
//
// The reference's SentencePiece-style greedy merge loop is O(n^2 * V) pure
// Python (list.index per candidate pair).  This C++ engine keeps the exact
// same semantics — UTF-8 character seeding, then repeatedly fusing the
// adjacent pair whose merged token has the best score — with hash-map
// lookups and an O(n) rescan per merge, exposed through a minimal C ABI
// consumed via ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -shared -fPIC tokenizer.cpp -o libpdt_tokenizer.so
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> index;  // first occurrence wins
  std::vector<std::string> tokens;
  std::vector<float> scores;
};

inline int32_t lookup(const Vocab* v, const std::string& s) {
  auto it = v->index.find(s);
  return it == v->index.end() ? -1 : it->second;
}

// length of the UTF-8 sequence starting at byte c
inline int utf8_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xe) return 3;
  if ((c >> 3) == 0x1e) return 4;
  return 1;  // invalid byte: treat as single char
}

}  // namespace

extern "C" {

// blob: concatenated token strings; offsets: n+1 byte offsets into blob
void* pdt_vocab_create(const char* blob, const int64_t* offsets, int64_t n,
                       const float* scores) {
  auto* v = new Vocab();
  v->tokens.reserve(n);
  v->scores.assign(scores, scores + n);
  for (int64_t i = 0; i < n; ++i) {
    v->tokens.emplace_back(blob + offsets[i], offsets[i + 1] - offsets[i]);
    v->index.emplace(v->tokens.back(), static_cast<int32_t>(i));
  }
  return v;
}

void pdt_vocab_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Greedy best-score merge encode (llama tokenizer semantics).
// Returns the number of ids written to out (<= out_cap), or -1 on overflow.
int64_t pdt_encode(void* handle, const char* text, int64_t text_len,
                   int32_t* out, int64_t out_cap) {
  const Vocab* v = static_cast<const Vocab*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(text_len);

  // seed: one id per UTF-8 character that exists in the vocab
  for (int64_t i = 0; i < text_len;) {
    int len = utf8_len(static_cast<unsigned char>(text[i]));
    if (i + len > text_len) len = 1;
    int32_t id = lookup(v, std::string(text + i, len));
    if (id >= 0) ids.push_back(id);
    i += len;
  }

  // greedy merges: best-scoring adjacent pair first (ties -> leftmost,
  // matching the reference's strict > comparison)
  std::string merged;
  while (ids.size() > 1) {
    float best_score = -1e10f;
    int32_t best_id = -1;
    int64_t best_idx = -1;
    for (size_t i = 0; i + 1 < ids.size(); ++i) {
      merged.assign(v->tokens[ids[i]]);
      merged += v->tokens[ids[i + 1]];
      int32_t id = lookup(v, merged);
      if (id != -1 && v->scores[id] > best_score) {
        best_score = v->scores[id];
        best_id = id;
        best_idx = static_cast<int64_t>(i);
      }
    }
    if (best_idx < 0) break;
    ids[best_idx] = best_id;
    ids.erase(ids.begin() + best_idx + 1);
  }

  if (static_cast<int64_t>(ids.size()) > out_cap) return -1;
  std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int64_t>(ids.size());
}

}  // extern "C"
