// Native edit-distance kernel for WER/CER metrics.
//
// The counterpart of the `python-Levenshtein` C extension that WER/CER
// are usually computed with. Operates on arrays of 32-bit code points so
// the same entry point serves both character-level distance (CER) and
// word-level distance (WER, with words pre-mapped to integer ids on the
// Python side).
//
// Exposed via a plain C ABI and loaded with ctypes
// (decoding/levenshtein.py).

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// Classic Wagner–Fischer with two rolling rows. O(len_a * len_b) time,
// O(min(len_a, len_b)) space.
int64_t w2l_levenshtein_u32(const uint32_t* a, int64_t len_a,
                            const uint32_t* b, int64_t len_b) {
  if (len_a == 0) return len_b;
  if (len_b == 0) return len_a;
  // Iterate over the longer string, keep rows sized by the shorter one.
  if (len_a < len_b) {
    std::swap(a, b);
    std::swap(len_a, len_b);
  }
  std::vector<int64_t> prev(len_b + 1), curr(len_b + 1);
  for (int64_t j = 0; j <= len_b; ++j) prev[j] = j;
  for (int64_t i = 1; i <= len_a; ++i) {
    curr[0] = i;
    const uint32_t ca = a[i - 1];
    for (int64_t j = 1; j <= len_b; ++j) {
      const int64_t cost = (ca == b[j - 1]) ? 0 : 1;
      curr[j] = std::min({prev[j] + 1,        // deletion
                          curr[j - 1] + 1,    // insertion
                          prev[j - 1] + cost}); // substitution
    }
    std::swap(prev, curr);
  }
  return prev[len_b];
}

// Batched variant: distances for `n` pairs laid out in flat arrays with
// per-pair offsets, so metric aggregation over a decoded batch needs a
// single FFI crossing.
void w2l_levenshtein_u32_batch(const uint32_t* a, const int64_t* a_off,
                               const uint32_t* b, const int64_t* b_off,
                               int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = w2l_levenshtein_u32(a + a_off[i], a_off[i + 1] - a_off[i],
                                 b + b_off[i], b_off[i + 1] - b_off[i]);
  }
}

}  // extern "C"
