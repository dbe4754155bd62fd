// CTC prefix beam search in C++ (the decode hot loop).
//
// Same algorithm and bookkeeping as the Python implementation in
// wav2letter_pytorch_tpu_torch/decoding/decoder.py::prefix_beam_search:
// probability-space Pb/Pnb dynamic programming, per-step prune threshold,
// LM^alpha applied at word boundaries (space or end_char),
// (word_count+1)^beta beam ranking, discarded-prefix re-merge, end_char
// termination. The language model is the native ARPA scorer (arpa_lm.cpp),
// called in-process — no Python round-trips inside the T x beams x
// alphabet loop.
//
// Prefixes are sequences of unicode codepoints (u32), so all label sets
// (incl. Hebrew) work unmodified.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {
double w2l_arpa_score(void* handle, const char* sentence, int bos, int eos);
}

namespace {

using U32Str = std::u32string;

struct U32Hash {
  size_t operator()(const U32Str& s) const {
    size_t h = 1469598103934665603ull;
    for (char32_t c : s) {
      h ^= (size_t)c;
      h *= 1099511628211ull;
    }
    return h;
  }
};

template <typename V>
using Map = std::unordered_map<U32Str, V, U32Hash>;

void append_utf8(std::string& out, char32_t c) {
  if (c < 0x80) {
    out.push_back((char)c);
  } else if (c < 0x800) {
    out.push_back((char)(0xC0 | (c >> 6)));
    out.push_back((char)(0x80 | (c & 0x3F)));
  } else if (c < 0x10000) {
    out.push_back((char)(0xE0 | (c >> 12)));
    out.push_back((char)(0x80 | ((c >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (c & 0x3F)));
  } else {
    out.push_back((char)(0xF0 | (c >> 18)));
    out.push_back((char)(0x80 | ((c >> 12) & 0x3F)));
    out.push_back((char)(0x80 | ((c >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (c & 0x3F)));
  }
}

std::string to_utf8(const U32Str& s) {
  std::string out;
  out.reserve(s.size());
  for (char32_t c : s) append_utf8(out, c);
  return out;
}

// Python re \w for our label sets: letters, digits, underscore. Apostrophe,
// space, '>' and '|' are not word chars.
bool is_word_char(char32_t c) {
  if (c == U' ' || c == U'>' || c == U'|' || c == U'\'') return false;
  if (c >= U'0' && c <= U'9') return true;
  if (c == U'_') return true;
  if ((c >= U'A' && c <= U'Z') || (c >= U'a' && c <= U'z')) return true;
  return c >= 0x80;  // non-ASCII letters (Hebrew etc.) count as \w
}

bool is_separator(char32_t c) {
  return c == U' ' || c == U'>' || c == U'|' || c == U'\t' || c == U'\n';
}

// Count of `\w+[\s|>]` matches (completed words).
int word_count(const U32Str& s) {
  int n = 0;
  for (size_t i = 0; i + 1 < s.size(); ++i) {
    if (is_word_char(s[i]) && is_separator(s[i + 1])) ++n;
  }
  return n;
}

bool has_non_space(const U32Str& s) {
  for (char32_t c : s)
    if (c != U' ') return true;
  return false;
}

U32Str strip(const U32Str& s, char32_t end_char) {
  size_t b = 0, e = s.size();
  auto strippable = [&](char32_t c) { return c == U' ' || c == end_char; };
  while (b < e && strippable(s[b])) ++b;
  while (e > b && strippable(s[e - 1])) --e;
  return s.substr(b, e - b);
}

}  // namespace

extern "C" {

// Returns the decoded length (codepoints written to `out`, capped at
// out_cap) and the ranked score via *out_score. `lm` may be null.
//
// Hotword contextual biasing (decoder.py::HotwordTrie parity): `hotwords`
// is `n_hotwords` codepoint runs delimited by `hw_offsets` (n+1 entries);
// every character extending a prefix of a hotword multiplies the path
// mass by `hotword_weight` (partial credit), cancelled on divergence or
// non-hotword completion. n_hotwords == 0 disables (bit-exact with the
// unbiased search).
int64_t w2l_prefix_beam_search(
    const float* ctc, int64_t T, int64_t L, const uint32_t* labels,
    int64_t blank_index, void* lm, int64_t k, double alpha, double beta,
    double prune, uint32_t end_char_u, const uint32_t* hotwords,
    const int64_t* hw_offsets, int64_t n_hotwords, double hotword_weight,
    uint32_t* out, int64_t out_cap, double* out_score) {
  const char32_t end_char = (char32_t)end_char_u;
  const char32_t blank_char = (char32_t)labels[blank_index];

  auto lm_weight = [&](const U32Str& prefix) -> double {
    if (!lm) return 1.0;
    std::string utf8 = to_utf8(strip(prefix, end_char));
    return std::pow(10.0, w2l_arpa_score(lm, utf8.c_str(), 1, 1));
  };

  const bool bias = n_hotwords > 0;
  std::unordered_set<U32Str, U32Hash> hw_words, hw_prefixes;
  for (int64_t i = 0; i < n_hotwords; ++i) {
    U32Str w;
    for (int64_t j = hw_offsets[i]; j < hw_offsets[i + 1]; ++j)
      w.push_back((char32_t)hotwords[j]);
    hw_words.insert(w);
    for (size_t l = 1; l <= w.size(); ++l) hw_prefixes.insert(w.substr(0, l));
  }
  auto units = [&](const U32Str& partial) -> int {
    return hw_prefixes.count(partial) ? (int)partial.size() : 0;
  };
  auto last_partial = [&](const U32Str& prefix) -> U32Str {
    size_t pos = prefix.rfind(U' ');
    return pos == U32Str::npos ? prefix : prefix.substr(pos + 1);
  };
  auto extend_w = [&](const U32Str& prefix, char32_t c) -> double {
    U32Str partial = last_partial(prefix);
    U32Str grown = partial;
    grown.push_back(c);
    return std::pow(hotword_weight, units(grown) - units(partial));
  };
  auto complete_w = [&](const U32Str& prefix) -> double {
    U32Str word = last_partial(prefix);
    return hw_words.count(word) ? 1.0
                                : std::pow(hotword_weight, -units(word));
  };

  Map<double> pb_prev, pnb_prev;
  pb_prev[U32Str()] = 1.0;
  std::vector<U32Str> beams = {U32Str()};
  Map<double> scores;

  std::vector<int64_t> pruned;
  for (int64_t t = 0; t < T; ++t) {
    const float* step = ctc + t * L;
    pruned.clear();
    for (int64_t i = 0; i < L; ++i)
      if (step[i] > prune) pruned.push_back(i);

    Map<double> pb, pnb;
    std::unordered_set<U32Str, U32Hash> in_beam(beams.begin(), beams.end());
    auto get = [](const Map<double>& m, const U32Str& key) -> double {
      auto it = m.find(key);
      return it == m.end() ? 0.0 : it->second;
    };

    for (const U32Str& prefix : beams) {
      if (!prefix.empty() && prefix.back() == end_char) {
        pb[prefix] = get(pb_prev, prefix);
        pnb[prefix] = get(pnb_prev, prefix);
        continue;
      }
      const double prev_total = get(pb_prev, prefix) + get(pnb_prev, prefix);
      for (int64_t c_ix : pruned) {
        const double p_c = step[c_ix];
        const char32_t c = (char32_t)labels[c_ix];
        if (c == blank_char) {
          pb[prefix] += step[blank_index] * prev_total;
          continue;
        }
        U32Str extended = prefix;
        extended.push_back(c);
        if (!prefix.empty() && c == prefix.back()) {
          const double w_h = bias ? extend_w(prefix, c) : 1.0;
          pnb[extended] += w_h * p_c * get(pb_prev, prefix);
          pnb[prefix] += p_c * get(pnb_prev, prefix);
        } else if (has_non_space(prefix) && (c == U' ' || c == end_char)) {
          double lmw = std::pow(lm_weight(extended), alpha);
          if (bias) lmw *= complete_w(prefix);
          pnb[extended] += lmw * p_c * prev_total;
        } else {
          const double w_h = bias ? extend_w(prefix, c) : 1.0;
          pnb[extended] += w_h * p_c * prev_total;
        }
        if (!in_beam.count(extended)) {
          pb[extended] += step[blank_index] *
                          (get(pb_prev, extended) + get(pnb_prev, extended));
          pnb[extended] += p_c * get(pnb_prev, extended);
        }
      }
    }

    scores.clear();
    for (auto& kv : pb) scores[kv.first] += kv.second;
    for (auto& kv : pnb) scores[kv.first] += kv.second;

    std::vector<std::pair<double, const U32Str*>> ranked;
    ranked.reserve(scores.size());
    for (auto& kv : scores) {
      double rank = kv.second * std::pow(word_count(kv.first) + 1.0, beta);
      ranked.emplace_back(rank, &kv.first);
    }
    std::stable_sort(ranked.begin(), ranked.end(),
                     [](const auto& a, const auto& b) {
                       return a.first > b.first;
                     });
    beams.clear();
    for (size_t i = 0; i < ranked.size() && (int64_t)i < k; ++i)
      beams.push_back(*ranked[i].second);

    pb_prev.swap(pb);
    pnb_prev.swap(pnb);

    // Hour-scale inputs: the raw-probability DP underflows double after
    // a few thousand frames (product of per-frame probabilities). A
    // uniform rescale of every prefix mass is exactly ranking-preserving
    // (the recursion and the rank are linear in the masses); short
    // inputs never trigger it, keeping bit-exact parity with the Python
    // DP. Mirrors decoder.py::IncrementalPrefixBeam's renormalization.
    if (!beams.empty()) {
      const double top =
          [&] {
            auto itb = pb_prev.find(beams[0]);
            auto itn = pnb_prev.find(beams[0]);
            return (itb == pb_prev.end() ? 0.0 : itb->second) +
                   (itn == pnb_prev.end() ? 0.0 : itn->second);
          }();
      if (top > 0.0 && top < 1e-30) {
        const double inv = 1.0 / top;
        for (auto& kv : pb_prev) kv.second *= inv;
        for (auto& kv : pnb_prev) kv.second *= inv;
        for (auto& kv : scores) kv.second *= inv;  // final-mass report
      }
    }
  }

  U32Str best = beams.empty() ? U32Str() : beams[0];
  auto it = scores.find(best);
  double mass = it == scores.end() ? 0.0 : it->second;
  *out_score = mass * std::pow(word_count(best) + 1.0, beta);
  int64_t n = std::min<int64_t>((int64_t)best.size(), out_cap);
  for (int64_t i = 0; i < n; ++i) out[i] = (uint32_t)best[i];
  return n;
}

}  // extern "C"
