// ARPA n-gram language model scorer (kenlm-equivalent core).
//
// The beam search scores prefixes as `10**model.score(prefix)` with a
// kenlm-compatible model. kenlm is a C++ library behind Python bindings;
// this is a C++ implementation of the same scoring semantics for
// ARPA-format models:
//
//   score(sentence) = sum over words w_i (plus </s>) of
//       log10 P(w_i | w_{i-k}..w_{i-1})
//   with <s> as implicit initial context, Katz backoff
//       P(w | ctx) = p(ctx+w)                  if the n-gram exists
//                  = backoff(ctx) + P(w | ctx[1:])   otherwise
//   and unknown words mapped to <unk>.
//
// Exposed via a C ABI for ctypes (decoding/arpa_lm.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
  float logp = 0.0f;      // log10 probability
  float backoff = 0.0f;   // log10 backoff weight
  bool has_backoff = false;
};

struct ArpaModel {
  int order = 0;
  // n-gram "w1 w2 ... wn" -> entry. One map per order (1-indexed).
  std::vector<std::unordered_map<std::string, Entry>> grams;
  bool has_unk = false;
};

std::string join(const std::vector<std::string>& words, size_t begin,
                 size_t end) {
  std::string out;
  for (size_t i = begin; i < end; ++i) {
    if (!out.empty()) out.push_back(' ');
    out += words[i];
  }
  return out;
}

const Entry* find(const ArpaModel& m, const std::vector<std::string>& words,
                  size_t begin, size_t end) {
  const size_t n = end - begin;
  if (n == 0 || n > m.grams.size()) return nullptr;
  const auto& map = m.grams[n - 1];
  auto it = map.find(join(words, begin, end));
  return it == map.end() ? nullptr : &it->second;
}

// log10 P(words[end-1] | words[begin..end-1]) with backoff.
double cond_logp(const ArpaModel& m, const std::vector<std::string>& words,
                 size_t begin, size_t end) {
  if (const Entry* e = find(m, words, begin, end)) return e->logp;
  if (end - begin == 1) {
    // Unigram missing: fall back to <unk> if the model has one.
    if (m.has_unk) {
      auto it = m.grams[0].find("<unk>");
      if (it != m.grams[0].end()) return it->second.logp;
    }
    // No <unk> in the model: kenlm substitutes log10 -100 for unknown
    // words when configured to load such ARPA files
    // (lm::ngram::Config::unknown_missing_logprob default).
    return -100.0;
  }
  double bo = 0.0;
  if (const Entry* ctx = find(m, words, begin, end - 1)) {
    bo = ctx->backoff;
  }
  return bo + cond_logp(m, words, begin + 1, end);
}

std::vector<std::string> tokenize(const char* text) {
  std::vector<std::string> words;
  std::istringstream iss(text);
  std::string w;
  while (iss >> w) words.push_back(w);
  return words;
}

}  // namespace

extern "C" {

void* w2l_arpa_load(const char* path) {
  std::ifstream in(path);
  if (!in) return nullptr;
  auto* model = new ArpaModel();
  std::string line;
  int current_order = 0;
  bool in_data = false;
  while (std::getline(in, line)) {
    // Trim trailing CR (Windows ARPA files exist in the wild).
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
      line.pop_back();
    if (line.empty()) continue;
    if (line == "\\data\\") {
      in_data = true;
      continue;
    }
    if (in_data && line.rfind("ngram ", 0) == 0) {
      // "ngram N=count"
      int n = std::atoi(line.c_str() + 6);
      if (n > model->order) model->order = n;
      if ((int)model->grams.size() < n) model->grams.resize(n);
      continue;
    }
    if (line[0] == '\\') {
      if (line == "\\end\\") break;
      // "\N-grams:" section header
      current_order = std::atoi(line.c_str() + 1);
      in_data = false;
      continue;
    }
    if (current_order <= 0) continue;
    // "logp<TAB>w1 w2 ... wn[<TAB>backoff]"
    std::istringstream iss(line);
    float logp;
    if (!(iss >> logp)) continue;
    std::vector<std::string> toks;
    std::string tok;
    while (iss >> tok) toks.push_back(tok);
    Entry e;
    e.logp = logp;
    size_t nwords = toks.size();
    // Last token is a backoff weight iff there are order+1 tokens.
    if ((int)toks.size() == current_order + 1) {
      e.backoff = std::strtof(toks.back().c_str(), nullptr);
      e.has_backoff = true;
      nwords -= 1;
    }
    if ((int)nwords != current_order) continue;  // malformed line
    std::string key = join(toks, 0, nwords);
    if ((int)model->grams.size() < current_order)
      model->grams.resize(current_order);
    model->grams[current_order - 1].emplace(std::move(key), e);
  }
  model->has_unk = !model->grams.empty() &&
                   model->grams[0].count("<unk>") > 0;
  if (model->order == 0) {
    delete model;
    return nullptr;
  }
  return model;
}

int w2l_arpa_order(void* handle) {
  return handle ? static_cast<ArpaModel*>(handle)->order : 0;
}

// kenlm Model.score(sentence, bos=true, eos=true): log10 prob of the word
// sequence with <s> context and a final </s> term.
double w2l_arpa_score(void* handle, const char* sentence, int bos, int eos) {
  if (!handle) return -100.0;
  const ArpaModel& m = *static_cast<ArpaModel*>(handle);
  std::vector<std::string> words;
  if (bos) words.push_back("<s>");
  for (auto& w : tokenize(sentence)) {
    // kenlm maps OOV tokens to <unk> before scoring (so they also act as
    // <unk> when appearing in contexts).
    if (m.has_unk && !m.grams.empty() && m.grams[0].count(w) == 0) {
      words.push_back("<unk>");
    } else {
      words.push_back(std::move(w));
    }
  }
  if (eos) words.push_back("</s>");

  double total = 0.0;
  const size_t start = bos ? 1 : 0;
  for (size_t i = start; i < words.size(); ++i) {
    size_t begin = (i + 1 > (size_t)m.order) ? i + 1 - m.order : 0;
    total += cond_logp(m, words, begin, i + 1);
  }
  return total;
}

void w2l_arpa_free(void* handle) {
  delete static_cast<ArpaModel*>(handle);
}

}  // extern "C"
