// Greedy CTC collapse: argmax-id sequences -> label indices + offsets.
//
// A per-character Python loop over every frame of every utterance is the
// cost of greedy decoding when string metrics run every training step.
// This function does the collapse (skip blanks, merge repeats) in C++; the
// Python side (decoding/decoder.py::GreedyDecoder) only maps the few
// surviving indices to chars.

#include <cstdint>

extern "C" {

// Returns the number of emitted symbols. out_ids/out_offsets must have
// room for `size` entries.
int64_t w2l_greedy_collapse(const int32_t* ids, int64_t size,
                            int64_t blank_index, int32_t* out_ids,
                            int32_t* out_offsets) {
  int64_t n = 0;
  int32_t prev = -1;
  for (int64_t i = 0; i < size; ++i) {
    const int32_t id = ids[i];
    if (id != blank_index && id != prev) {
      out_ids[n] = id;
      out_offsets[n] = (int32_t)i;
      ++n;
    }
    prev = id;
  }
  return n;
}

}  // extern "C"
