"""Decoding of the PyTorch port: greedy, host beam search (C++ or Python)
with an ARPA LM and hotwords, the batched device beam search, forced
alignment and edit distance."""

from .beam_device import DeviceBeamDecoder, beam_search_device
from .decoder import (Decoder, GreedyDecoder, HotwordTrie,
                      IncrementalPrefixBeam, PrefixBeamSearchLMDecoder,
                      get_time_per_word, prefix_beam_search)
from .forced_align import forced_align, word_alignments

__all__ = ['Decoder', 'DeviceBeamDecoder', 'GreedyDecoder', 'HotwordTrie',
           'IncrementalPrefixBeam', 'PrefixBeamSearchLMDecoder',
           'beam_search_device', 'forced_align', 'get_time_per_word',
           'prefix_beam_search', 'word_alignments']
