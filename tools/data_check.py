#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (the data layer) alone, on the card: a
few minutes instead of a full run.

    python3 tools/data_check.py      # from a checkout's root, one GPU

Builds the kernels and the host library (``chip_smoke.phase_build``), then
runs ``chip_smoke.phase_data`` in a temporary directory: the FLAC corpus
of ``make_offline_corpus``, FLAC exactness and decode rates, the int16
wire, the audio cache, loader resampling, MFCC (eval step card vs CPU, an
MFCC artifact streamed against its offline forward) and
``full_depth_run`` at full width (Wav2Letter-20) for two epochs, with
every gate and time of the full run's phase.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print('data_check: no CUDA device', file=sys.stderr)
        return 1
    t0 = time.time()
    cs.port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    print(card)
    cs.phase_build()
    with tempfile.TemporaryDirectory() as root:
        k1 = cs.phase_data(root, card)
    print(json.dumps({'data_launches': {'stft_mel_log': sum(k1.values())},
                      'by_part': k1}))
    print(f'total {time.time() - t0:.1f} s [{card}]')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
