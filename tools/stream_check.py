#!/usr/bin/env python3
"""The streaming phases of ``chip_smoke.py`` alone, on the card, without
training: a few minutes instead of a full run.

    python3 tools/stream_check.py [--jasper-only]   # from a checkout's root

Builds the kernels (``chip_smoke.phase_build``), writes the 64-utterance
corpus, makes a Wav2Letter-20 and a QuartzNet-15x5 run directory at full
width with no checkpoint (``evaluate --model-path`` then draws the weights
from seed 0), trains the corpus 3-gram, exports the serving artifacts
(``chip_smoke.phase_serving_exports``: f32 + CMVN, int8 + CMVN + static
scales, f32 + LM) and runs ``chip_smoke.phase_streaming`` on them, then
``chip_smoke.phase_streaming_jasper`` on the QuartzNet run: every gate
and time of the full run's phases 17 and 18, on random weights. With
``--jasper-only``, the kernels, the corpus and phase 18 alone.
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


def random_run(root: str, name: str, *overrides) -> str:
    """A run directory holding only the full-width config."""
    run = os.path.join(root, name)
    os.makedirs(run)
    with open(os.path.join(run, 'config.json'), 'w') as f:
        json.dump(cs.train_config(*overrides), f)
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print('stream_check: no CUDA device', file=sys.stderr)
        return 1
    jasper_only = '--jasper-only' in sys.argv[1:]
    t0 = time.time()
    cs.port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    print(card)
    cs.phase_build()
    with tempfile.TemporaryDirectory() as root:
        manifest, _ = cs.write_corpus(root)
        qn = random_run(root, 'qn', *cs.QN)
        out = {'k1': {}, 'qn': {'depthwise_fwd': 0, 'sep_fwd': 0},
               'k1_err': 0.0}
        if not jasper_only:
            w2l = random_run(root, 'w2l')
            lm = cs.phase_lm(manifest, root)
            arts = cs.phase_serving_exports(manifest, w2l, lm, root, card,
                                            {})
            out = cs.phase_streaming(manifest, w2l, qn, arts, root, card)
        qn_out = cs.phase_streaming_jasper(manifest, qn, root, card)
    print(json.dumps({'streaming_launches': {
        'stft_mel_log': sum(out['k1'].values())
        + sum(qn_out['k1'].values()),
        'depthwise_fwd': out['qn']['depthwise_fwd']
        + sum(qn_out['k4'].values()),
        'sep_fwd': out['qn']['sep_fwd']},
        'k1_max_abs_err': max(out['k1_err'], qn_out['k1_err']),
        'k4_max_abs_err': qn_out['k4_err']}))
    print(f'total {time.time() - t0:.1f} s [{card}]')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
