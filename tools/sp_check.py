#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` (sequence parallelism) alone, on the
card: a few minutes instead of a full run.

    python3 tools/sp_check.py        # a checkout's root, one GPU

Builds the kernels (``chip_smoke.phase_build``), writes the 64-utterance
corpus, then runs ``chip_smoke.phase_sequence_parallel``: Wav2Letter-20
and QuartzNet-15x2 at full width with ``trainer.mesh.seq=2`` on two ranks
sharing the card over gloo, in float32 and in ``model.compute_dtype=bf16``
(also at 3 layers / 2 blocks), each against one process on the same global
batch (run here first: a full run reuses phase 23's), with every gate and
number of the full run's phase 24, each kernel's launches on those paths
and K1-K7 against their plain versions at the SP path's shapes (K4-K7
on bf16 x too).
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
        print('sp_check: no CUDA device', file=sys.stderr)
        return 1
    t0 = time.time()
    cs.port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    print(card)
    cs.phase_build()
    with tempfile.TemporaryDirectory() as root:
        manifest, _ = cs.write_corpus(root)
        launches, errs, bf16, bf16_errs = cs.phase_sequence_parallel(
            manifest, root, card)
    print(json.dumps({'sp_launches': launches, 'max_abs_err': errs,
                      'sp_bf16_launches': bf16,
                      'bf16_max_abs_err': bf16_errs}))
    print(f'total {time.time() - t0:.1f} s [{card}]')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
