#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` (tensor parallelism) alone, on the card:
a few minutes instead of a full run.

    python3 tools/tp_check.py        # a checkout's root, one GPU

Builds the kernels (``chip_smoke.phase_build``), writes the 64-utterance
corpus, then runs ``chip_smoke.phase_tensor_parallel``: Wav2Letter-20 and
QuartzNet-15x2 at full width with ``trainer.mesh.model=2`` on two ranks
sharing the card over gloo, in float32 and in ``model.compute_dtype=bf16``
(also at 3 layers / 2 blocks), and Wav2Letter-4 on four ranks (data=2 x
model=2, a gradient clip), each against one process on the same global
batch, with every gate and number of the full run's phase 23 and each
kernel's launches on those paths, and K4-K7 on bf16 x at a rank's
shapes.
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
        print('tp_check: no CUDA device', file=sys.stderr)
        return 1
    t0 = time.time()
    cs.port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    print(card)
    cs.phase_build()
    with tempfile.TemporaryDirectory() as root:
        manifest, _ = cs.write_corpus(root)
        launches, bf16, errs, _ = cs.phase_tensor_parallel(manifest, root,
                                                           card)
    print(json.dumps({'tp_launches': launches, 'tp_bf16_launches': bf16,
                      'bf16_max_abs_err': errs}))
    print(f'total {time.time() - t0:.1f} s [{card}]')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
