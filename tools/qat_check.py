#!/usr/bin/env python3
"""Phases 20 and 21 of ``chip_smoke.py`` (quantization-aware finetuning and
the serving tools) alone, on the card: a few minutes instead of a full
run.

    python3 tools/qat_check.py [--tools-epochs N]   # a checkout's root

Builds the kernels and the host library (``chip_smoke.phase_build``),
writes the 64-utterance corpus, trains a Wav2Letter-20 run at full width
as phase 7 does (``chip_smoke.phase_train_main``: 4 steps, then 2 more
resumed), exports it as int8 with CMVN and static activation scales
(``export_serving --int8 --cmvn-manifest --calibrate``), then runs
``chip_smoke.phase_qat`` on them and ``chip_smoke.phase_tools``
(``--tools-epochs``: the demo's epochs, default the full run's): every
gate and time of the full run's phases 20 and 21.
"""

from __future__ import annotations

import argparse
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
    parser = argparse.ArgumentParser()
    parser.add_argument('--tools-epochs', type=int, default=cs.TOOLS_EPOCHS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('qat_check: no CUDA device', file=sys.stderr)
        return 1
    cs.TOOLS_EPOCHS = args.tools_epochs
    t0 = time.time()
    cs.port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    print(card)
    cs.phase_build()
    with tempfile.TemporaryDirectory() as root:
        manifest, _ = cs.write_corpus(root)
        _, run = cs.phase_train_main(manifest, root)
        torch.cuda.empty_cache()
        art = os.path.join(root, 'artifact_int8')
        cs.run_quiet(cs.port_export.main, [
            '--model-path', run, '--out', art, '--int8', '--cmvn-manifest',
            manifest, '--calibrate', '--device', str(cs.DEVICE)],
            what='export_serving --int8 --calibrate')
        qat = cs.phase_qat(manifest, run, {'int8': art}, root, card)
        torch.cuda.empty_cache()
        tools = cs.phase_tools(root, card)
    print(json.dumps({'qat_launches': {k: qat[k] + tools[k] for k in qat},
                      'phase_20': qat, 'phase_21': tools}))
    print(f'total {time.time() - t0:.1f} s [{card}]')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
