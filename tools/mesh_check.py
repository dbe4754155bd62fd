#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` (data parallelism) alone, on the card: a
few minutes instead of a full run.

    python3 tools/mesh_check.py        # a checkout's root, one GPU

Builds the kernels (``chip_smoke.phase_build``), writes the 64-utterance
corpus, trains a Wav2Letter-20 run at full width as phase 7 does
(``chip_smoke.phase_train_main``), exports it as f32 with CMVN and as int8
with CMVN and static activation scales (the serving phase's artifacts),
then runs ``chip_smoke.phase_data_parallel``: Wav2Letter-20 and
QuartzNet-15x5 under ``torch.distributed.run --nproc-per-node 1`` (NCCL,
world 1) against ungrouped runs, two ranks on the card over gloo against
one process, MeshInference and long form over ``make_mesh()`` and over
a mesh of two entries of the one card, ``transcribe_long --mesh`` and
``serve_tcp --mesh`` over ``make_mesh()`` and a ``StreamingServer`` over
the pair; every gate and time of the full run's phase 22, and each
kernel's launches on those paths.
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
        print('mesh_check: no CUDA device', file=sys.stderr)
        return 1
    t0 = time.time()
    cs.port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    print(card)
    cs.phase_build()
    with tempfile.TemporaryDirectory() as root:
        manifest, _ = cs.write_corpus(root)
        _, run = cs.phase_train_main(manifest, root)
        torch.cuda.empty_cache()
        arts = {}
        for name, extra in (('f32', []), ('int8', ['--int8', '--calibrate'])):
            arts[name] = os.path.join(root, f'artifact_{name}')
            cs.run_quiet(cs.port_export.main, [
                '--model-path', run, '--out', arts[name], '--cmvn-manifest',
                manifest, '--device', str(cs.DEVICE), *extra],
                what=f'export_serving --{name}')
        launches = cs.phase_data_parallel(manifest, arts, root, card)
    print(json.dumps({'mesh_launches': launches}))
    print(f'total {time.time() - t0:.1f} s [{card}]')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
