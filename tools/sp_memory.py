#!/usr/bin/env python3
"""Where a train step's device memory peaks, for one process and for a
sequence-parallel rank: Wav2Letter-20 and QuartzNet-15x2 at full width
(phase 24's models, ``chip_smoke.full_width_cases``), B=8 of 129 120
samples (the corpus's 808 frames), cuDNN's default algorithms. For each,
the peak above what was allocated before the model was built, in each
part of the second train step: up to the model's forward (the frontend),
the forward, the loss and backward, and the update (the gradients'
all-reduce and the optimizer), and what stays allocated after it.

    python3 tools/sp_memory.py       # a checkout's root, one GPU

The seq=2 ranks are two processes sharing the card over gloo, as in
``chip_smoke.py`` phase 24.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from wav2letter_pytorch_tpu_torch import parallel  # noqa: E402
from wav2letter_pytorch_tpu_torch.decoding.decoder import \
    GreedyDecoder  # noqa: E402
from wav2letter_pytorch_tpu_torch.training import \
    trainer as trainer_mod  # noqa: E402
from wav2letter_pytorch_tpu_torch.training.build import (  # noqa: E402
    build_frontend, build_labels, build_model, build_optimizer)

B, SAMPLES = 8, 129120


def parts(case: str, seq: int) -> dict:
    """Each part's peak (GB above the allocation before the model) in the
    second of two train steps, this process a rank of ``seq``."""
    dev = cs.DEVICE
    if seq > 1:
        dev = parallel.init_distributed(str(cs.DEVICE), 'gloo', seq=seq)
    cs.port_eval.resolve_device(dev)
    _, _, over, _ = cs.full_width_cases('unused')[case]
    grid = ['trainer.mesh.data=1', f'trainer.mesh.seq={seq}']
    cfg = cs.train_config(*over, *(grid if seq > 1 else []))
    labels = build_labels(cfg['model'])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg['model'], len(labels), seed=0).to(dev)
    opt, sched = build_optimizer(model.parameters(), cfg['model'], 10, 10)
    trainer = trainer_mod.Trainer(
        cfg, model, build_frontend(cfg['model'], device=dev), opt, sched,
        GreedyDecoder(labels), device=dev,
        run_dir=os.path.join('build', 'sp_memory'))
    gen = torch.Generator().manual_seed(0)
    batch = {'audio': 0.1 * torch.randn(B, SAMPLES, generator=gen),
             'audio_lengths': torch.full((B,), SAMPLES, dtype=torch.int32),
             'targets': torch.randint(1, 29, (B, 100), generator=gen,
                                      dtype=torch.int32),
             'target_lengths': torch.full((B,), 100, dtype=torch.int32),
             'batch_mask': torch.ones(B)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    peaks = {}

    def mark(name):
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
        torch.cuda.reset_peak_memory_stats()
    forward, update = trainer_mod.seq_forward, trainer_mod.Trainer._update

    def marked_forward(*args, **kw):
        mark('frontend')
        out = forward(*args, **kw)
        mark('forward')
        return out

    def marked_update(self):
        mark('loss and backward')
        update(self)
        mark('update')
    trainer_mod.seq_forward = marked_forward
    trainer_mod.Trainer._update = marked_update
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(batch)
    peaks['after'] = (torch.cuda.memory_allocated() - base) / 1e9
    return peaks


def main() -> int:
    if len(sys.argv) == 3:     # one process of a measurement
        peaks = parts(sys.argv[1], int(sys.argv[2]))
        print(json.dumps({'case': sys.argv[1], 'seq': int(sys.argv[2]),
                          'rank': parallel.rank(), 'GB': peaks}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print('sp_memory: no CUDA device', file=sys.stderr)
        return 1
    card = cs.card_line()
    for case in ('a', 'b'):
        for seq in (1, 2):
            port = str(cs.free_port())
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, str(seq)],
                stdout=subprocess.PIPE, text=True, env=dict(
                    os.environ, RANK=str(r), LOCAL_RANK='0',
                    WORLD_SIZE=str(seq), MASTER_ADDR='127.0.0.1',
                    MASTER_PORT=port)) for r in range(seq)]
            for p in procs:
                out, _ = p.communicate(timeout=600)
                if p.returncode:
                    return p.returncode
                print(f'{out.strip()} [{card}]', flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
