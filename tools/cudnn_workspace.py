#!/usr/bin/env python3
"""Peak device memory of a forward and backward of the full-width
Wav2Letter-20 and QuartzNet-15x2 (phase 23's and 24's models, B=8) at the
whole corpus length (808 frames) and at a sequence-parallel rank's halves
(404, 404 plus a C1 halo, 202), with cuDNN's deterministic algorithms and
with its default ones: the deterministic ones take workspaces of several
GB at some of the halved lengths.

    python3 tools/cudnn_workspace.py     # a checkout's root, one GPU
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from wav2letter_pytorch_tpu_torch.training.build import (  # noqa: E402
    build_labels, build_model)

LENGTHS = (808, 404, 437, 202)


def main() -> int:
    if not torch.cuda.is_available():
        print('cudnn_workspace: no CUDA device', file=sys.stderr)
        return 1
    cs.port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    head8 = os.path.join('build', 'unused.jsonl')
    for k, (what, _, over, _) in cs.full_width_cases(head8).items():
        cfg = cs.train_config(*over)['model']
        model = build_model(cfg, len(build_labels(cfg)), seed=0)
        model = model.to(cs.DEVICE).train()
        for det in (True, False):
            torch.backends.cudnn.deterministic = det
            for T in LENGTHS:
                feats = torch.randn(8, T, 64, device=cs.DEVICE)
                lens = torch.full((8,), T, device=cs.DEVICE)
                for _ in range(2):   # the second call's numbers
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    out, _ = model(feats, lens)
                    out.sum().backward()
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t0)
                    peak = torch.cuda.max_memory_allocated() - base
                    model.zero_grad(set_to_none=True)
                print(f'{what} B=8 T={T} cudnn.deterministic={det}: peak '
                      f'above the weights {peak / 1e9:.3f} GB, forward + '
                      f'backward {ms:.1f} ms [{card}]', flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
