#!/usr/bin/env python3
"""Phase 25 of ``chip_smoke.py`` (``model.compute_dtype=bf16``) alone, on
the card: a few minutes instead of a full run.

    python3 tools/bf16_check.py      # a checkout's root, one GPU

Builds the kernels (``chip_smoke.phase_build``), writes the 64-utterance
corpus, then runs ``chip_smoke.phase_bf16``: K4-K7 on bf16 x against
their plain versions and the float64 oracle at phases 4-5's and phase
24's shapes; Wav2Letter-20 and QuartzNet-15x5 at full width in bf16
through ``train.main`` and ``evaluate.main``, 6 steps on a repeated B=32
batch with K4-K7's bf16 launches pinned, train and eval step ms, peak
memory and conv TFLOP/s beside float32's, bf16 against float32 log-probs,
and the card's bf16 steps against the CPU's. Then a profiler breakdown
of three bf16 train steps of each model (the config's optimizer, on the
corpus's first B=32 batch), and each bf16 kernel's ms, plain ms, cuDNN's
ms and bound at QuartzNet's shapes (as the full run's ``{"kernels"}`` line
has them).
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
        print('bf16_check: no CUDA device', file=sys.stderr)
        return 1
    t0 = time.time()
    cs.port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    print(card)
    cs.phase_build()
    with tempfile.TemporaryDirectory() as root:
        manifest, _ = cs.write_corpus(root)
        launches, errs = cs.phase_bf16(manifest, root, card)
        for overrides, what in (([], 'Wav2Letter-20'),
                                (cs.QN + ['optimizer=novograd'],
                                 'QuartzNet-15x5')):
            batch = cs.bf16_corpus_batch(manifest, overrides)
            tr = cs.make_trainer(
                cs.train_config(*overrides, 'model.compute_dtype=bf16'),
                os.path.join(root, f'profile_{what}'), cs.DEVICE)
            tr.train_step(batch)   # warm-up (cuDNN plans, allocator)
            cs.profile_top(lambda: [tr.train_step(batch) for _ in range(3)],
                           f'{what} bf16, 3 train steps, B={cs.BATCH}')
            del tr
            torch.cuda.empty_cache()
    print(json.dumps({'bf16_launches': launches, 'max_abs_err': errs}))
    numbers = {'depthwise_fwd': cs.k4_numbers(cs.BF16),
               'depthwise_wgrad': cs.k5_numbers(cs.BF16)}
    numbers['sep_fwd'], numbers['sep_bwd'] = cs.k6_k7_numbers(cs.BF16)
    rows = [cs.kernel_entry(name + '_bf16', '', '', 0, errs[name], n)
            for name, n in numbers.items()]
    print(json.dumps({'bf16_kernels': [
        {k: r[k] for k in ('name', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                           'library_ms', 'max_abs_err')} for r in rows]}))
    print(f'total {time.time() - t0:.1f} s [{card}]')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
