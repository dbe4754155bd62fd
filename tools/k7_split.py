#!/usr/bin/env python3
"""Where K7's time goes, on the card: each of its kernels at QuartzNet's
unit shapes.

    python3 tools/k7_split.py          # from the root of a checkout, one GPU
    python3 tools/k7_split.py --sweep  # also sweep K7's block targets

Builds the kernels (``chip_smoke.phase_build``, which prints each kernel's
registers and spills) and runs ``chip_smoke.phase_k6_k7``, which holds K6
and K7 against their plain versions and float64 at every grid, main-path
and edge shape and checks that two K7 calls give the same bits. Then
``chip_smoke.k7_split_per_backward`` prints, for each of
``chip_smoke.SEP_PATH_UNITS`` (B=32, T_out=404, ragged lengths), K7's
whole time and the device time of each of its kernels by part (the
g @ wpw^T product (i), the depthwise pass (ii), the dwpw product (iii) and
the sums of partials) with ms, TFLOP/s and bound, and the totals per
QuartzNet backward (76 calls); a full ``chip_smoke.py`` run prints the
same. ``--sweep`` then times K7 a backward at each pair of
``ops/sep_conv.py``'s ``DW_TARGET_BLOCKS`` and ``PW_TARGET_BLOCKS`` in
``--rounds`` rounds, each pair's result held against the committed plan's.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from wav2letter_pytorch_tpu_torch.ops import sep_conv  # noqa: E402

DW_TARGETS = (256, 512, 1024, 2048)
PW_TARGETS = (132, 264, 396, 528)


def sweep(rounds: int) -> None:
    """K7 a backward at each (DW_TARGET_BLOCKS, PW_TARGET_BLOCKS), pairs in
    the same order each round, results within SEP_DW_RTOL of the committed
    plan's at QuartzNet's C2 unit."""
    committed = (sep_conv.DW_TARGET_BLOCKS, sep_conv.PW_TARGET_BLOCKS)
    cin, cout, K, d = next(u for u in cs.SEP_PATH_UNITS if u[3] == 2)
    (x, wdw, wpw, g), l1, l2, p = cs.sep_inputs(cs.BATCH, 404, cin, cout, K,
                                                d, 7, cs.DEVICE)
    want = cs.sep_bwd(x, l1, l2, wdw, wpw, g, d, p)
    try:
        for r in range(rounds):
            for dw in DW_TARGETS:
                for pw in PW_TARGETS:
                    sep_conv.DW_TARGET_BLOCKS, sep_conv.PW_TARGET_BLOCKS = (
                        dw, pw)
                    got = cs.sep_bwd(x, l1, l2, wdw, wpw, g, d, p)
                    err = max(cs.rel_err(a, b) for a, b in zip(got, want))
                    cs.check(err < cs.SEP_DW_RTOL,
                             f'sweep ({dw}, {pw}) vs the committed plan '
                             f'{err:.2e}')
                    total = cs.k7_split_per_backward(split=False)
                    print(f'sweep round {r} DW_TARGET_BLOCKS={dw} '
                          f'PW_TARGET_BLOCKS={pw}: K7 {total:.3f} ms a '
                          'backward', flush=True)
    finally:
        sep_conv.DW_TARGET_BLOCKS, sep_conv.PW_TARGET_BLOCKS = committed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--sweep', action='store_true')
    parser.add_argument('--rounds', type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('k7_split: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    cs.port_eval.resolve_device(cs.DEVICE)
    print(cs.card_line(), flush=True)
    cs.phase_build()
    cs.phase_k6_k7()
    cs.k7_split_per_backward()
    if args.sweep:
        sweep(args.rounds)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
