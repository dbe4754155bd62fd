#!/usr/bin/env python3
"""The float32 plain versions' own error against float64, on the CPU.

    python3 tools/plain_oracle_errors.py

For K4/K5 (depthwise) and K6/K7 (fused separable unit) on the grids that
``chip_smoke.py`` checks the kernels on, with the same seeded inputs:
max |float32 - float64| / max |float64| of every output (y, dx, dw; y, dx,
dwdw, dwpw). ``chip_smoke.py`` sets its float64-oracle gates for the
kernels from the largest of these (``DW_PLAIN_ORACLE``,
``SEP_PLAIN_ORACLE``).
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    cpu = torch.device('cpu')
    worst = {'dw': 0.0, 'sep': 0.0}
    for i, shape in enumerate(cs.DW_GRID + [cs.DW_MAIN]):
        B, T, C, K, s, d = shape
        (x, w, g), p = cs.dw_inputs(*shape, 20 + i, cpu)
        f32 = cs.dw_plain(x, w, g, s, d, p)
        f64 = cs.dw_plain(x.double(), w.double(), g.double(), s, d, p)
        r = [cs.rel_err(a, b) for a, b in zip(f32, f64)]
        worst['dw'] = max(worst['dw'], *r)
        print(f'K4/K5 plain {shape}: y, dx, dw '
              + ' '.join(f'{v:.3e}' for v in r), flush=True)
    cases = ([(sh, m) for sh in cs.SEP_GRID for m in (True, False)]
             + [(sh, True) for sh in cs.SEP_MAIN])
    for i, (shape, masked) in enumerate(cases):
        B, T, Cin, Cout, K, d = shape
        (x, wdw, wpw, g), l1, l2, p = cs.sep_inputs(*shape, 40 + i, cpu,
                                                    masked)
        f32 = cs.sep_plain(x, l1, l2, wdw, wpw, g, d, p)
        f64 = cs.sep_plain(x.double(), l1, l2, wdw.double(), wpw.double(),
                           g.double(), d, p)
        r = [cs.rel_err(a, b) for a, b in zip(f32, f64)]
        worst['sep'] = max(worst['sep'], *r)
        print(f'K6/K7 plain {shape} masks {"on" if masked else "off"}: y, '
              'dx, dwdw, dwpw ' + ' '.join(f'{v:.3e}' for v in r),
              flush=True)
    print(f'largest: K4/K5 {worst["dw"]:.3e}, K6/K7 {worst["sep"]:.3e}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
