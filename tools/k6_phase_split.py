#!/usr/bin/env python3
"""Where K6's time goes, on the card: its phases switched off one at a time.

    python3 tools/k6_phase_split.py      # from the root of a checkout, one GPU

Builds ``csrc/sep_conv.cu`` four more times with nvcc, each copy with one
part of K6 removed (the depthwise step; the copies of wpw; every copy into
shared memory; both the copies and the depthwise, leaving the product and
the barriers), and times each against the unchanged kernel at QuartzNet's
unit shapes (B=32, T_out=404, ``chip_smoke.SEP_PATH_UNITS``), with
``chip_smoke.cuda_ms``. A variant's output is wrong by construction; only
the unchanged kernel is checked against the plain version. The difference
between two variants' times is what the removed part adds to the kernel,
as far as it does not overlap the rest.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from wav2letter_pytorch_tpu_torch import _build  # noqa: E402
from wav2letter_pytorch_tpu_torch.ops.sep_conv import \
    sep_fwd_reference  # noqa: E402

OUT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), 'k6_phase_split')
# (anchor in sep_conv.cu, text put before it): each guard returns early or
# skips a call when its macro is defined.
GUARDS = {
    'SKIP_DW': ('    fwd_depthwise<TN, XT>(st, dw_s',
                '#ifndef SKIP_DW\n', ';\n', '#endif\n'),
    'SKIP_WPW': ('  constexpr int PER_W = TN / STRIDE;',
                 '#ifdef SKIP_WPW\n  if (c0 >= 0) return;\n#endif\n', None,
                 None),
    'SKIP_LOAD': ('    unsigned char* st = smem_raw + (chunk % F_STAGES) '
                  '* stage;',
                  '#ifdef SKIP_LOAD\n    if (chunk >= 0) return;\n#endif\n',
                  None, None),
}
VARIANTS = {'kernel': [], 'no depthwise': ['SKIP_DW'],
            'no wpw copies': ['SKIP_WPW'], 'no copies': ['SKIP_LOAD'],
            'product only': ['SKIP_LOAD', 'SKIP_DW']}


def guarded_source() -> str:
    """sep_conv.cu with every guard inserted; raises if an anchor moved."""
    with open(os.path.join(_build.CSRC_DIR, 'sep_conv.cu')) as f:
        src = f.read()
    for name, (anchor, before, end, after) in GUARDS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f'{name}: anchor not found once in '
                               f'sep_conv.cu: {anchor!r}')
        i = src.index(anchor)
        if end is None:
            src = src[:i] + before + src[i:]
        else:  # wrap the statement from the anchor to its end
            j = src.index(end, i) + len(end)
            src = src[:i] + before + src[i:j] + after + src[j:]
    return src


def build() -> dict:
    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, 'sep_conv_guarded.cu')
    with open(src, 'w') as f:
        f.write(guarded_source())
    nvcc = _build.find_nvcc()
    procs = {}
    for i, (name, macros) in enumerate(VARIANTS.items()):
        out = os.path.join(OUT_DIR, f'variant{i}.so')
        cmd = [nvcc, *_build.NVCC_FLAGS, *[f'-D{m}' for m in macros], '-I',
               _build.CSRC_DIR, '-o', out, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        lib = ctypes.CDLL(out)
        lib.sep_fwd_launch.restype = ctypes.c_int
        lib.sep_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def launch(lib, x, l1, l2, wdw, wpw, d, p):
    B, T, C = x.shape
    K, cout = wdw.shape[0], wpw.shape[1]
    t_out = cs.sep_out_length(T, K, d, p)
    y = torch.empty(B, t_out, cout, device=x.device)
    code = lib.sep_fwd_launch(
        x.data_ptr(), l1.data_ptr(), l2.data_ptr(), wdw.data_ptr(),
        wpw.data_ptr(), y.data_ptr(), B, T, C, cout, K, d, p, t_out,
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f'K6 variant launch failed: CUDA error {code}')
    return y


def main() -> int:
    if not torch.cuda.is_available():
        print('k6_phase_split: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    cs.port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    libs = build()
    totals = dict.fromkeys(libs, 0.0)
    for i, ((cin, cout, K, d), count) in enumerate(
            cs.SEP_PATH_UNITS.items()):
        (x, wdw, wpw, _), l1, l2, p = cs.sep_inputs(
            cs.BATCH, 404, cin, cout, K, d, 60 + i, cs.DEVICE)
        err = cs.rel_err(launch(libs['kernel'], x, l1, l2, wdw, wpw, d, p),
                         sep_fwd_reference(x, l1, l2, wdw, wpw, d, p))
        cs.check(err < cs.SEP_DW_RTOL, f'K6 at {(cin, cout, K, d)} vs plain '
                 f'{err:.2e} (gate {cs.SEP_DW_RTOL})')
        row = []
        for name, lib in libs.items():
            ms = cs.cuda_ms(lambda: launch(lib, x, l1, l2, wdw, wpw, d, p),
                            iters=10)
            totals[name] += count * ms
            row.append(f'{name} {ms:.4f}')
        print(f'(Cin, Cout, K, d)={(cin, cout, K, d)} x{count}: '
              + ', '.join(row) + ' ms', flush=True)
    print(f'per forward ({sum(cs.SEP_PATH_UNITS.values())} launches): '
          + ', '.join(f'{n} {v:.3f}' for n, v in totals.items())
          + f' ms [{card}]')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
