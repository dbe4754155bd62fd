#!/usr/bin/env python3
"""K4 and K5 on the card: their plans swept, and another tree's depthwise
kernels timed beside this one's.

    python3 tools/dw_sweep.py [--parent DIR] [--rounds 2]

At ``chip_smoke.DW_MAIN`` (QuartzNet's C1) and every ``chip_smoke.DW_GRID``
shape:

- K4 (the forward, and the stride-1 call of the input gradient that
  ``ops/depthwise.py::dgrad_args`` forms) for each R in ``FWD_RS`` and each
  tile of about 64, 128 and 256 frames, and K5 for each R it is built for
  and each chunk of about 32, 64, 128 and 256 frames, are timed by CUDA
  events with the calls queued behind a spin (``chip_smoke.cuda_ms``);
  each setting's output is held against the plain version under
  ``chip_smoke.SEP_DW_RTOL``, and a setting over the shared memory limit
  is listed as such. The library fixes K4's R when it is built
  (``DW_FWD_R``), so the sweep builds ``csrc/depthwise.cu`` once for each R
  into ``build/dw_sweep/``; the plans' other inputs are
  ``ops/depthwise.py``'s constants, which the sweep sets for each setting;
- with ``--parent DIR`` (the root of an unpacked earlier tree whose
  ``csrc/depthwise.cu`` launches without a plan, K5 through a [B, K, C]
  scratch), that source is built with the same nvcc flags into
  ``build/parent_kernels/`` and timed in turns with this tree's default
  plans (parent, this, this, parent), alone and each call right after a
  cuDNN depthwise conv of the same x (a kernel launched without
  programmatic dependent launch, as on the model's path), and its outputs
  compared with this tree's.

Prints the card's name and power limit, and everything as one JSON object
on its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from wav2letter_pytorch_tpu_torch import _build  # noqa: E402
from wav2letter_pytorch_tpu_torch import evaluate as port_eval  # noqa: E402
from wav2letter_pytorch_tpu_torch.ops import depthwise as dw  # noqa: E402

FWD_RS = (4, 8, 16)       # K4 outputs a thread, one build each
TILES = (64, 128, 256)    # K4 frames a block aims for
CHUNKS = (32, 64, 128, 256)  # K5 frames a block aims for
P = ctypes.c_void_p
I = ctypes.c_int


def build_libs(parent: str | None) -> tuple[dict, ctypes.CDLL | None]:
    """This tree's depthwise.cu at each R of FWD_RS, and the parent's, all
    nvcc processes started together."""
    src = os.path.join(ROOT, 'wav2letter_pytorch_tpu_torch', 'csrc',
                       'depthwise.cu')
    jobs = {r: (src, os.path.join(ROOT, 'build', 'dw_sweep',
                                  f'depthwise_r{r}.so'), [f'-DDW_FWD_R={r}'])
            for r in FWD_RS}
    if parent:
        jobs['parent'] = (os.path.join(parent, 'wav2letter_pytorch_tpu_torch',
                                       'csrc', 'depthwise.cu'),
                          os.path.join(ROOT, 'build', 'parent_kernels',
                                       'depthwise.so'), [])
    procs = {}
    for key, (src_, so, extra) in jobs.items():
        os.makedirs(os.path.dirname(so), exist_ok=True)
        procs[key] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *extra, '-o', so, src_],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {jobs[key][0]} ({key}):\n'
                               f'{out}')
        libs[key] = ctypes.CDLL(jobs[key][1])
    for r in FWD_RS:
        libs[r].dw_fwd_launch.argtypes = [P] * 3 + [I] * 12 + [
            ctypes.c_longlong, P]
    parent_lib = libs.pop('parent', None)
    if parent_lib:
        parent_lib.dw_fwd_launch.argtypes = [P] * 3 + [I] * 8 + [P]
        parent_lib.dw_wgrad_launch.argtypes = [P] * 4 + [I] * 8 + [P]
    return libs, parent_lib


def variant_fwd(lib, x, w, s, d, p, plan):
    """K4 of a library built at plan.r, with ``plan``."""
    B, T, C = x.shape
    K = w.shape[0]
    t_out = dw.out_length(T, K, s, d, p)
    y = torch.empty(B, t_out, C, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    vec = dw._vec(C, x, w)

    def call():
        code = lib.dw_fwd_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), B,
                                 T, C, K, s, d, p, t_out, plan.tile,
                                 plan.rows, plan.warps, vec, plan.smem,
                                 stream)
        assert code == 0, code
        return y
    return call


def parent_fwd(lib, x, w, s, d, p):
    B, T, C = x.shape
    K = w.shape[0]
    t_out = dw.out_length(T, K, s, d, p)
    y = torch.empty(B, t_out, C, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        code = lib.dw_fwd_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), B,
                                 T, C, K, s, d, p, t_out, stream)
        assert code == 0, code
        return y
    return call


def parent_wgrad(lib, x, g, K, s, d, p):
    B, T, C = x.shape
    part = torch.empty(B, K, C, device=x.device)
    out = torch.empty(K, C, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        code = lib.dw_wgrad_launch(x.data_ptr(), g.data_ptr(),
                                   part.data_ptr(), out.data_ptr(), B, T, C,
                                   K, s, d, p, g.shape[1], stream)
        assert code == 0, code
        return out
    return call


def timed(fn, ref, rounds):
    """{'ms': [...], 'rel_err': ...} of ``fn`` against ``ref``."""
    err = cs.rel_err(fn(), ref)
    ok = err < cs.SEP_DW_RTOL
    cs.check(ok, f'    rel err {err:.2e} (gate {cs.SEP_DW_RTOL})')
    return {'ms': [cs.cuda_ms(fn) for _ in range(rounds)], 'rel_err': err}


def sweep_fwd(libs, x, w, s, d, p, rounds) -> list:
    B, T, C = x.shape
    K = w.shape[0]
    t_out = dw.out_length(T, K, s, d, p)
    ref = dw.depthwise_fwd_reference(x, w, s, d, p)
    out, seen = [], set()
    for r in FWD_RS:
        for tile in TILES:
            with mock.patch.multiple(dw, FWD_R=r, FWD_TILE=tile):
                plan = dw.fwd_plan(t_out, K, s, d)
            if plan in seen:
                continue
            seen.add(plan)
            row = {'r': r, 'tile': plan.tile, 'warps': plan.warps,
                   'smem': plan.smem}
            if plan.smem > _build.SMEM_LIMIT_BYTES:
                row['over_smem'] = True
            else:
                row.update(timed(variant_fwd(libs[r], x, w, s, d, p, plan),
                                 ref, rounds))
            out.append(row)
            print(f'  K4 {row}', flush=True)
    return out


def sweep_wgrad(x, g, K, s, d, p, rounds) -> list:
    B, T, C = x.shape
    t_out = g.shape[1]
    ref = dw.depthwise_wgrad_reference(x, g, K, s, d, p)
    out, seen = [], set()
    for r in dw.WGRAD_R_CHOICES:
        for chunk in CHUNKS:
            consts = {'WGRAD_R_CHOICES': (r,), 'WGRAD_CHUNK': chunk}
            with mock.patch.multiple(dw, **consts):
                plan = dw.wgrad_plan(B, t_out, K, s, d)
                if plan in seen:
                    continue
                seen.add(plan)
                row = {'r': r, 'chunk': plan.chunk, 'slices': plan.slices,
                       'warps': plan.warps, 'partials': plan.partials,
                       'smem': plan.smem}
                if plan.smem > _build.SMEM_LIMIT_BYTES:
                    row['over_smem'] = True
                else:
                    row.update(timed(lambda: dw.depthwise_wgrad(
                        x, g, K, s, d, p), ref, rounds))
            out.append(row)
            print(f'  K5 {row}', flush=True)
    return out


def in_turns(parent, this) -> dict:
    p0, t0, t1, p1 = (cs.cuda_ms(parent), cs.cuda_ms(this),
                      cs.cuda_ms(this), cs.cuda_ms(parent))
    return {'parent': [p0, p1], 'this': [t0, t1]}


def against_parent(lib, x, w, g, s, d, p) -> dict:
    K = w.shape[0]
    g_in, w_flip, pad_t = dw.dgrad_args(g, w, x.shape[1], s, d, p)
    calls = {
        'k4': (parent_fwd(lib, x, w, s, d, p),
               lambda: dw.depthwise_fwd(x, w, s, d, p)),
        'k4_dgrad': (parent_fwd(lib, g_in, w_flip, 1, d, pad_t),
                     lambda: dw.depthwise_fwd(g_in, w_flip, 1, d, pad_t)),
        'k5': (parent_wgrad(lib, x, g, K, s, d, p),
               lambda: dw.depthwise_wgrad(x, g, K, s, d, p)),
    }
    xt, wt = x.transpose(1, 2), w.t().unsqueeze(1).contiguous()

    def conv():
        return torch.nn.functional.conv1d(xt, wt, stride=s, padding=p,
                                          dilation=d, groups=x.shape[2])
    out = {}
    for name, (parent, this) in calls.items():
        out[name] = {'rel_diff': cs.rel_err(this(), parent().clone()),
                     **in_turns(parent, this),
                     'after_conv': in_turns(lambda: (conv(), parent()),
                                            lambda: (conv(), this()))}
        print(f'  {name} vs parent: {out[name]}', flush=True)
    out['conv'] = [cs.cuda_ms(conv), cs.cuda_ms(conv)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', help='root of an unpacked earlier tree')
    ap.add_argument('--rounds', type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print('dw_sweep: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    print(card, flush=True)
    _build.build(['depthwise'])
    libs, lib = build_libs(a.parent)
    result = {'card': card, 'shapes': []}
    for i, shape in enumerate([cs.DW_MAIN] + cs.DW_GRID):
        B, T, C, K, s, d = shape
        (x, w, g), p = cs.dw_inputs(*shape, 50 + i, cs.DEVICE)
        g_in, w_flip, pad_t = dw.dgrad_args(g, w, T, s, d, p)
        print(f'{shape}, padding {p}', flush=True)
        entry = {'shape': list(shape), 'padding': p,
                 'k4': sweep_fwd(libs, x, w, s, d, p, a.rounds),
                 'k4_dgrad': sweep_fwd(libs, g_in, w_flip, 1, d, pad_t,
                                       a.rounds),
                 'k5': sweep_wgrad(x, g, K, s, d, p, a.rounds)}
        if lib:
            entry['parent'] = against_parent(lib, x, w, g, s, d, p)
        result['shapes'].append(entry)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
