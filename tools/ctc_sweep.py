#!/usr/bin/env python3
"""K2 and K3 on the card: warps a row swept, and another tree's CTC kernels
timed beside this one's.

    python3 tools/ctc_sweep.py [--parent DIR] [--rounds 3]

At the main path's lattice (B=32, T=404, L=29, S=144, lengths as
``chip_smoke.phase_k2`` draws them) and ``chip_smoke.CTC_LONG`` (B=32,
T=1000, L=29, S=320):

- for the table's warps a row and each power of two up to 32 that
  ``plan_warps`` takes, K2 storing
  alphas and K3 are timed by CUDA events (calls queued behind a spin, as
  ``chip_smoke.cuda_ms``), and their outputs are held against the table's
  plan: every position runs the same arithmetic at any warps, so the bits
  must be equal;
- with ``--parent DIR`` (the root of an unpacked tree whose
  ``csrc/ctc_alpha.cu`` and ``ctc_beta.cu`` launch with the signatures of
  the one-block-per-row kernels: no warps argument, no scratch buffers),
  those sources are built with the same nvcc flags into
  ``build/parent_kernels/`` and timed in turns with this tree's (parent,
  this, this, parent), and their outputs compared with this tree's.

Prints the card's name and power limit, and everything as one JSON
object on its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from wav2letter_pytorch_tpu_torch import _build  # noqa: E402
from wav2letter_pytorch_tpu_torch import evaluate as port_eval  # noqa: E402
from wav2letter_pytorch_tpu_torch.ops import ctc_kernel  # noqa: E402

MAIN = (32, 404, 29, 144)
WARPS = (1, 2, 4, 8, 16, 32)
P = ctypes.c_void_p
I = ctypes.c_int


def shapes():
    B, T, L, S = MAIN
    return {'main': cs.k2_inputs(B, T, L, S, 7, cs.DEVICE, tl_lo=S // 2,
                                 ll_lo=395),
            'long': cs.ctc_long_inputs(cs.DEVICE)}


def build_parent(parent: str) -> dict:
    out_dir = os.path.join(ROOT, 'build', 'parent_kernels')
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name in ('ctc_alpha', 'ctc_beta'):
        so = os.path.join(out_dir, f'{name}.so')
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, '-o', so,
                        os.path.join(parent, 'wav2letter_pytorch_tpu_torch',
                                     'csrc', f'{name}.cu')],
                       check=True, capture_output=True, text=True)
        libs[name] = ctypes.CDLL(so)
    libs['ctc_alpha'].ctc_alpha_launch.argtypes = [P, I, I, I, P, P, I, P, I,
                                                   P, P, P]
    libs['ctc_beta'].ctc_beta_launch.argtypes = [P, I, I, I, P, P, P, P, P,
                                                 I, P, I, P, P]
    return libs


def parent_calls(libs, args):
    """K2 (storing alphas) and K3 of the parent's libraries on ``args``."""
    lp, ll, tg, tl = args
    B, T, L = lp.shape
    S = tg.shape[1]
    nll = torch.empty(B, device=lp.device)
    alphas = torch.empty(B, T, 2 * S + 1, device=lp.device)
    grad = torch.empty(B, T, L, device=lp.device)
    stream = torch.cuda.current_stream().cuda_stream

    def k2():
        code = libs['ctc_alpha'].ctc_alpha_launch(
            lp.data_ptr(), B, T, L, ll.data_ptr(), tg.data_ptr(), S,
            tl.data_ptr(), 0, nll.data_ptr(), alphas.data_ptr(), stream)
        assert code == 0, code
        return nll, alphas

    def k3(g):
        code = libs['ctc_beta'].ctc_beta_launch(
            lp.data_ptr(), B, T, L, alphas.data_ptr(), nll.data_ptr(),
            g.data_ptr(), ll.data_ptr(), tg.data_ptr(), S, tl.data_ptr(), 0,
            grad.data_ptr(), stream)
        assert code == 0, code
        return grad
    return k2, k3


def upstream(args):
    lp, _, _, tl = args
    return (1.0 / (lp.shape[0] * torch.clamp(tl, min=1).float())).contiguous()


def sweep(args, rounds: int) -> dict:
    lp, ll, tg, tl = args
    S = tg.shape[1]
    g = upstream(args)
    # (the wrappers' first calls set the libraries' ctypes signatures)
    nll_t, al_t = ctc_kernel._launch_alpha(lp, ll, tg, tl, 0, True)
    grad_t = ctc_kernel._launch_beta(lp, al_t, nll_t, ll, tg, tl, g, 0)
    lib_a, lib_b = _build.load('ctc_alpha'), _build.load('ctc_beta')
    out = {'table_warps': lib_a.ctc_alpha_warps(S, 0), 'k2': {}, 'k3': {},
           'same_bits': {}}
    for w in sorted(set(WARPS) | {out['table_warps']}):
        if lib_a.ctc_alpha_warps(S, w) != w or lib_b.ctc_beta_warps(S, w) != w:
            continue
        nll, al = ctc_kernel._launch_alpha(lp, ll, tg, tl, 0, True, w)
        grad = ctc_kernel._launch_beta(lp, al_t, nll_t, ll, tg, tl, g, 0, w)
        out['same_bits'][w] = bool(torch.equal(nll, nll_t)
                                   and torch.equal(grad, grad_t))
        out['k2'][w] = [cs.cuda_ms(lambda: ctc_kernel._launch_alpha(
            lp, ll, tg, tl, 0, True, w)) for _ in range(rounds)]
        out['k3'][w] = [cs.cuda_ms(lambda: ctc_kernel._launch_beta(
            lp, al_t, nll_t, ll, tg, tl, g, 0, w)) for _ in range(rounds)]
        print(f'  warps {w}: K2 ' + ' '.join(f'{v:.4f}' for v in out['k2'][w])
              + ' ms, K3 ' + ' '.join(f'{v:.4f}' for v in out['k3'][w])
              + f' ms; same bits as the table: {out["same_bits"][w]}',
              flush=True)
    return out


def against_parent(libs, args) -> dict:
    lp, ll, tg, tl = args
    g = upstream(args)
    k2_p, k3_p = parent_calls(libs, args)
    nll_p, al_p = k2_p()
    grad_p = k3_p(g).clone()
    nll_p = nll_p.clone()
    nll, al = ctc_kernel.ctc_alpha(*args, store_alphas=True)
    grad = ctc_kernel.ctc_beta(lp, al, nll, ll, tg, tl, g)
    calls = {
        'k2': (k2_p, lambda: ctc_kernel.ctc_alpha(*args, store_alphas=True)),
        'k2_eval': (None, lambda: ctc_kernel.ctc_alpha(*args)),
        'k3': (lambda: k3_p(g),
               lambda: ctc_kernel.ctc_beta(lp, al, nll, ll, tg, tl, g)),
    }
    out = {'nll_max_abs_diff': (nll - nll_p).abs().max().item(),
           'grad_max_abs_diff': (grad - grad_p).abs().max().item(),
           'grad_max_abs': grad_p.abs().max().item()}
    for name, (parent, this) in calls.items():
        if parent is None:
            out[name] = {'this': [cs.cuda_ms(this), cs.cuda_ms(this)]}
        else:
            p0, t0, t1, p1 = (cs.cuda_ms(parent), cs.cuda_ms(this),
                              cs.cuda_ms(this), cs.cuda_ms(parent))
            out[name] = {'parent': [p0, p1], 'this': [t0, t1]}
        print(f'  {name}: {out[name]}', flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', help='root of an unpacked earlier tree')
    ap.add_argument('--rounds', type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print('ctc_sweep: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    port_eval.resolve_device(cs.DEVICE)
    card = cs.card_line()
    print(card, flush=True)
    _build.build(['ctc_alpha', 'ctc_beta'])
    libs = build_parent(a.parent) if a.parent else None
    result = {'card': card, 'shapes': {}}
    for name, args in shapes().items():
        B, T, L = args[0].shape
        S = args[2].shape[1]
        steps = int(torch.clamp(args[1].long(), 1, T).max())
        print(f'{name}: B={B}, T={T}, L={L}, S={S}, {steps} steps',
              flush=True)
        entry = {'shape': [B, T, L, S], 'steps': steps,
                 'sweep': sweep(args, a.rounds)}
        if libs:
            entry['parent'] = against_parent(libs, args)
        result['shapes'][name] = entry
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
