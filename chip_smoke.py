#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (wav2letter_pytorch_tpu_torch).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which fails the run (non-zero exit) when a check fails:

1. Environment: torch/CUDA/nvcc versions, the card's name and power limit.
2. Build every kernel under ``wav2letter_pytorch_tpu_torch/csrc/`` with
   nvcc (one process per source, in parallel).
3. K1 (stft_mel_log) against its plain PyTorch version on the card, at
   16 kHz, 8 kHz and a 15 ms hop (B=4, 2 s, ragged lengths) and at the main
   path's shape (B=32, ~8 s); plus a float64 oracle.
4. K2 (ctc_alpha) against its plain version over (B, T, L, S) in
   {(8,120,31,40), (8,100,31,40), (16,800,31,70)} and the main path's
   shape; plus a float64 oracle and an impossible alignment; and K2 with
   stored alphas against the plain recursion's alphas on the same grid.
5. K3 (ctc_beta) through the autograd Function ``CTCLoss`` against its
   plain version on the same grid and the main path's shape: mean loss and
   d loss / d log_probs within 1e-4, and the gradient within 1e-5 of its
   own largest entry; against a float64 oracle (autograd through the
   float64 plain recursion); and a batch with an impossible alignment,
   whose row must get an exact-zero, finite gradient.
6. Eval path: 64 synthetic ~8 s utterances written as WAV files, evaluated
   by ``wav2letter_pytorch_tpu_torch.evaluate.main`` on cuda with the full
   20-layer Wav2Letter (seeded random weights) at B=32; K1 and K2 must
   have launched. The eval step on the card is also held against the same
   step on the CPU (plain versions) on a small input. Then per-batch time,
   utterances per second, peak memory and a profiler breakdown.
7. Training path: ``wav2letter_pytorch_tpu_torch.train.main`` on cuda over
   the same WAVs (train and val manifest), Wav2Letter-20 at full width,
   B=32, the default SGD + ExponentialLR, 4 steps over 2 epochs with
   validation and a checkpoint per epoch, then ``--resume`` for 2 more;
   K1, K2 and K3 must have launched, every logged train loss must be
   finite, and the resumed run must continue from step 4.
8. One full-width train step (B=2 x 1 s; dither, dropout, augment off) on
   the card against the same step on the CPU: loss, the update of every
   parameter and the new BatchNorm statistics.
9. It trains: full width, one repeated batch (B=8, ~2 s), AdamW; the loss
   must fall below 0.7x its first value within a stated number of steps.
10. Train-step time and utterances per second at B=32 of ~8 s, peak
   memory, and a profiler breakdown with the device-busy share.
11. One ``{"kernels": [...]}`` line: per kernel its launches on the
   training path, max error against the plain version, time, plain time,
   roofline bound and the time of the nearest single PyTorch call (timed
   here only).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from wav2letter_pytorch_tpu_torch import _build
from wav2letter_pytorch_tpu_torch import evaluate as port_eval
from wav2letter_pytorch_tpu_torch import train as port_train
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.ops.ctc import (ctc_beta_reference,
                                                  ctc_loss, reduce_ctc)
from wav2letter_pytorch_tpu_torch.ops.ctc_kernel import (ctc_alpha,
                                                         ctc_alpha_reference,
                                                         ctc_beta,
                                                         ctc_loss_kernel)
from wav2letter_pytorch_tpu_torch.optim import constant_lr
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_labels,
                                                         build_model,
                                                         build_optimizer)
from wav2letter_pytorch_tpu_torch.training.checkpoint import Checkpointer
from wav2letter_pytorch_tpu_torch.training.trainer import Trainer
from wav2letter_pytorch_tpu_torch.ops.stft_mel import (stft_mel_log,
                                                       stft_mel_log_reference)

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # FP32 outside the tensor cores
# Gates: the TPU kernel checks' tolerances (scripts/run_tpu_checks.py).
K1_TOL = 5e-3               # max abs on normalised features
K2_TOL = 1e-4               # |d loss| per sample, loss = nll / max(tl, 1)
K1_ORACLE_TOL = 1e-3        # raw log-mel vs float64 (f32 rounding only)
K2_ORACLE_RTOL = 1e-5       # nll vs float64, relative
# Stored alphas vs the plain recursion's, relative to max(1, |alpha|): the
# same float32 arithmetic, so only rounding differences.
K2_ALPHA_RTOL = 1e-5
# K3: run_tpu_checks.py's gate, |d mean loss| and max |d grad| (the kernel
# sums gamma with atomics, in an order that varies from run to run).
K3_TOL = 1e-4
# The same comparison without a scale: max |d grad| / max |grad|. Under the
# mean reduction the gradient is ~1e-4 at the main path, where K3_TOL alone
# would pass a kernel 20 % off; the atomics' order moves it by ~1e-7.
K3_RTOL = 1e-5
# Grad vs autograd through the float64 recursion, max |d grad| / max |grad|:
# the float32 recursion itself is 1.0e-3 off at the main path and 2.5e-3 at
# T=800 (H100; on the grid the plain version on the CPU reads the same).
K3_ORACLE_RTOL = 5e-3
# Card vs CPU train step (full width, B=2 x 1 s): float32 convolutions
# summed in another order through 20 layers and their backward.
STEP_LOSS_RTOL = 1e-3
STEP_UPDATE_RTOL = 1e-3     # relative global norm of the update difference
MAX_BRANCH_FLIPS = 32       # clamp branches taken differently (of ~1.2 M);
                            # 6 and 11 seen on the H100, ~3x the larger
STEP_BN_RTOL = 1e-3         # relative global norm of the BN stats difference
# It trains: AdamW at this lr on one repeated batch, dropout off, a fixed
# number of steps; the last loss must be below this share of the first.
OVERFIT_LR, OVERFIT_STEPS, OVERFIT_RATIO = 3e-4, 40, 0.7
# Main path: full-width Wav2Letter-20, B=32, ~8 s utterances. Lengths in
# (127840, 129120] samples share the loader's bucket edge 129120 (808
# frames), so every batch has the main path's shape.
N_UTTS, BATCH, LEN_LO, LEN_HI = 64, 32, 127841, 129120
MID_LAYERS = 20  # Wav2Letter-20: every layer of configs/model/wav2letter.yaml
DEVICE = torch.device('cuda')
# Operations per lattice update in K2: two logaddexp (max, sub, abs, exp,
# log1p, add) and the emission add. K3: per beta update, two logaddexp and
# three emission adds; per gamma, an add, a subtract, an exp and the sum.
K2_OPS_PER_UPDATE = 13
K3_OPS_PER_UPDATE = 15
K3_OPS_PER_GAMMA = 4
WORDS = ('the of and to a in that is was he for it with as his on be at by '
         'had not are but from or have an they which one you were her all '
         'she there would their we him been has when who will more no if '
         "out so said what up its about into than them can only other new "
         "some could time these two may then do first any my now such like "
         "our over man me even most made after also did many before must "
         "through back years where much your way well down should because "
         "each just those people mr how too little state good very make "
         "world still own see men work long get here between both life "
         "being under never day same another know while last might us great "
         "old year off come since against go came right used take three "
         "don't it's").split()


def fail(msg: str):
    raise SystemExit(f'chip_smoke: FAIL: {msg}')


def check(ok: bool, msg: str):
    print(f'[{"OK" if ok else "FAIL"}] {msg}', flush=True)
    if not ok:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls (inputs stay in L2 as they do on the main path,
    where each kernel's input was written just before)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        'nvidia-smi: no output'


# ------------------------------------------------------------------ phases

def phase_environment():
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}')
    nvcc = subprocess.run([_build.find_nvcc(), '--version'],
                          capture_output=True, text=True, timeout=60)
    print('nvcc: ' + nvcc.stdout.strip().splitlines()[-1])
    print(card_line(), flush=True)


def phase_build():
    t0 = time.time()
    paths = _build.build(_build.kernel_sources())
    print(f'built {sorted(paths)} in {time.time() - t0:.1f} s')
    for name, path in sorted(paths.items()):
        with open(path + '.log') as f:
            ptxas = [l.strip() for l in f if 'Used' in l or 'spill' in l]
        print(f'  {name}: ' + ' | '.join(ptxas))
    for name in paths:
        _build.load(name)


def k1_inputs(conf: AudioConfig, B: int, T: int, lens, seed: int, device):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / conf.sample_rate
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)[None]
             + 0.1 * rng.standard_normal((B, T))).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    audio[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    fe = SpectrogramFrontend(conf, n_mels=64, dither=0.0, device=device)
    a = torch.from_numpy(audio).to(device)
    l = torch.from_numpy(lens).to(device)
    return fe, fe.prepare(a, l), l, 1 + T // fe.hop


def k1_compare(name, fe, padded, lens, nf):
    args = (padded, nf, fe.hop, fe.dft_re, fe.dft_im, fe.fb_t)
    raw_k = stft_mel_log(*args)
    raw_p = stft_mel_log_reference(*args)
    norm_k, _ = fe.normalize(raw_k, lens)
    norm_p, _ = fe.normalize(raw_p, lens)
    torch.cuda.synchronize()
    raw_err = (raw_k - raw_p).abs().max().item()
    norm_err = (norm_k - norm_p).abs().max().item()
    check(norm_err <= K1_TOL,
          f'K1 {name} {tuple(padded.shape)} -> {tuple(raw_k.shape)}: '
          f'normalised max err {norm_err:.3e} (gate {K1_TOL}), raw log-mel '
          f'max err {raw_err:.3e}')
    return norm_err


def phase_k1():
    dev = DEVICE
    errs = []
    for name, kw in (('16k', {}), ('8k', dict(sample_rate=8000)),
                     ('16k-hop15ms', dict(window_stride=0.015))):
        conf = AudioConfig(**kw)
        n = 2 * conf.sample_rate
        fe, padded, lens, nf = k1_inputs(
            conf, 4, n, [n, 3 * n // 4, n // 2, n // 3 - 1], 0, dev)
        errs.append(k1_compare(name, fe, padded, lens, nf))
        if name == '16k':
            args = (padded, nf, fe.hop, fe.dft_re, fe.dft_im, fe.fb_t)
            oracle = stft_mel_log_reference(*(a.double() if torch.is_tensor(a)
                                              else a for a in args))
            err = (stft_mel_log(*args).double() - oracle).abs().max().item()
            check(err <= K1_ORACLE_TOL, f'K1 16k vs float64 oracle: raw '
                  f'log-mel max err {err:.3e} (gate {K1_ORACLE_TOL})')
    rng = np.random.default_rng(1)
    lens = rng.integers(LEN_LO, LEN_HI + 1, size=BATCH)
    fe, padded, lens_t, nf = k1_inputs(AudioConfig(), BATCH, LEN_HI, lens,
                                       1, dev)
    errs.append(k1_compare('main path', fe, padded, lens_t, nf))
    return max(errs), (fe, padded, nf)


def k2_inputs(B, T, L, S, seed, device, tl_lo=10, ll_lo=None):
    g = torch.Generator(device='cpu').manual_seed(seed)
    lp = torch.randn(B, T, L, generator=g).log_softmax(-1)
    ll = torch.randint(T - 40 if ll_lo is None else ll_lo, T + 1, (B,),
                       generator=g)
    tl = torch.randint(tl_lo, S + 1, (B,), generator=g)
    tg = torch.randint(1, L, (B, S), generator=g)
    tg = torch.where(torch.arange(S)[None] < tl[:, None], tg, 0)
    return (lp.to(device), ll.int().to(device), tg.int().to(device),
            tl.int().to(device))


def k2_compare(name, args):
    nll_k = ctc_alpha(*args)
    nll_p = ctc_alpha_reference(*args)
    denom = torch.clamp(args[3], min=1).float()
    loss_k = reduce_ctc(nll_k, args[3], 'none') / denom
    loss_p = reduce_ctc(nll_p, args[3], 'none') / denom
    torch.cuda.synchronize()
    err = (loss_k - loss_p).abs().max().item()
    raw = (nll_k - nll_p).abs().max().item()
    check(err < K2_TOL, f'K2 {name} log_probs {tuple(args[0].shape)} S='
          f'{args[2].shape[1]}: per-sample |d loss| {err:.3e} (gate '
          f'{K2_TOL}), |d nll| {raw:.3e}')
    return err


def k2_alphas_compare(name, args):
    """K2 storing alphas against the plain recursion's alphas, on the
    entries K3 reads (t < logit_length, s < 2*S_b + 1)."""
    lp, ll, tg, tl = args
    nll_k, al_k = ctc_alpha(*args, store_alphas=True)
    nll_p, al_p = ctc_alpha_reference(*args, store_alphas=True)
    nll_eval = ctc_alpha(*args)
    torch.cuda.synchronize()
    B, T, N = al_k.shape
    valid = ((torch.arange(T, device=lp.device)[None, :, None]
              < torch.clamp(ll.long(), 1, T)[:, None, None])
             & (torch.arange(N, device=lp.device)[None, None, :]
                < (2 * tl.long() + 1)[:, None, None]))
    rel = ((al_k - al_p).abs() / al_p.abs().clamp(min=1.0))[valid]
    err = rel.max().item()
    same = bool(torch.equal(nll_k, nll_eval))
    nll_err = (nll_k - nll_p).abs().max().item()
    check(err < K2_ALPHA_RTOL and same and nll_err < K2_TOL,
          f'K2 stored alphas {name} {tuple(al_k.shape)}: max relative err '
          f'{err:.3e} over {int(valid.sum())} entries (gate '
          f'{K2_ALPHA_RTOL}); nll equal to the eval variant: {same}; |d nll| '
          f'vs plain {nll_err:.3e}')


def phase_k2(main_s: int):
    dev = DEVICE
    errs = []
    for i, (B, T, L, S) in enumerate(((8, 120, 31, 40), (8, 100, 31, 40),
                                      (16, 800, 31, 70))):
        args = k2_inputs(B, T, L, S, i, dev)
        errs.append(k2_compare(f'grid{i}', args))
        k2_alphas_compare(f'grid{i}', args)
        if T == 800:
            oracle = ctc_alpha_reference(args[0].double(), *args[1:])
            rel = ((ctc_alpha(*args).double() - oracle).abs()
                   / oracle.abs()).max().item()
            check(rel < K2_ORACLE_RTOL, f'K2 T=800 vs float64 oracle: max '
                  f'relative nll err {rel:.3e} (gate {K2_ORACLE_RTOL})')
    # No possible alignment: 20 labels in 10 frames -> loss zeroed.
    args = k2_inputs(4, 10, 29, 20, 9, dev, tl_lo=20, ll_lo=10)
    loss_k = reduce_ctc(ctc_alpha(*args), args[3], 'none')
    loss_p = reduce_ctc(ctc_alpha_reference(*args), args[3], 'none')
    check(bool((loss_k == 0).all() and (loss_p == 0).all()),
          'K2 impossible alignment: zero_infinity zeroes kernel and plain '
          'losses')
    main = k2_inputs(BATCH, 404, 29, main_s, 7, dev, tl_lo=main_s // 2,
                     ll_lo=395)
    errs.append(k2_compare('main path', main))
    k2_alphas_compare('main path', main)
    return max(errs), main


class PlainCTC(torch.autograd.Function):
    """The plain versions of K2 and K3 behind the same autograd seam as
    ``CTCLoss``."""

    @staticmethod
    def forward(ctx, log_probs, logit_lengths, targets, target_lengths):
        nll, alphas = ctc_alpha_reference(log_probs, logit_lengths, targets,
                                          target_lengths, store_alphas=True)
        ctx.save_for_backward(log_probs, alphas, nll, logit_lengths, targets,
                              target_lengths)
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        lp, alphas, nll, ll, tg, tl = ctx.saved_tensors
        return (ctc_beta_reference(lp, alphas, nll, ll, tg, tl,
                                   grad_nll.contiguous()),
                None, None, None)


def ctc_value_and_grad(fn, args, dtype=torch.float32):
    x = args[0].to(dtype).detach().requires_grad_()
    loss = fn(x, *args[1:])
    loss.backward()
    return loss.detach(), x.grad


def kernel_ctc(x, ll, tg, tl):
    return ctc_loss_kernel(x, ll, tg, tl)


def plain_ctc(x, ll, tg, tl):
    return reduce_ctc(PlainCTC.apply(x, ll, tg, tl), tl, 'mean')


def oracle_ctc(x, ll, tg, tl):
    return ctc_loss(x, ll, tg, tl)  # autograd through the plain recursion


def k3_compare(name, args):
    v_k, g_k = ctc_value_and_grad(kernel_ctc, args)
    v_p, g_p = ctc_value_and_grad(plain_ctc, args)
    torch.cuda.synchronize()
    dv = abs(v_k.item() - v_p.item())
    dg = (g_k - g_p).abs().max().item()
    scale = g_p.abs().max().item()
    check(dv < K3_TOL and dg < K3_TOL and dg < K3_RTOL * scale
          and bool(torch.isfinite(g_k).all()),
          f'K3 {name} log_probs {tuple(args[0].shape)} S={args[2].shape[1]}: '
          f'|d mean loss| {dv:.3e}, max |d grad| {dg:.3e} (gate {K3_TOL}); '
          f'max |grad| {scale:.3e}, ratio {dg / scale:.3e} (gate {K3_RTOL})')
    _, g_o = ctc_value_and_grad(oracle_ctc, args, torch.float64)
    rel = (g_k.double() - g_o).abs().max().item() / g_o.abs().max().item()
    check(rel < K3_ORACLE_RTOL, f'K3 {name} vs float64 oracle (autograd '
          f'through the plain recursion): max |d grad| / max |grad| '
          f'{rel:.3e} (gate {K3_ORACLE_RTOL})')
    return dg


def phase_k3(k2_main):
    dev = DEVICE
    errs = []
    for i, (B, T, L, S) in enumerate(((8, 120, 31, 40), (8, 100, 31, 40),
                                      (16, 800, 31, 70))):
        errs.append(k3_compare(f'grid{i}', k2_inputs(B, T, L, S, i, dev)))
    # Row 0 cannot align (at least 10 labels in 2 frames): zero_infinity
    # zeroes its loss, so its gradient must be exactly zero and finite.
    lp, ll, tg, tl = k2_inputs(8, 120, 31, 40, 0, dev)
    ll = ll.clone()
    ll[0] = 2
    args = (lp, ll, tg, tl)
    _, g_k = ctc_value_and_grad(kernel_ctc, args)
    _, g_p = ctc_value_and_grad(plain_ctc, args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(g_k).all() and (g_k[0] == 0).all()
               and (g_k[1:] != 0).any())
          and (g_k - g_p).abs().max().item() < K3_TOL,
          'K3 impossible alignment in row 0: its gradient is exactly zero, '
          'the whole gradient finite, the other rows match the plain version')
    errs.append(k3_compare('main path', k2_main))
    return max(errs)


def write_corpus(root: str) -> tuple[str, int]:
    """N_UTTS seeded ~8 s WAVs (tones + noise) with random transcripts;
    returns (manifest path, longest transcript in labels)."""
    rng = np.random.default_rng(0)
    rows, longest = [], 0
    for i in range(N_UTTS):
        n = int(rng.integers(LEN_LO, LEN_HI + 1))
        t = np.arange(n) / 16000
        audio = sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
                    for _ in range(3)) + 0.05 * rng.standard_normal(n)
        path = os.path.join(root, f'utt{i:03d}.wav')
        write_wav(path, audio.astype(np.float32), 16000)
        text = ' '.join(rng.choice(WORDS, size=int(rng.integers(18, 26))))
        longest = max(longest, len(text))
        rows.append({'audio_filepath': path, 'text': text})
    manifest = os.path.join(root, 'manifest.jsonl')
    with open(manifest, 'w') as f:
        f.write('\n'.join(json.dumps(r) for r in rows) + '\n')
    return manifest, longest


def phase_main_path(manifest: str):
    argv = ['--test-manifest', manifest, '--device', str(DEVICE),
            '--seed', '0', '--batch-size', str(BATCH)]
    out = io.StringIO()
    stft_mel_log.launches = 0
    ctc_alpha.launches = 0
    with contextlib.redirect_stdout(out):
        rc = port_eval.main(argv)
    torch.cuda.synchronize()
    launches = {'stft_mel_log': stft_mel_log.launches,
                'ctc_alpha': ctc_alpha.launches}
    line = out.getvalue().strip().splitlines()[-1]
    print('evaluate.main: ' + line)
    result = json.loads(line)
    print(f'main-path launches: {launches}')
    check(rc == 0, 'evaluate.main returned 0')
    check(all(n > 0 for n in launches.values()),
          f'both kernels launched on the main path: {launches}')
    check(result['num_utterances'] == N_UTTS
          and set(result) == {'loss', 'num_utterances', 'cer', 'wer'}
          and all(math.isfinite(result[k]) for k in ('loss', 'cer', 'wer'))
          and result['loss'] > 0,
          f'result has the test.py keys, {N_UTTS} utterances, finite '
          'loss/WER/CER (random weights: WER is not checked)')
    return launches


def phase_cpu_reference():
    """The eval step on the card vs the same step on the CPU (plain K1/K2,
    ATen convs) with the same full-width weights, on a small input."""
    model, fe, _ = port_eval.build(DEVICE, seed=0)
    rng = np.random.default_rng(5)
    T = 16000
    audio = (0.1 * rng.standard_normal((2, T))).astype(np.float32)
    batch = dict(audio=audio, audio_lengths=np.array([T, 12000], np.int32),
                 targets=rng.integers(1, 29, (2, 16)).astype(np.int32),
                 target_lengths=np.array([16, 9], np.int32),
                 batch_mask=np.ones(2, np.float32))
    outs = {}
    for dev in (DEVICE, torch.device('cpu')):
        m = model.to(dev)
        f = fe.to(dev)
        b = port_eval.to_device(batch, dev)
        loss, ids, _ = port_eval.eval_step(m, f, b)
        with torch.no_grad():
            logp, _ = m(*f(b['audio'], b['audio_lengths']))
        outs[dev.type] = (float(loss), logp.cpu(), ids.cpu())
    (lc, pc, ic), (lr, pr, ir) = outs[DEVICE.type], outs['cpu']
    err = (pc - pr).abs().max().item()
    rel = abs(lc - lr) / abs(lr)
    check(math.isfinite(lc) and rel < 1e-3 and err < 1e-2,
          f'eval step, Wav2Letter-20 full width, B=2 x 1 s: card vs CPU '
          f'loss {lc:.6f} vs {lr:.6f} (rel {rel:.2e}, gate 1e-3), log-prob '
          f'max err {err:.2e} (gate 1e-2), argmax agreement '
          f'{(ic == ir).float().mean().item():.4f}')


def phase_timing(manifest: str, card: str):
    model, fe, labels = port_eval.build(DEVICE, seed=0)
    loader = port_eval.make_loader(manifest, BATCH, fe)
    batches = [port_eval.to_device(b, DEVICE) for b in loader]
    for b in batches:  # warm-up (cuDNN plans, allocator)
        port_eval.eval_step(model, fe, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        for b in batches:
            loss, ids, lens = port_eval.eval_step(model, fe, b)
    ids.cpu()
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t0) / (reps * len(batches))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'eval step (frontend + model + CTC + argmax), B={BATCH}, '
          f'{tuple(batches[0]["audio"].shape)} audio: {per_batch * 1e3:.3f} '
          f'ms/batch, {BATCH / per_batch:.1f} utt/s, peak memory '
          f'{peak:.3f} GiB [{card}]')
    t0 = time.perf_counter()
    result = port_eval.evaluate(model, fe, loader,
                                port_eval.GreedyDecoder(labels), DEVICE)
    wall = time.perf_counter() - t0
    print(f'evaluate() end to end (WAV read, H2D, eval step, decode, WER): '
          f'{wall:.3f} s for {result["num_utterances"]} utterances, '
          f'{result["num_utterances"] / wall:.1f} utt/s [{card}]')

    profile_top(lambda: [port_eval.eval_step(model, fe, b)
                         for b in batches], f'{len(batches)} eval steps')
    return per_batch


def train_config(*overrides, no_dropout: bool = False) -> dict:
    cfg = load_config(['data.train_manifest=unused',
                       'data.val_manifest=unused',
                       f'model.mid_layers={MID_LAYERS}', *overrides])
    if no_dropout:
        for layer in cfg['model']['layers']:
            layer['dropout'] = -1.0
    return cfg


def make_trainer(cfg, run_dir, device, seed=0, dither=None, optimizer=None):
    """A Trainer over a full-width model drawn from ``seed`` (optionally
    with another optimizer and a constant schedule at its lr)."""
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels), seed=seed).to(device)
    fe = build_frontend(cfg['model'], dither=dither, device=device)
    if optimizer is None:
        opt, sched = build_optimizer(model.parameters(), cfg['model'], 1, 1)
    else:
        opt = optimizer(model.parameters())
        sched = constant_lr(opt.param_groups[0]['lr'])
    return Trainer(cfg, model, fe, opt, sched, port_eval.GreedyDecoder(labels),
                   device=device, run_dir=run_dir)


def read_losses(run_dir: str) -> dict:
    losses = {}
    with open(os.path.join(run_dir, 'metrics.csv')) as f:
        for line in f.read().splitlines()[1:]:
            _, step, metric, value = line.split(',')
            if metric == 'train_loss':
                losses[int(step)] = float(value)
    return losses


def phase_train_main(manifest: str, root: str):
    """train.main on cuda: 2 epochs x 2 steps, then --resume for 2 more."""
    run_dir = os.path.join(root, 'train_run')
    base = [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', f'data.batch_size={BATCH}',
            f'model.mid_layers={MID_LAYERS}', 'trainer.log_every_n_steps=1',
            'trainer.checkpoint.keep_last=1',
            f'trainer.default_root_dir={run_dir}', '--device', str(DEVICE)]
    stft_mel_log.launches = ctc_alpha.launches = ctc_beta.launches = 0
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = port_train.main(base + ['trainer.max_epochs=2',
                                     'trainer.max_steps=4'])
    torch.cuda.synchronize()
    launches = {'stft_mel_log': stft_mel_log.launches,
                'ctc_alpha': ctc_alpha.launches,
                'ctc_beta': ctc_beta.launches}
    wall = time.time() - t0
    print('train.main: ' + ' | '.join(out.getvalue().strip().splitlines()))
    print(f'training-path launches (4 steps, 2 validations): {launches}; '
          f'{wall:.1f} s wall')
    check(rc == 0, 'train.main returned 0')
    check(all(n > 0 for n in launches.values()),
          f'K1, K2 and K3 launched on the training path: {launches}')
    ck = Checkpointer(os.path.join(run_dir, 'checkpoints'))
    losses = read_losses(run_dir)
    check(ck.latest_step() == 4 and ck.load_extra() == {'epoch': 2}
          and sorted(losses) == [1, 2, 3, 4]
          and all(math.isfinite(v) for v in losses.values()),
          f'checkpoint at step {ck.latest_step()} with {ck.load_extra()}, '
          f'finite train losses {losses}')
    with open(os.path.join(run_dir, 'metrics.csv')) as f:
        csv_text = f.read()
    check(all(k in csv_text for k in ('val_loss', 'val_wer', 'train_wer',
                                       'learning_rate')),
          'metrics.csv has train and validation metrics')
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_train.main(base + ['trainer.max_epochs=3',
                                     'trainer.max_steps=6', '--resume'])
    torch.cuda.synchronize()
    print('train.main --resume: ' + ' | '.join(
        out.getvalue().strip().splitlines()))
    losses = read_losses(run_dir)
    check(rc == 0 and 'Resumed from step 4' in out.getvalue()
          and Checkpointer(os.path.join(run_dir, 'checkpoints')).latest_step()
          == 6 and sorted(losses) == [1, 2, 3, 4, 5, 6]
          and all(math.isfinite(v) for v in losses.values()),
          f'--resume continued from step 4 to 6: losses {losses}')
    return launches


class BranchClamp(torch.autograd.Function):
    """clamp(0, 20) whose backward passes the gradient where ``mask`` says
    (the branches another evaluation took) instead of where ``x`` is."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return torch.clamp(x, 0.0, 20.0)

    @staticmethod
    def backward(ctx, grad):
        (mask,) = ctx.saved_tensors
        return grad * mask, None


def modulated_tones(rng, B: int, T: int) -> np.ndarray:
    """[B, T] float32: three tones under a slow amplitude envelope, plus
    noise. Unlike stationary noise, it keeps deep activations varying in
    time, so BatchNorm's x - mean does not cancel to rounding noise."""
    t = np.arange(T) / 16000
    rows = []
    for _ in range(B):
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t
                                 + rng.uniform(0, 6))
        tones = sum(np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
                    for _ in range(3))
        rows.append(0.1 * env * tones + 0.02 * rng.standard_normal(T))
    return np.stack(rows).astype(np.float32)


def float64_update(cfg, state: dict, batch: dict, branches: dict) -> dict:
    """The state dict after the same train step run on the CPU in float64,
    every clamp taking the branch recorded in ``branches`` (block index ->
    bool mask of its pre-activations)."""
    from wav2letter_pytorch_tpu_torch.models import wav2letter as w2l
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(state)
    model.double().train()
    opt, _ = build_optimizer(model.parameters(), cfg['model'], 1, 1)
    fe = build_frontend(cfg['model'], dither=0.0)
    b = port_eval.to_device(batch, torch.device('cpu'))
    with torch.no_grad():
        feats, flens = fe(b['audio'], b['audio_lengths'])
    masks = iter([branches[i].double() for i in sorted(branches)])
    plain_clamp = w2l.hardtanh_0_20
    w2l.hardtanh_0_20 = lambda x: BranchClamp.apply(x, next(masks))
    try:
        log_probs, out_lens = model(feats.double(), flens)
    finally:
        w2l.hardtanh_0_20 = plain_clamp
    port_eval.masked_ctc_mean(log_probs, out_lens, b['targets'],
                              b['target_lengths'],
                              b['batch_mask'].double()).backward()
    opt.step()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_train_cpu_reference(root: str):
    """One full-width train step on the card vs the CPU: same weights and
    batch, dither/dropout/augment off, the default SGD (lr 1e-5, Nesterov,
    weight decay).

    clamp(0, 20) has no derivative at 0: a pre-activation within ~1e-6 of
    0 can take the other branch in another float32 evaluation, and through
    BatchNorm's coupling of a channel one such unit moves the gradient of
    every block below it by ~1 % (measured on the CPU against float64). A
    float32 card step and a float32 CPU step differ in a handful of such
    units, so their updates differ by ~1 % whatever the port does. The
    update is therefore held against the same step on the CPU in float64
    that takes the card's clamp branches (``float64_update``); the loss and
    the new BatchNorm statistics, which no branch moves, are held against
    the CPU's float32 step, and the branch disagreements are counted. The
    update is also held against the CPU's float32 step, with no input from
    the card, on the parameters no flip reaches: the blocks above the
    deepest flipped block, and that block's channels that did not flip."""
    cfg = train_config(no_dropout=True)
    rng = np.random.default_rng(6)
    T = 16000
    batch = dict(audio=modulated_tones(rng, 2, T),
                 audio_lengths=np.array([T, 12000], np.int32),
                 targets=rng.integers(1, 29, (2, 16)).astype(np.int32),
                 target_lengths=np.array([16, 9], np.int32),
                 batch_mask=np.ones(2, np.float32))
    res = {}
    for dev in (DEVICE, torch.device('cpu')):
        tr = make_trainer(cfg, os.path.join(root, f'step_{dev.type}'), dev,
                          dither=0.0)
        branches = {}

        def record(i):
            def hook(module, inputs, z):  # clamp's backward passes 0 <= z <= 20
                branches[i] = ((z >= 0) & (z <= 20)).cpu()
            return hook
        hooks = [blk.batch_norm.register_forward_hook(record(i))
                 for i, blk in enumerate(tr.model.conv1ds)
                 if blk.batch_norm is not None and blk.use_activation]
        before = {k: v.detach().cpu().clone()
                  for k, v in tr.model.state_dict().items()}
        loss, _, _ = tr.train_step(port_eval.to_device(batch, dev))
        after = {k: v.detach().cpu().clone()
                 for k, v in tr.model.state_dict().items()}
        for h in hooks:
            h.remove()
        res[dev.type] = (float(loss), before, after, branches)
        del tr
    (lc, bc, ac, zc), (lr_, br, ar, zr) = res[DEVICE.type], res['cpu']
    ref = float64_update(cfg, br, batch, zc)
    flips = sum(int((zc[i] != zr[i]).sum()) for i in zr)
    n_units = sum(z.numel() for z in zr.values())
    params = [k for k in ar if k.endswith(('.weight', '.bias'))]
    stats = [k for k in ar if k.endswith(('running_mean', 'running_var'))]

    def rel_norm(keys, x, y):
        num = sum(float(((x(k) - y(k)) ** 2).sum()) for k in keys)
        return math.sqrt(num / sum(float((y(k) ** 2).sum()) for k in keys))
    upd = rel_norm(params, lambda k: (ac[k] - bc[k]).double(),
                   lambda k: ref[k] - br[k].double())
    upd_cpu = rel_norm(params, lambda k: (ac[k] - bc[k]).double(),
                       lambda k: (ar[k] - br[k]).double())
    # Parameters no flip reaches (keys conv1ds.conv1d_{i}.*; a clamp in
    # block i moves the gradient of its own channel and of every block
    # below it): rows by output channel.
    flipped = {i: (zc[i] != zr[i]).any(dim=2).any(dim=0) for i in zr}
    deepest = max((i for i in zr if flipped[i].any()), default=-1)
    clean = {}
    for k in params:
        i = int(k.split('.')[1].rpartition('_')[2])
        if i > deepest:
            clean[k] = slice(None)
        elif i == deepest:
            clean[k] = ~flipped[i]
    upd_clean = rel_norm(clean, lambda k: (ac[k] - bc[k])[clean[k]].double(),
                         lambda k: (ar[k] - br[k])[clean[k]].double())
    n_clean = sum(ar[k][clean[k]].numel() for k in clean)
    bn = rel_norm(stats, lambda k: ac[k].double(), lambda k: ar[k].double())
    same_init = all(torch.equal(bc[k], br[k]) for k in br)
    loss_rel = abs(lc - lr_) / abs(lr_)
    check(same_init and math.isfinite(lc) and loss_rel < STEP_LOSS_RTOL
          and upd < STEP_UPDATE_RTOL and bn < STEP_BN_RTOL
          and flips <= MAX_BRANCH_FLIPS and upd_clean < STEP_UPDATE_RTOL,
          f'train step, Wav2Letter-20 full width, B=2 x 1 s: card vs CPU loss '
          f'{lc:.6f} vs {lr_:.6f} (rel {loss_rel:.2e}, gate {STEP_LOSS_RTOL});'
          f' update of all {len(params)} parameters vs the CPU float64 step '
          f'on the card\'s clamp branches: relative global norm of the '
          f'difference {upd:.2e} (gate {STEP_UPDATE_RTOL}); vs the CPU '
          f'float32 step {upd_cpu:.2e} with {flips} of {n_units} clamp '
          f'branches taken differently (gate {MAX_BRANCH_FLIPS}), and '
          f'{upd_clean:.2e} (gate {STEP_UPDATE_RTOL}) on the {n_clean} '
          f'parameters no flip reaches (deepest flipped block {deepest}); '
          f'new BN stats {bn:.2e} (gate {STEP_BN_RTOL})')


def phase_overfit(root: str):
    """Full width, one repeated batch (B=8, ~2 s), dropout off, AdamW."""
    cfg = train_config(no_dropout=True)
    rng = np.random.default_rng(8)
    n = 32000
    t = np.arange(n) / 16000
    audio = np.stack([sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
                          for _ in range(3)) + 0.05 * rng.standard_normal(n)
                      for _ in range(8)]).astype(np.float32)
    lens = rng.integers(28000, n + 1, size=8).astype(np.int32)
    tl = rng.integers(15, 25, size=8).astype(np.int32)
    targets = rng.integers(1, 29, (8, 32)).astype(np.int32)
    targets[np.arange(32)[None, :] >= tl[:, None]] = 0
    batch = port_eval.to_device(dict(
        audio=audio, audio_lengths=lens, targets=targets, target_lengths=tl,
        batch_mask=np.ones(8, np.float32)), DEVICE)
    tr = make_trainer(cfg, os.path.join(root, 'overfit'), DEVICE,
                      optimizer=lambda p: torch.optim.AdamW(
                          p, lr=OVERFIT_LR, weight_decay=0.0))
    losses = [float(tr.train_step(batch)[0]) for _ in range(OVERFIT_STEPS)]
    print('overfit losses: ' + ' '.join(f'{v:.3f}' for v in losses))
    first_below = next(i for i, v in enumerate(losses + [0.0])
                       if v < OVERFIT_RATIO * losses[0])
    check(losses[-1] < OVERFIT_RATIO * losses[0],
          f'it trains: AdamW lr {OVERFIT_LR}, loss {losses[0]:.4f} -> '
          f'{losses[-1]:.4f} after {OVERFIT_STEPS - 1} steps (gate < '
          f'{OVERFIT_RATIO} x first; first below it at step {first_below})')


def phase_train_timing(manifest: str, root: str, card: str):
    """Train step (default config: dither, dropout, SGD) at B=32 of ~8 s."""
    cfg = train_config(f'data.train_manifest={manifest}',
                       f'data.val_manifest={manifest}',
                       f'data.batch_size={BATCH}')
    labels = build_labels(cfg['model'])
    loader, _ = port_train.get_data_loaders(labels, cfg['data'])
    batches = [port_eval.to_device(b, DEVICE) for b in loader]
    tr = make_trainer(cfg, os.path.join(root, 'timing'), DEVICE)
    for b in batches:  # warm-up (cuDNN plans, allocator)
        tr.train_step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        for b in batches:
            loss = tr.train_step(b)[0]
    float(loss)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / (reps * len(batches))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'train step (frontend + model fwd/bwd + CTC K2/K3 + SGD), B={BATCH}, '
          f'{tuple(batches[0]["audio"].shape)} audio: {per_step * 1e3:.3f} '
          f'ms/step, {BATCH / per_step:.1f} utt/s, peak memory {peak:.3f} GiB '
          f'[{card}]')
    profile_top(lambda: [tr.train_step(b) for b in batches],
                f'{len(batches)} train steps')
    return per_step


def profile_top(fn, what: str):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e6
    # Kernel and memcpy rows only: operator rows repeat their kernels' time.
    events = [e for e in prof.key_averages()
              if str(getattr(e, 'device_type', '')).endswith('CUDA')
              and getattr(e, 'self_device_time_total', 0) > 0]
    busy = sum(e.self_device_time_total for e in events)
    if busy <= 0:
        print('profiler: no device time recorded (not measured)')
        return
    print(f'profiler, {what}: device busy {busy / 1e3:.3f} ms of '
          f'{window / 1e3:.3f} ms wall ({100 * busy / window:.1f}%)')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f'  {100 * e.self_device_time_total / busy:5.1f}%  '
              f'{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} '
              f'{e.key[:90]}')


def k1_numbers(fe, padded, nf):
    B, P = padded.shape
    n_fft, nb = fe.dft_re.shape
    nm = fe.fb_t.shape[1]
    args = (padded, nf, fe.hop, fe.dft_re, fe.dft_im, fe.fb_t)
    ms = cuda_ms(lambda: stft_mel_log(*args))
    plain_ms = cuda_ms(lambda: stft_mel_log_reference(*args), iters=5)

    def library():
        spec = torch.stft(padded, n_fft, fe.hop, window=fe.window,
                          center=False, return_complex=True)[..., :nf]
        power = spec.real ** 2 + spec.imag ** 2        # [B, bins, frames]
        return torch.log1p(power.transpose(1, 2) @ fe.fb_t + 2.0 ** -24)
    lib_err = (library() - stft_mel_log(*args)).abs().max().item()
    library_ms = cuda_ms(library)
    nbytes = 4 * (B * P + 2 * n_fft * nb + nb * nm + B * nf * nm)
    ops = B * nf * (2 * n_fft * nb * 2 + 3 * nb + 2 * nb * nm)
    print(f'K1 at B={B}, P={P}, {nf} frames: {ops / 1e9:.2f} GFLOP, '
          f'{nbytes / 1e6:.1f} MB; torch.stft path agrees to {lib_err:.2e}')
    return ms, plain_ms, library_ms, nbytes, ops


def lattice_sizes(args):
    """Per row: frames the recursions run (clamped lengths) and lattice
    positions 2*S_b + 1, on the host."""
    lp, ll, tg, tl = args
    lens = torch.clamp(ll.long(), 1, lp.shape[1]).cpu()
    return lens, 2 * tl.long().cpu() + 1


def k2_numbers(args):
    """Times of the store-alphas variant (the training path's launch); the
    eval variant's time is printed beside it."""
    lp, ll, tg, tl = args
    B, T, L = lp.shape
    ms = cuda_ms(lambda: ctc_alpha(*args, store_alphas=True))
    eval_ms = cuda_ms(lambda: ctc_alpha(*args))
    plain_ms = cuda_ms(lambda: ctc_alpha_reference(*args, store_alphas=True),
                       iters=3, warmup=1)
    lp_tbl = lp.transpose(0, 1)

    def library():
        return torch.nn.functional.ctc_loss(lp_tbl, tg, ll, tl,
                                            reduction='none',
                                            zero_infinity=True)
    with torch.no_grad():
        lib_err = (library() - reduce_ctc(ctc_alpha(*args), tl, 'none')
                   ).abs().max().item()
        library_ms = cuda_ms(library)
    lens, n_lat = lattice_sizes(args)
    # log-prob rows read, targets and lengths, nll and the alphas written
    nbytes = int(4 * (lens.sum().item() * L + B * tg.shape[1] + 3 * B
                      + (lens * n_lat).sum().item()))
    ops = int(K2_OPS_PER_UPDATE * ((lens - 1) * n_lat).sum().item())
    print(f'K2 at B={B}, T={T}, L={L}, S={tg.shape[1]}: {ops / 1e6:.1f} '
          f'Mop, {nbytes / 1e6:.2f} MB, {T} dependent steps; storing alphas '
          f'{ms:.4f} ms, eval variant {eval_ms:.4f} ms; F.ctc_loss agrees to '
          f'{lib_err:.2e}')
    return ms, plain_ms, library_ms, nbytes, ops


def k3_numbers(args):
    """K3 at the main path's shape with the upstream gradient of the mean
    loss; the library yardstick is F.ctc_loss's backward (forward +
    backward minus forward)."""
    lp, ll, tg, tl = args
    B, T, L = lp.shape
    nll, alphas = ctc_alpha(*args, store_alphas=True)
    g = (1.0 / (B * torch.clamp(tl, min=1).float())).contiguous()
    ms = cuda_ms(lambda: ctc_beta(lp, alphas, nll, ll, tg, tl, g))
    nll_p, al_p = ctc_alpha_reference(*args, store_alphas=True)
    plain_ms = cuda_ms(lambda: ctc_beta_reference(lp, al_p, nll_p, ll, tg, tl,
                                                  g), iters=3, warmup=1)
    x = lp.transpose(0, 1).detach().requires_grad_()

    def forward():
        return torch.nn.functional.ctc_loss(x, tg, ll, tl, reduction='sum',
                                            zero_infinity=True)

    def forward_backward():
        forward().backward()
    library_ms = max(cuda_ms(forward_backward) - cuda_ms(forward), 0.0)
    lens, n_lat = lattice_sizes(args)
    # alphas and log-prob rows read, the gradient written, small vectors
    nbytes = int(4 * ((lens * (n_lat + L)).sum().item() + B * T * L
                      + B * tg.shape[1] + 5 * B))
    ops = int(K3_OPS_PER_UPDATE * ((lens - 1) * n_lat).sum().item()
              + K3_OPS_PER_GAMMA * (lens * n_lat).sum().item())
    print(f'K3 at B={B}, T={T}, L={L}, S={tg.shape[1]}: {ops / 1e6:.1f} '
          f'Mop, {nbytes / 1e6:.2f} MB, {T} dependent steps')
    return ms, plain_ms, library_ms, nbytes, ops


def kernel_entry(name, source, replaces, launches, err, numbers):
    ms, plain_ms, library_ms, nbytes, ops = numbers
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False: this needs '
              'an NVIDIA GPU', file=sys.stderr)
        return 1
    t_start = time.time()
    port_eval.resolve_device(DEVICE)  # TF32 off for the checks too
    phase_environment()
    card = card_line()
    phase_build()
    k1_err, k1_main = phase_k1()
    with tempfile.TemporaryDirectory() as root:
        manifest, longest = write_corpus(root)
        s_main = -(-longest // 16) * 16  # the loader's target padding
        k2_err, k2_main = phase_k2(s_main)
        k3_err = phase_k3(k2_main)
        phase_main_path(manifest)
        phase_cpu_reference()
        phase_timing(manifest, card)
        launches = phase_train_main(manifest, root)
        torch.cuda.empty_cache()
        phase_train_cpu_reference(root)
        phase_overfit(root)
        torch.cuda.empty_cache()
        phase_train_timing(manifest, root, card)
    kernels = [
        kernel_entry('stft_mel_log', 'wav2letter_pytorch_tpu_torch/csrc/'
                     'stft_mel.cu', 'wav2letter_pytorch_tpu/ops/'
                     'stft_pallas.py:44', launches['stft_mel_log'], k1_err,
                     k1_numbers(*k1_main)),
        kernel_entry('ctc_alpha', 'wav2letter_pytorch_tpu_torch/csrc/'
                     'ctc_alpha.cu', 'wav2letter_pytorch_tpu/ops/'
                     'ctc_pallas.py:62', launches['ctc_alpha'], k2_err,
                     k2_numbers(k2_main)),
        kernel_entry('ctc_beta', 'wav2letter_pytorch_tpu_torch/csrc/'
                     'ctc_beta.cu', 'wav2letter_pytorch_tpu/ops/'
                     'ctc_pallas.py:86', launches['ctc_beta'], k3_err,
                     k3_numbers(k2_main)),
    ]
    print(f'total {time.time() - t_start:.1f} s [{card}]')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
