#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (wav2letter_pytorch_tpu_torch).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which fails the run (non-zero exit) when a check fails:

1. Environment: torch/CUDA/nvcc versions, the card's name and power limit.
2. Build every kernel under ``wav2letter_pytorch_tpu_torch/csrc/`` with
   nvcc (one process per source, in parallel) and print each kernel's
   registers, shared memory and spills from ptxas; K4 and K5 must spill
   nothing.
3. K1 (stft_mel_log: real FFT, banded mel) against its plain PyTorch
   version (the dense DFT) and a float64 oracle on the card, at 16 kHz,
   8 kHz and a 15 ms hop (B=4, 2 s, ragged lengths), at every n_fft from
   64 to 4096 (through the window length) and at the main path's shape
   (B=32, ~8 s); the wrapper must raise on a CUDA tensor without its
   tables or with an n_fft it does not take.
4. K2 (ctc_alpha) against its plain version over (B, T, L, S) in
   {(8,120,31,40), (8,100,31,40), (16,800,31,70)}, the main path's shape
   and a long shape (32,1000,29,320: ~20 s utterances); plus a float64
   oracle and an impossible alignment; and K2 with stored alphas against
   the plain recursion's alphas on the same shapes. K2 and K3 must raise
   ValueError for a lattice wider than their registers hold (S = 2048).
5. K3 (ctc_beta) through the autograd Function ``CTCLoss`` against its
   plain version on the same shapes: mean loss and d loss / d log_probs
   within 1e-4, and the gradient within 1e-5 of its own largest entry;
   against a float64 oracle (autograd through the float64 plain
   recursion); a batch with an impossible alignment, whose row must get an
   exact-zero, finite gradient; and the same bits from two calls.
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
11. K4/K5 (depthwise forward, input and weight gradient) against their
   plain versions and a float64 oracle on the TPU check grid, the
   QuartzNet main path's C1 shape and shapes at the edges of their tiles
   (``DW_EDGE``), and K5's same bits from two calls; K6/K7 (fused
   separable unit, forward and the three gradients) likewise, with ragged
   lengths, masks on and off, on the TPU grid, the QuartzNet main path's
   unit shapes and shapes at the edges of K6's tiles.
12. QuartzNet-15x5 eval: ``evaluate.main model=quartznet`` at full width on
   the same 64 WAVs, B=32, seeded weights; per forward K4 must launch once
   and K6 76 times; the card's eval step against the CPU's.
13. QuartzNet-15x5 training: ``train.main model=quartznet
   optimizer=novograd``, 4 steps over 2 epochs, then ``--resume`` for 2
   more; K1-K7 must launch. One full-width train step on the card against
   a CPU float64 step on the card's ReLU branches; the loss falls on a
   repeated batch.
14. QuartzNet eval-step and train-step time, utterances per second, peak
   memory and profiler breakdown.
15. Decoding, on the runs of phases 7 and 13 (the host library of
   ``csrc/host/`` is built by g++ in phase 2, its time printed): a 3-gram
   ARPA trained by ``ngram_train`` on the corpus transcripts; sharpened
   random log-probs at the main shape (B=32, T=404, V=29, ragged lengths,
   k=8) searched by the device beam search on the card and on the CPU, the
   C++ host search and (4 utterances) the Python DP: equal strings
   LM-free, LM-fused, with hotwords and with both, and the card's n-best
   scores within 1e-5 of the CPU's; ``evaluate.main --model-path
   <Wav2Letter-20 run> --average-last 2 --lm-path ... --word-timings
   --dump-jsonl`` on the device and on the host beam backend: equal
   hypotheses (a difference only where the host DP ranks both within
   1e-5), K1 and K2 launched, the loss of the same state restored by hand;
   QuartzNet's run through the host beam on its probabilities (K4 and K6
   launched); decode ms a batch under each decoder, evaluate() utt/s under
   each, and the device search's ops a frame.
16. One ``{"kernels": [...]}`` line: per kernel its launches on the
   training path (K1-K3 Wav2Letter's, K4-K7 QuartzNet's), max error
   against the plain version, time, plain time, roofline bound and the time
   of the nearest PyTorch library call (timed here only). K2 and K3 are
   also timed at the long shape, and each prints its ns a dependent step.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import re
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
from wav2letter_pytorch_tpu_torch.data.label_sets import resolve_labels
from wav2letter_pytorch_tpu_torch.decoding.arpa_lm import ArpaLM
from wav2letter_pytorch_tpu_torch.decoding.beam_device import (
    DeviceBeamDecoder, beam_search_device, beam_search_device_lm)
from wav2letter_pytorch_tpu_torch.decoding.beam_native import \
    prefix_beam_search_native
from wav2letter_pytorch_tpu_torch.decoding.decoder import (
    DEFAULT_BEAM_ALPHA, DEFAULT_BEAM_BETA, DEFAULT_BEAM_K, DEFAULT_BEAM_PRUNE,
    PrefixBeamSearchLMDecoder, prefix_beam_search)
from wav2letter_pytorch_tpu_torch.decoding.ngram_train import train_arpa
from wav2letter_pytorch_tpu_torch.models.base import get_same_padding
from wav2letter_pytorch_tpu_torch.models.jasper import Activation
from wav2letter_pytorch_tpu_torch.ops.ctc import (ctc_beta_reference,
                                                  ctc_loss, reduce_ctc)
from wav2letter_pytorch_tpu_torch.ops.ctc_kernel import (ctc_alpha,
                                                         ctc_alpha_reference,
                                                         ctc_beta,
                                                         ctc_loss_kernel)
from wav2letter_pytorch_tpu_torch.ops.depthwise import (
    depthwise_dgrad, depthwise_fwd, depthwise_fwd_reference, depthwise_wgrad,
    depthwise_wgrad_reference, fwd_plan, wgrad_plan)
from wav2letter_pytorch_tpu_torch.ops.depthwise import \
    out_length as dw_out_length
from wav2letter_pytorch_tpu_torch.ops.sep_conv import (mask_lengths, sep_bwd,
                                                       sep_bwd_reference,
                                                       sep_fwd,
                                                       sep_fwd_reference)
from wav2letter_pytorch_tpu_torch.ops.sep_conv import \
    out_length as sep_out_length
from wav2letter_pytorch_tpu_torch.optim import constant_lr
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_labels,
                                                         build_model,
                                                         build_optimizer,
                                                         run_config)
from wav2letter_pytorch_tpu_torch.training.checkpoint import (
    Checkpointer, average_checkpoints)
from wav2letter_pytorch_tpu_torch.training.trainer import Trainer
from wav2letter_pytorch_tpu_torch.ops.stft_mel import (K1Tables,
                                                       stft_mel_log,
                                                       stft_mel_log_reference)

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # FP32 outside the tensor cores
# Gates: the TPU kernel checks' tolerances (scripts/run_tpu_checks.py).
K1_TOL = 5e-3               # max abs on normalised features
K2_TOL = 1e-4               # |d loss| per sample, loss = nll / max(tl, 1)
K1_ORACLE_TOL = 1e-3        # raw log-mel vs float64 (f32 rounding only)
# n_fft of phase_k1's sweep: every size the kernel takes.
K1_FFT_SWEEP = (64, 128, 256, 512, 1024, 2048, 4096)
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
# K4-K7 against their plain versions, max |d| / max |plain| of each output
# (y, dx, dw; dwdw, dwpw): the same float32 arithmetic in other orders
# (FMA chains and fixed-order partial sums in the kernels).
SEP_DW_RTOL = 1e-5
# ... and against a float64 oracle (the plain version in float64, its
# gradients by autograd): the float32 plain version's own error there, on
# the CPU (tools/plain_oracle_errors.py), is at most 4.09e-7 (K4/K5) and
# 8.45e-7 (K6/K7) over these grids; the gates leave 10x for the kernels'
# summation orders.
DW_PLAIN_ORACLE, SEP_PLAIN_ORACLE = 4.1e-7, 8.5e-7
DW_ORACLE_RTOL = 10 * DW_PLAIN_ORACLE
SEP_ORACLE_RTOL = 10 * SEP_PLAIN_ORACLE
# (B, T, C, K, stride, dilation): scripts/run_tpu_checks.py's depthwise
# grid, then QuartzNet's C1 at the main path (64 mels, 808 frames).
DW_GRID = [(4, 400, 256, 33, 1, 1), (4, 400, 512, 74, 1, 1),
           (4, 801, 64, 33, 2, 1), (2, 400, 512, 87, 1, 2)]
DW_MAIN = (32, 808, 64, 33, 2, 1)
# Shapes at the edges of K4's and K5's tiles (ops/depthwise.py's plans: K4
# tiles and K5 chunks of ~128 frames, K4's in whole groups of 16 d', 32
# channels a block, 16-byte copies when C % 4 == 0): T_out one short of a
# tile, one tile, one over (C = 40, not a multiple of 32); the same at two
# tiles (C = 48); C = 8 and C = 50 (4-byte copies) at stride 2 with even
# and odd T; K = 1; an even K at stride 2; C2's K = 87 at d = 2; B = 521,
# where K5's second launch sums 521 partials.
DW_EDGE = [(2, 127, 40, 33, 1, 1), (2, 128, 40, 33, 1, 1),
           (2, 129, 40, 33, 1, 1), (3, 255, 48, 33, 1, 1),
           (3, 256, 48, 33, 1, 1), (3, 257, 48, 33, 1, 1),
           (2, 100, 8, 33, 2, 1), (2, 101, 50, 33, 2, 1),
           (3, 50, 32, 1, 1, 1), (2, 100, 50, 32, 2, 1),
           (2, 150, 40, 87, 1, 2), (521, 40, 8, 5, 1, 1)]
# (B, T, Cin, Cout, K, dilation): run_tpu_checks.py's separable grid, then
# QuartzNet's unit shapes at the main path (B1/B2, B3's first, B5, C2).
SEP_GRID = [(4, 400, 256, 256, 33, 1), (4, 400, 512, 512, 74, 1),
            (2, 400, 512, 512, 87, 2)]
SEP_MAIN = [(32, 404, 256, 256, 33, 1), (32, 404, 256, 512, 51, 1),
            (32, 404, 512, 512, 75, 1), (32, 404, 512, 512, 87, 2)]
# Shapes at the edges of K6's tiles (64 frames, 256 or 512 output channels,
# chunks of 16 input channels, 16-byte copies when Cin and Cout are
# multiples of 4): Cout not a multiple of the tile (200, 640; 198 also not
# of 4), Cin not a multiple of the chunk (100; 50 also not of 4), T_out
# shorter than one tile, K = 1 with p = 0, d = 2 with an even K.
SEP_EDGE = [(2, 100, 64, 200, 33, 1), (2, 100, 64, 640, 33, 1),
            (2, 100, 100, 256, 33, 1), (2, 70, 50, 198, 9, 1),
            (3, 40, 256, 512, 33, 1), (2, 100, 128, 256, 1, 1),
            (2, 100, 64, 96, 4, 2)]
# Shapes at the edges of K7's tiles (time tiles of 64 frames, 32 input
# channels a block, 128 x 128 dwpw tiles): T_out one short of a tile, one
# tile, one over (with Cin 48, 96, 160 not multiples of 32 and Cout 200,
# 136, 264 not of 128); 5 tiles of 301 frames, 2 a block, with Cin 500 and
# Cout 130 (not a multiple of 4: 4-byte copies in the dwpw product); C2's
# K = 87, d = 2 with Cin 42 (4-byte copies in the depthwise pass).
SEP_BWD_EDGE = [(2, 63, 48, 200, 33, 1), (2, 64, 96, 136, 33, 1),
                (2, 65, 160, 264, 33, 1), (16, 301, 500, 130, 33, 1),
                (3, 65, 42, 128, 87, 2)]
# QuartzNet-15x5's K6 units per forward at B=32, T=404: (Cin, Cout, K,
# dilation) -> count; 76 in all.
SEP_PATH_UNITS = {(256, 256, 33, 1): 15, (256, 256, 39, 1): 15,
                  (256, 512, 51, 1): 1, (512, 512, 51, 1): 14,
                  (512, 512, 63, 1): 15, (512, 512, 75, 1): 15,
                  (512, 512, 87, 2): 1}
QN = ['model=quartznet']    # QuartzNet-15x5, all 18 blocks, full width
QN_UNITS = 76               # K6 launches per QuartzNet forward
# Card vs CPU train step (full width, B=2 x 1 s): float32 convolutions
# summed in another order through 20 layers and their backward.
STEP_LOSS_RTOL = 1e-3
STEP_UPDATE_RTOL = 1e-3     # relative global norm of the update difference
MAX_BRANCH_FLIPS = 32       # clamp branches taken differently (of ~1.2 M);
                            # 6 and 11 seen on the H100, ~3x the larger
STEP_BN_RTOL = 1e-3         # relative global norm of the BN stats difference
# QuartzNet's update against the float64 step on the card's branches: the
# float32 floor at this depth is ~1e-3 (9.76e-4 measured on the H100 with
# NovoGrad, whose per-tensor normalisation gives every tensor's error the
# same weight), so the gate is relative to the CPU float32 step's own error
# against float64 on the CPU's branches, measured in the same run.
JASPER_UPDATE_FLOOR_RATIO = 3.0
JASPER_UPDATE_RTOL = 1e-2   # and an absolute cap
# QuartzNet: ReLU branches taken differently on the card and the CPU, as a
# share of all ReLU inputs (3.3 M at B=2 x 1 s): 105 of them (3.2e-5) on an
# H100, ~3x Wav2Letter-20's share (6-11 of 1.2 M); the gate leaves ~30x.
RELU_FLIP_SHARE = 1e-3
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
# log1p, add) and the emission add. K3: the same per beta update (its
# emission add forms u); per gamma, an add, a subtract, an exp and the sum.
K2_OPS_PER_UPDATE = 13
K3_OPS_PER_UPDATE = 13
K3_OPS_PER_GAMMA = 4
# K2/K3's long shape (B, T, L, S): ~20 s utterances at Wav2Letter's stride
# 2 with a transcript of up to 320 characters.
CTC_LONG = (32, 1000, 29, 320)
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


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            queued: bool = True) -> float:
    """Mean time of ``fn`` in ms, by CUDA events around ``iters`` calls
    (inputs stay in L2 as they do on the main path, where each kernel's
    input was written just before). ``queued``: the calls wait behind a
    ~0.1 s spin of the card (``torch.cuda._sleep``), so every launch is on
    the stream before the first one runs and the events time the device
    alone. Back to back (``queued=False``) they also time the host's launch
    cost wherever a call's host side takes longer than its kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_rows(prof) -> list:
    """Kernel and memcpy rows of a profile: operator rows repeat their
    kernels' time, and a user annotation's device row (the optimizer's
    ``Optimizer.step#...`` and ``Optimizer.zero_grad#...``) spans its
    kernels and the gaps between them."""
    return [e for e in prof.key_averages()
            if str(getattr(e, 'device_type', '')).endswith('CUDA')
            and getattr(e, 'self_device_time_total', 0) > 0
            and not getattr(e, 'is_user_annotation', False)
            and not e.key.startswith(('Optimizer.', 'ProfilerStep'))]


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
            lines = f.read().splitlines()
        # ptxas -v: "Function properties for <mangled>", its stack and spill
        # line, then "Used N registers, ... smem"; name each kernel.
        ptxas = []
        for line in lines:
            m = re.search(r'Function properties for '
                          r'\S*?([a-z][a-z0-9_]*_kernel)', line)
            if m:
                ptxas.append(m.group(1) + ':')
            elif 'Used' in line or 'spill' in line:
                ptxas.append(line.replace('ptxas info    :', '').strip())
        print(f'  {name}: ' + ' '.join(ptxas))
        if name == 'depthwise':
            spills = [line for line in lines if re.search(
                r'[1-9]\d* bytes spill (stores|loads)', line)]
            check(not spills, 'ptxas: K4 and K5 spill nothing'
                  + ''.join(f'; {line.strip()}' for line in spills))
    for name in paths:
        _build.load(name)
    t0 = time.time()
    host = _build.build_host()
    _build.load_host()
    print(f'host library {os.path.relpath(host)} (g++ '
          f'{" ".join(_build.GXX_FLAGS)}) built and loaded in '
          f'{time.time() - t0:.1f} s', flush=True)


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


def k1_args(fe, padded, nf):
    """The plain version's arguments (dense bases) for a frontend."""
    return (padded, nf, fe.hop, fe.dft_re, fe.dft_im, fe.fb_t)


def k1_compare(name, fe, padded, lens, nf):
    """K1 (real FFT, banded mel) against the plain dense DFT, normalised
    features, and the raw log-mel against the float64 oracle."""
    args = k1_args(fe, padded, nf)
    raw_k = stft_mel_log(*args, fe.k1_tables())
    raw_p = stft_mel_log_reference(*args)
    norm_k, _ = fe.normalize(raw_k, lens)
    norm_p, _ = fe.normalize(raw_p, lens)
    oracle = stft_mel_log_reference(*(a.double() if torch.is_tensor(a)
                                      else a for a in args))
    torch.cuda.synchronize()
    raw_err = (raw_k - raw_p).abs().max().item()
    norm_err = (norm_k - norm_p).abs().max().item()
    o_err = (raw_k.double() - oracle).abs().max().item()
    p_err = (raw_p.double() - oracle).abs().max().item()
    check(norm_err <= K1_TOL and o_err <= K1_ORACLE_TOL
          and bool(torch.isfinite(raw_k).all()),
          f'K1 {name} n_fft {fe.n_fft} {tuple(padded.shape)} -> '
          f'{tuple(raw_k.shape)}: normalised max err {norm_err:.3e} (gate '
          f'{K1_TOL}), raw log-mel max err {raw_err:.3e}; vs float64 oracle '
          f'{o_err:.3e} (gate {K1_ORACLE_TOL}; plain version {p_err:.3e})')
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
    # Every n_fft the kernel takes, through the window length at 16 kHz.
    for n_fft in K1_FFT_SWEEP:
        conf = AudioConfig(window_size=n_fft / 16000)
        n = 16000
        fe, padded, lens, nf = k1_inputs(conf, 2, n, [n, n // 2 + 7], 2, dev)
        assert fe.n_fft == n_fft, (fe.n_fft, n_fft)
        errs.append(k1_compare('sweep', fe, padded, lens, nf))
    # A CUDA tensor without the kernel's tables, or with an n_fft the kernel
    # does not take, raises before any launch.
    before = stft_mel_log.launches
    for what, tables in (('no tables', None),
                         ('n_fft 8192', K1Tables(
                             torch.zeros(8192, device=dev),
                             torch.zeros(8192, 2, device=dev),
                             fe.k1_bands, fe.k1_weights))):
        try:
            stft_mel_log(*k1_args(fe, padded, nf), tables)
            raised = ''
        except ValueError as e:
            raised = str(e)
        check(bool(raised) and stft_mel_log.launches == before,
              f'K1 wrapper raises ValueError on a CUDA tensor with {what}: '
              f'{raised!r}')
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


def k2_oracle(name, args):
    oracle = ctc_alpha_reference(args[0].double(), *args[1:])
    rel = ((ctc_alpha(*args).double() - oracle).abs()
           / oracle.abs()).max().item()
    check(rel < K2_ORACLE_RTOL, f'K2 {name} vs float64 oracle: max '
          f'relative nll err {rel:.3e} (gate {K2_ORACLE_RTOL})')


CTC_GRID = ((8, 120, 31, 40), (8, 100, 31, 40), (16, 800, 31, 70))


def ctc_long_inputs(dev):
    B, T, L, S = CTC_LONG
    return k2_inputs(B, T, L, S, 11, dev, tl_lo=S // 2, ll_lo=T - 10)


def phase_ctc_limits():
    """K2 and K3 hold a row's 2S+1 lattice positions in one block's
    registers: a wider lattice raises ValueError before any launch."""
    lp, ll, tg, tl = k2_inputs(2, 8, 29, 2048, 12, DEVICE, tl_lo=1, ll_lo=1)
    B, T, _ = lp.shape
    alphas = torch.zeros(B, T, 2 * tg.shape[1] + 1, device=DEVICE)
    vec = torch.ones(B, device=DEVICE)
    before = (ctc_alpha.launches, ctc_beta.launches)
    raised, msg = [], ''
    for fn in (lambda: ctc_alpha(lp, ll, tg, tl, store_alphas=True),
               lambda: ctc_alpha(lp, ll, tg, tl),
               lambda: ctc_beta(lp, alphas, vec, ll, tg, tl, vec)):
        try:
            fn()
            raised.append(False)
        except ValueError as e:
            raised.append(True)
            msg = str(e)
    check(all(raised) and (ctc_alpha.launches, ctc_beta.launches) == before,
          f'K2/K3 at S=2048 (4097 lattice positions) raise ValueError '
          f'before launching: {raised} ({msg})')


def phase_log1p():
    """The CTC kernels' branch-free log1p (csrc/ctc_lattice.cuh) against
    the CUDA math library's log1pf, which the plain versions call through
    torch.logaddexp, on every float in [0, 1]: the kernels round every
    lattice update as the plain version does only if they agree bit for
    bit."""
    fn = _build.load('ctc_alpha').ctc_log1p_mismatches
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p]
    n = fn(torch.cuda.current_stream().cuda_stream)
    check(n == 0, f'K2/K3 log1p vs log1pf on all 1065353217 floats in [0, 1]: '
          f'{n} differ (0 wanted; negative: a CUDA error)')


def phase_k2(main_s: int):
    dev = DEVICE
    errs = []
    phase_log1p()
    for i, (B, T, L, S) in enumerate(CTC_GRID):
        args = k2_inputs(B, T, L, S, i, dev)
        errs.append(k2_compare(f'grid{i}', args))
        k2_alphas_compare(f'grid{i}', args)
        if T == 800:
            k2_oracle('T=800', args)
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
    long = ctc_long_inputs(dev)
    errs.append(k2_compare('long', long))
    k2_alphas_compare('long', long)
    k2_oracle(f'long (T={CTC_LONG[1]})', long)
    phase_ctc_limits()
    return max(errs), main, long


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


def k3_same_bits(name, args):
    """No atomics in K3: two calls on the same inputs give the same
    bits."""
    lp, ll, tg, tl = args
    nll, alphas = ctc_alpha(*args, store_alphas=True)
    g = (1.0 / (lp.shape[0] * torch.clamp(tl, min=1).float())).contiguous()
    first = ctc_beta(lp, alphas, nll, ll, tg, tl, g)
    again = ctc_beta(lp, alphas, nll, ll, tg, tl, g)
    check(bool(torch.equal(first, again)),
          f'K3 {name} {tuple(lp.shape)} S={tg.shape[1]}: two calls give the '
          'same bits')


def phase_k3(k2_main, k2_long):
    dev = DEVICE
    errs = []
    for i, (B, T, L, S) in enumerate(CTC_GRID):
        args = k2_inputs(B, T, L, S, i, dev)
        errs.append(k3_compare(f'grid{i}', args))
        k3_same_bits(f'grid{i}', args)
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
    k3_same_bits('main path', k2_main)
    errs.append(k3_compare('long', k2_long))
    k3_same_bits('long', k2_long)
    return max(errs)


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| / max |ref| (scale-free)."""
    return ((a.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def dw_inputs(B, T, C, K, s, d, seed, device):
    """x [B, T, C], w [K, C], cotangent g [B, T_out, C] (seeded numpy) and
    the padding."""
    rng = np.random.default_rng(seed)
    p = get_same_padding(K, s, d)
    t_out = dw_out_length(T, K, s, d, p)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((K, C))).astype(np.float32)
    g = rng.standard_normal((B, t_out, C)).astype(np.float32)
    return ([torch.from_numpy(a).to(device) for a in (x, w, g)], p)


def dw_plain(x, w, g, s, d, p):
    """(y, dx, dw) of the plain K4 in x's dtype, gradients by autograd."""
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    y = depthwise_fwd_reference(x, w, s, d, p)
    dx, dw = torch.autograd.grad(y, (x, w), g.to(y.dtype))
    return y.detach(), dx, dw


def dw_kernel(x, w, g, s, d, p):
    """(y, dx, dw) of the wrappers: K4, K4 on the stuffed cotangent, K5."""
    return (depthwise_fwd(x, w, s, d, p),
            depthwise_dgrad(g, w, x.shape[1], s, d, p),
            depthwise_wgrad(x, g, w.shape[0], s, d, p))


def phase_k4_k5():
    errs = {'K4': [], 'K5': []}
    for i, shape in enumerate(DW_GRID + [DW_MAIN] + DW_EDGE):
        B, T, C, K, s, d = shape
        (x, w, g), p = dw_inputs(*shape, 20 + i, DEVICE)
        got = dw_kernel(x, w, g, s, d, p)
        plain = dw_plain(x, w, g, s, d, p)
        oracle = dw_plain(x.double(), w.double(), g.double(), s, d, p)
        torch.cuda.synchronize()
        r = [rel_err(a, b) for a, b in zip(got, plain)]
        o = [rel_err(a, b) for a, b in zip(got, oracle)]
        ab = [(a - b).abs().max().item() for a, b in zip(got, plain)]
        errs['K4'] += ab[:2]
        errs['K5'].append(ab[2])
        name = ('main path' if shape == DW_MAIN else
                'edge' if shape in DW_EDGE else f'grid{i}')
        check(max(r) < SEP_DW_RTOL and max(o) < DW_ORACLE_RTOL
              and all(bool(torch.isfinite(t).all()) for t in got),
              f'K4/K5 {name} (B,T,C,K,s,d)={shape}: y, dx, dw vs plain '
              f'{r[0]:.2e} {r[1]:.2e} {r[2]:.2e} (gate {SEP_DW_RTOL}); vs '
              f'float64 oracle {o[0]:.2e} {o[1]:.2e} {o[2]:.2e} (gate '
              f'{DW_ORACLE_RTOL})')
    # No float atomics: two calls give the same bits.
    B, T, C, K, s, d = DW_MAIN
    (x, w, g), p = dw_inputs(*DW_MAIN, 98, DEVICE)
    first = depthwise_wgrad(x, g, K, s, d, p)
    check(torch.equal(first, depthwise_wgrad(x, g, K, s, d, p)),
          f'K5 at {DW_MAIN}: two calls give the same bits')
    return max(errs['K4']), max(errs['K5'])


def sep_inputs(B, T, Cin, Cout, K, d, seed, device, masked=True):
    """x, float lens (ragged, with a .5), wdw, wpw, cotangent g, and the
    padding (seeded numpy)."""
    rng = np.random.default_rng(seed)
    p = get_same_padding(K, 1, d)
    t_out = sep_out_length(T, K, d, p)
    x = rng.standard_normal((B, T, Cin)).astype(np.float32)
    wdw = (0.1 * rng.standard_normal((K, Cin))).astype(np.float32)
    wpw = (rng.standard_normal((Cin, Cout)) / np.sqrt(Cin)).astype(
        np.float32)
    g = rng.standard_normal((B, t_out, Cout)).astype(np.float32)
    lens = (rng.integers(T // 2, T + 1, size=B) + 0.5).astype(np.float32)
    lens[0] = T
    t = [torch.from_numpy(a).to(device) for a in (x, wdw, wpw, g)]
    l1, l2 = (mask_lengths(torch.from_numpy(lens).to(device), K, d, p)
              if masked else (None, None))
    return t, l1, l2, p


def sep_plain(x, l1, l2, wdw, wpw, g, d, p):
    """(y, dx, dwdw, dwpw) of the plain K6 in x's dtype, autograd."""
    ins = [t.detach().requires_grad_() for t in (x, wdw, wpw)]
    y = sep_fwd_reference(ins[0], l1, l2, ins[1], ins[2], d, p)
    grads = torch.autograd.grad(y, ins, g.to(y.dtype))
    return (y.detach(), *grads)


def phase_k6_k7():
    errs = {'K6': [], 'K7': []}
    cases = ([(sh, m) for sh in SEP_GRID for m in (True, False)]
             + [(sh, True) for sh in SEP_MAIN]
             + [(sh, True) for sh in SEP_EDGE + SEP_BWD_EDGE]
             + [(SEP_EDGE[0], False), (SEP_BWD_EDGE[3], False)])
    for i, (shape, masked) in enumerate(cases):
        B, T, Cin, Cout, K, d = shape
        (x, wdw, wpw, g), l1, l2, p = sep_inputs(*shape, 40 + i, DEVICE,
                                                 masked)
        got = (sep_fwd(x, l1, l2, wdw, wpw, d, p),
               *sep_bwd(x, l1, l2, wdw, wpw, g, d, p))
        plain = (sep_fwd_reference(x, l1, l2, wdw, wpw, d, p),
                 *sep_bwd_reference(x, l1, l2, wdw, wpw, g, d, p))
        oracle = sep_plain(x.double(), l1, l2, wdw.double(), wpw.double(),
                           g.double(), d, p)
        torch.cuda.synchronize()
        r = [rel_err(a, b) for a, b in zip(got, plain)]
        o = [rel_err(a, b) for a, b in zip(got, oracle)]
        ab = [(a - b).abs().max().item() for a, b in zip(got, plain)]
        errs['K6'].append(ab[0])
        errs['K7'] += ab[1:]
        name = ('main path' if shape in SEP_MAIN else
                'edge' if shape in SEP_EDGE else
                'K7 edge' if shape in SEP_BWD_EDGE else f'grid{i // 2}')
        check(max(r) < SEP_DW_RTOL and max(o) < SEP_ORACLE_RTOL
              and all(bool(torch.isfinite(t).all()) for t in got),
              f'K6/K7 {name} (B,T,Cin,Cout,K,d)={shape} masks '
              f'{"on" if masked else "off"}: y, dx, dwdw, dwpw vs plain '
              + ' '.join(f'{v:.2e}' for v in r) + f' (gate {SEP_DW_RTOL}); '
              'vs float64 oracle ' + ' '.join(f'{v:.2e}' for v in o)
              + f' (gate {SEP_ORACLE_RTOL})')
    # No float atomics: two calls give the same bits.
    shape = SEP_MAIN[2]
    (x, wdw, wpw, g), l1, l2, p = sep_inputs(*shape, 99, DEVICE)
    first = sep_bwd(x, l1, l2, wdw, wpw, g, shape[5], p)
    again = sep_bwd(x, l1, l2, wdw, wpw, g, shape[5], p)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f'K7 at {shape}: two calls give the same bits')
    return max(errs['K6']), max(errs['K7'])


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


def phase_main_path(manifest: str, overrides=(), what='Wav2Letter-20'):
    """evaluate.main over the corpus; returns the kernels' launches."""
    argv = ['--test-manifest', manifest, '--device', str(DEVICE),
            '--seed', '0', '--batch-size', str(BATCH), *overrides]
    out = io.StringIO()
    counters = (stft_mel_log, ctc_alpha, depthwise_fwd, sep_fwd)
    for fn in counters:
        fn.launches = 0
    with contextlib.redirect_stdout(out):
        rc = port_eval.main(argv)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    line = out.getvalue().strip().splitlines()[-1]
    print(f'evaluate.main ({what}): ' + line)
    result = json.loads(line)
    print(f'main-path launches ({what}): {launches}')
    check(rc == 0, 'evaluate.main returned 0')
    check(launches['stft_mel_log'] > 0 and launches['ctc_alpha'] > 0,
          f'K1 and K2 launched on the {what} eval path: {launches}')
    check(result['num_utterances'] == N_UTTS
          and set(result) == {'loss', 'num_utterances', 'cer', 'wer'}
          and all(math.isfinite(result[k]) for k in ('loss', 'cer', 'wer'))
          and result['loss'] > 0,
          f'result has the test.py keys, {N_UTTS} utterances, finite '
          'loss/WER/CER (random weights: WER is not checked)')
    return launches


def phase_cpu_reference(overrides=(), what='Wav2Letter-20'):
    """The eval step on the card vs the same step on the CPU (plain
    kernels, ATen convs) with the same full-width weights, on a small
    input."""
    model, fe, _ = port_eval.build(DEVICE, seed=0, overrides=overrides)
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
            out, _ = m(*f(b['audio'], b['audio_lengths']))
        outs[dev.type] = (float(loss), out.cpu(), ids.cpu())
    (lc, pc, ic), (lr, pr, ir) = outs[DEVICE.type], outs['cpu']
    err = (pc - pr).abs().max().item()
    rel = abs(lc - lr) / abs(lr)
    kind = 'probability' if getattr(model, 'eval_emits_probs', False) \
        else 'log-prob'
    check(math.isfinite(lc) and rel < 1e-3 and err < 1e-2,
          f'eval step, {what} full width, B=2 x 1 s: card vs CPU '
          f'loss {lc:.6f} vs {lr:.6f} (rel {rel:.2e}, gate 1e-3), {kind} '
          f'max err {err:.2e} (gate 1e-2), argmax agreement '
          f'{(ic == ir).float().mean().item():.4f}')


def phase_timing(manifest: str, card: str, overrides=(),
                 what='Wav2Letter-20'):
    model, fe, labels = port_eval.build(DEVICE, seed=0, overrides=overrides)
    print(f'{what}: {sum(p.numel() for p in model.parameters())} parameters')
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
    print(f'{what} eval step (frontend + model + CTC + argmax), B={BATCH}, '
          f'{tuple(batches[0]["audio"].shape)} audio: {per_batch * 1e3:.3f} '
          f'ms/batch, {BATCH / per_batch:.1f} utt/s, peak memory '
          f'{peak:.3f} GiB [{card}]')
    t0 = time.perf_counter()
    result = port_eval.evaluate(model, fe, loader,
                                port_eval.GreedyDecoder(labels), DEVICE)
    wall = time.perf_counter() - t0
    print(f'{what} evaluate() end to end (WAV read, H2D, eval step, '
          f'decode, WER): '
          f'{wall:.3f} s for {result["num_utterances"]} utterances, '
          f'{result["num_utterances"] / wall:.1f} utt/s [{card}]')

    profile_top(lambda: [port_eval.eval_step(model, fe, b)
                         for b in batches],
                f'{what}, {len(batches)} eval steps')
    return per_batch


def depth_overrides(overrides) -> list:
    """Wav2Letter-20 unless another model group is named."""
    if any(o.startswith('model=') for o in overrides):
        return []
    return [f'model.mid_layers={MID_LAYERS}']


def train_config(*overrides, no_dropout: bool = False) -> dict:
    cfg = load_config(['data.train_manifest=unused',
                       'data.val_manifest=unused',
                       *depth_overrides(overrides), *overrides])
    if no_dropout:
        for layer in cfg['model'].get('layers', []):
            layer['dropout'] = -1.0
        for block in cfg['model'].get('jasper_blocks', []):
            block['dropout'] = 0.0
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


TRAIN_COUNTERS = (stft_mel_log, ctc_alpha, ctc_beta, depthwise_fwd,
                  depthwise_wgrad, sep_fwd, sep_bwd)


def phase_train_main(manifest: str, root: str, overrides=(),
                     what='Wav2Letter-20',
                     kernels=('stft_mel_log', 'ctc_alpha', 'ctc_beta')):
    """train.main on cuda: 2 epochs x 2 steps, then --resume for 2 more;
    ``kernels`` must have launched in the first run. Returns the first
    run's launches and the run directory (its newest two checkpoints, at
    steps 4 and 6, are kept for the decoding phase)."""
    run_dir = os.path.join(root, f'train_run_{len(os.listdir(root))}')
    base = [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', f'data.batch_size={BATCH}',
            *depth_overrides(overrides), *overrides,
            'trainer.log_every_n_steps=1', 'trainer.checkpoint.keep_last=2',
            f'trainer.default_root_dir={run_dir}', '--device', str(DEVICE)]
    for fn in TRAIN_COUNTERS:
        fn.launches = 0
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = port_train.main(base + ['trainer.max_epochs=2',
                                     'trainer.max_steps=4'])
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in TRAIN_COUNTERS}
    wall = time.time() - t0
    print(f'train.main ({what}): ' + ' | '.join(
        out.getvalue().strip().splitlines()))
    print(f'{what} training-path launches (4 steps, 2 validations): '
          f'{launches}; {wall:.1f} s wall')
    check(rc == 0, 'train.main returned 0')
    check(all(launches[k] > 0 for k in kernels),
          f'{", ".join(kernels)} launched on the {what} training path')
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
    print(f'train.main --resume ({what}): ' + ' | '.join(
        out.getvalue().strip().splitlines()))
    losses = read_losses(run_dir)
    check(rc == 0 and 'Resumed from step 4' in out.getvalue()
          and Checkpointer(os.path.join(run_dir, 'checkpoints')).latest_step()
          == 6 and sorted(losses) == [1, 2, 3, 4, 5, 6]
          and all(math.isfinite(v) for v in losses.values()),
          f'--resume continued from step 4 to 6: losses {losses}')
    return launches, run_dir


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


class BranchRelu(torch.autograd.Function):
    """ReLU whose backward passes the gradient where ``mask`` says (the
    branches another evaluation took) instead of where ``x > 0``."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, grad):
        (mask,) = ctx.saved_tensors
        return grad * mask, None


def activations(model) -> dict:
    return {n: m for n, m in model.named_modules()
            if isinstance(m, Activation)}


def jasper_float64_update(cfg, state: dict, batch: dict,
                          branches: dict) -> dict:
    """The state dict after the same train step run on the CPU in float64,
    every ReLU taking the branch recorded in ``branches`` (module name ->
    bool mask of its input > 0)."""
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(state)
    model.double().train()
    opt, _ = build_optimizer(model.parameters(), cfg['model'], 1, 1)
    fe = build_frontend(cfg['model'], dither=0.0)
    b = port_eval.to_device(batch, torch.device('cpu'))
    with torch.no_grad():
        feats, flens = fe(b['audio'], b['audio_lengths'])

    def force(name):
        def hook(module, inputs, out):
            return BranchRelu.apply(inputs[0], branches[name].double())
        return hook
    hooks = [m.register_forward_hook(force(n))
             for n, m in activations(model).items()]
    try:
        log_probs, out_lens = model(feats.double(), flens)
    finally:
        for h in hooks:
            h.remove()
    port_eval.masked_ctc_mean(log_probs, out_lens, b['targets'],
                              b['target_lengths'],
                              b['batch_mask'].double()).backward()
    opt.step()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_jasper_train_cpu_reference(root: str, overrides, what: str):
    """One full-width Jasper-family train step on the card vs the CPU (same
    weights and batch, dither and dropout off, the config's optimizer).
    ReLU has no derivative at 0, so, as with Wav2Letter's clamp, the update
    is held against the CPU step in float64 on the card's ReLU branches,
    the loss and new BatchNorm statistics against the CPU's float32 step,
    and the update also against the CPU float32 step on the parameters no
    branch flip reaches (the blocks above the deepest flipped block, and
    the head)."""
    cfg = train_config(*overrides, no_dropout=True)
    rng = np.random.default_rng(6)
    T = 16000
    batch = dict(audio=modulated_tones(rng, 2, T),
                 audio_lengths=np.array([T, 12000], np.int32),
                 targets=rng.integers(1, 29, (2, 16)).astype(np.int32),
                 target_lengths=np.array([16, 9], np.int32),
                 batch_mask=np.ones(2, np.float32))
    res = {}
    for dev in (DEVICE, torch.device('cpu')):
        tr = make_trainer(cfg, os.path.join(root, f'jstep_{dev.type}'), dev,
                          dither=0.0)
        branches = {}

        def record(name):
            def hook(module, inputs, out):
                branches[name] = (inputs[0] > 0).cpu()
            return hook
        hooks = [m.register_forward_hook(record(n))
                 for n, m in activations(tr.model).items()]
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
    ref = jasper_float64_update(cfg, br, batch, zc)
    ref_cpu = jasper_float64_update(cfg, br, batch, zr)
    flips = {n: int((zc[n] != zr[n]).sum()) for n in zr}
    n_flips = sum(flips.values())
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
    # The float32 floor: the CPU's own float32 step against the float64
    # step on the CPU's branches.
    floor = rel_norm(params, lambda k: (ar[k] - br[k]).double(),
                     lambda k: ref_cpu[k] - br[k].double())
    deepest = max((int(n.split('.')[1]) for n, f in flips.items() if f),
                  default=-1)
    clean = [k for k in params if not k.startswith('jasper_encoder.')
             or int(k.split('.')[1]) > deepest]
    upd_clean = rel_norm(clean, lambda k: (ac[k] - bc[k]).double(),
                         lambda k: (ar[k] - br[k]).double())
    n_clean = sum(ar[k].numel() for k in clean)
    bn = rel_norm(stats, lambda k: ac[k].double(), lambda k: ar[k].double())
    same_init = all(torch.equal(bc[k], br[k]) for k in br)
    loss_rel = abs(lc - lr_) / abs(lr_)
    check(same_init and math.isfinite(lc) and loss_rel < STEP_LOSS_RTOL
          and upd < JASPER_UPDATE_FLOOR_RATIO * floor
          and upd < JASPER_UPDATE_RTOL and bn < STEP_BN_RTOL
          and n_flips <= RELU_FLIP_SHARE * n_units
          and upd_clean < STEP_UPDATE_RTOL,
          f'train step, {what} full width, B=2 x 1 s: card vs CPU loss '
          f'{lc:.6f} vs {lr_:.6f} (rel {loss_rel:.2e}, gate {STEP_LOSS_RTOL});'
          f' update of all {len(params)} parameters vs the CPU float64 step '
          f'on the card\'s ReLU branches: relative global norm of the '
          f'difference {upd:.2e} (gates {JASPER_UPDATE_FLOOR_RATIO} x the '
          f'CPU float32 step\'s own {floor:.2e} against float64 on its '
          f'branches, and {JASPER_UPDATE_RTOL}); vs the CPU '
          f'float32 step {upd_cpu:.2e} with {n_flips} of {n_units} ReLU '
          f'branches taken differently (gate {RELU_FLIP_SHARE} of them), and '
          f'{upd_clean:.2e} (gate {STEP_UPDATE_RTOL}) on the {n_clean} '
          f'parameters no flip reaches (deepest flipped block {deepest}); '
          f'new BN stats {bn:.2e} (gate {STEP_BN_RTOL})')


def phase_overfit(root: str, overrides=(), what='Wav2Letter-20',
                  lr=OVERFIT_LR, steps=OVERFIT_STEPS):
    """Full width, one repeated batch (B=8, ~2 s), dropout off, AdamW."""
    cfg = train_config(*overrides, no_dropout=True)
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
    tr = make_trainer(cfg, os.path.join(root, f'overfit_{what}'), DEVICE,
                      optimizer=lambda p: torch.optim.AdamW(
                          p, lr=lr, weight_decay=0.0))
    losses = [float(tr.train_step(batch)[0]) for _ in range(steps)]
    print(f'{what} overfit losses: ' + ' '.join(f'{v:.3f}' for v in losses))
    first_below = next(i for i, v in enumerate(losses + [0.0])
                       if v < OVERFIT_RATIO * losses[0])
    check(losses[-1] < OVERFIT_RATIO * losses[0],
          f'{what} trains: AdamW lr {lr}, loss {losses[0]:.4f} -> '
          f'{losses[-1]:.4f} after {steps - 1} steps (gate < '
          f'{OVERFIT_RATIO} x first; first below it at step {first_below})')


def phase_train_timing(manifest: str, root: str, card: str, overrides=(),
                       what='Wav2Letter-20'):
    """Train step (the config's defaults: dither, dropout, its optimizer) at
    B=32 of ~8 s."""
    cfg = train_config(f'data.train_manifest={manifest}',
                       f'data.val_manifest={manifest}',
                       f'data.batch_size={BATCH}', *overrides)
    labels = build_labels(cfg['model'])
    loader, _ = port_train.get_data_loaders(labels, cfg['data'])
    batches = [port_eval.to_device(b, DEVICE) for b in loader]
    tr = make_trainer(cfg, os.path.join(root, f'timing_{what}'), DEVICE)
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
    opt = type(tr.optimizer).__name__
    print(f'{what} train step (frontend + model fwd/bwd + CTC K2/K3 + '
          f'{opt}), B={BATCH}, {tuple(batches[0]["audio"].shape)} audio: '
          f'{per_step * 1e3:.3f} ms/step, {BATCH / per_step:.1f} utt/s, peak '
          f'memory {peak:.3f} GiB [{card}]')
    profile_top(lambda: [tr.train_step(b) for b in batches],
                f'{what}, {len(batches)} train steps')
    return per_step


def profile_top(fn, what: str):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e6
    events = kernel_rows(prof)
    busy = sum(e.self_device_time_total for e in events)
    if busy <= 0:
        print('profiler: no device time recorded (not measured)')
        return
    launches = sum(e.count for e in events)
    print(f'profiler, {what}: device busy {busy / 1e3:.3f} ms of '
          f'{window / 1e3:.3f} ms wall ({100 * busy / window:.1f}%), '
          f'{launches} kernel launches')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f'  {100 * e.self_device_time_total / busy:5.1f}%  '
              f'{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} '
              f'{e.key[:90]}')


def k1_fft_ops(n_fft: int, band_bins: int, n_mels: int) -> int:
    """Operations of one frame in K1 as the kernel runs it: the window
    (n_fft multiplies), the n_fft/2-point complex FFT (a radix-2 pass
    without twiddles when log2(n_fft/2) is odd, 4 adds a butterfly; radix-4
    passes of 3 complex twiddle products, 6 each, and 8 complex adds), the
    split step (14 a bin) and the power (3 a bin), the banded mel (2 a
    band bin) and the log (2 a mel)."""
    m = n_fft // 2
    log2_m = m.bit_length() - 1
    fft = (log2_m % 2) * (m // 2) * 4 + (log2_m // 2) * (m // 4) * (18 + 16)
    return n_fft + fft + 17 * (m + 1) + 2 * band_bins + 2 * n_mels


def k1_numbers(fe, padded, nf):
    B, P = padded.shape
    n_fft, nm = fe.n_fft, fe.n_mels
    tables = fe.k1_tables()
    args = (*k1_args(fe, padded, nf), tables)
    ms = cuda_ms(lambda: stft_mel_log(*args))
    print(f'K1 {ms:.4f} ms queued, '
          f'{cuda_ms(lambda: stft_mel_log(*args), queued=False):.4f} ms back '
          'to back')
    plain_ms = cuda_ms(lambda: stft_mel_log_reference(*args[:6]), iters=5)

    def library():
        spec = torch.stft(padded, n_fft, fe.hop, window=fe.window,
                          center=False, return_complex=True)[..., :nf]
        power = spec.real ** 2 + spec.imag ** 2        # [B, bins, frames]
        return torch.log1p(power.transpose(1, 2) @ fe.fb_t + 2.0 ** -24)
    lib_err = (library() - stft_mel_log(*args)).abs().max().item()
    library_ms = cuda_ms(library)
    band_bins = int(tables.bands[:, 1].sum().item())
    # padded audio read once, the tables, the log-mel written once
    nbytes = 4 * (B * P + B * nf * nm + 3 * n_fft + 3 * nm + band_bins)
    ops = B * nf * k1_fft_ops(n_fft, band_bins, nm)
    print(f'K1 at B={B}, P={P}, {nf} frames, n_fft {n_fft}: '
          f'{ops / 1e9:.3f} GFLOP (real FFT, banded mel over {band_bins} '
          f'bins), {nbytes / 1e6:.1f} MB; torch.stft path agrees to '
          f'{lib_err:.2e}')
    return ms, plain_ms, library_ms, nbytes, ops


def lattice_sizes(args):
    """Per row: frames the recursions run (clamped lengths) and lattice
    positions 2*S_b + 1, on the host."""
    lp, ll, tg, tl = args
    lens = torch.clamp(ll.long(), 1, lp.shape[1]).cpu()
    return lens, 2 * tl.long().cpu() + 1


def k2_numbers(args, what='main path', plain=True):
    """Times of the store-alphas variant (the training path's launch); the
    eval variant's time and both variants' ns a dependent step (time over
    the longest row's frames) are printed beside it. ``plain``: time the
    plain version too (else its time is None)."""
    lp, ll, tg, tl = args
    B, T, L = lp.shape
    ms = cuda_ms(lambda: ctc_alpha(*args, store_alphas=True))
    b2b = cuda_ms(lambda: ctc_alpha(*args, store_alphas=True), queued=False)
    print(f'K2 {what}: {ms:.4f} ms queued, {b2b:.4f} ms back to back')
    eval_ms = cuda_ms(lambda: ctc_alpha(*args))
    plain_ms = (cuda_ms(lambda: ctc_alpha_reference(*args,
                                                    store_alphas=True),
                        iters=3, warmup=1) if plain else None)
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
    steps = int(lens.max())
    print(f'K2 {what} at B={B}, T={T}, L={L}, S={tg.shape[1]}: '
          f'{ops / 1e6:.1f} Mop, {nbytes / 1e6:.2f} MB, {steps} dependent '
          f'steps; storing alphas {ms:.4f} ms ({ms * 1e6 / steps:.1f} ns a '
          f'step), eval variant {eval_ms:.4f} ms ({eval_ms * 1e6 / steps:.1f}'
          f' ns a step); F.ctc_loss forward {library_ms:.4f} ms, agrees to '
          f'{lib_err:.2e}; bound {ctc_bound_ms(nbytes, ops):.4f} ms')
    return ms, plain_ms, library_ms, nbytes, ops


def k3_numbers(args, what='main path', plain=True):
    """K3 (two device launches: the beta chain, then the per-label sums)
    with the upstream gradient of the mean loss; the library yardstick is
    F.ctc_loss's backward (forward + backward minus forward)."""
    lp, ll, tg, tl = args
    B, T, L = lp.shape
    nll, alphas = ctc_alpha(*args, store_alphas=True)
    g = (1.0 / (B * torch.clamp(tl, min=1).float())).contiguous()
    ms = cuda_ms(lambda: ctc_beta(lp, alphas, nll, ll, tg, tl, g))
    b2b = cuda_ms(lambda: ctc_beta(lp, alphas, nll, ll, tg, tl, g),
                  queued=False)
    print(f'K3 {what}: {ms:.4f} ms queued, {b2b:.4f} ms back to back')
    plain_ms = None
    if plain:
        nll_p, al_p = ctc_alpha_reference(*args, store_alphas=True)
        plain_ms = cuda_ms(lambda: ctc_beta_reference(
            lp, al_p, nll_p, ll, tg, tl, g), iters=3, warmup=1)
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
    steps = int(lens.max())
    print(f'K3 {what} at B={B}, T={T}, L={L}, S={tg.shape[1]}: '
          f'{ops / 1e6:.1f} Mop, {nbytes / 1e6:.2f} MB, {steps} dependent '
          f'steps; {ms:.4f} ms ({ms * 1e6 / steps:.1f} ns a step); '
          f'F.ctc_loss backward {library_ms:.4f} ms; bound '
          f'{ctc_bound_ms(nbytes, ops):.4f} ms')
    return ms, plain_ms, library_ms, nbytes, ops


def ctc_bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3


def k4_numbers():
    """K4 at QuartzNet's C1 (B=32, 808 frames, 64 mels, K=33, stride 2);
    the library yardstick is cuDNN's depthwise conv (groups = C)."""
    B, T, C, K, s, d = DW_MAIN
    (x, w, g), p = dw_inputs(*DW_MAIN, 30, DEVICE)
    t_out = g.shape[1]
    ms = cuda_ms(lambda: depthwise_fwd(x, w, s, d, p))
    b2b = cuda_ms(lambda: depthwise_fwd(x, w, s, d, p), queued=False)
    print(f'K4 {ms:.4f} ms queued, {b2b:.4f} ms back to back')
    plain_ms = cuda_ms(lambda: depthwise_fwd_reference(x, w, s, d, p),
                       iters=5)
    xt, wt = x.transpose(1, 2), w.t().unsqueeze(1).contiguous()

    def library():
        return torch.nn.functional.conv1d(xt, wt, stride=s, padding=p,
                                          dilation=d, groups=C)
    lib_err = (library().transpose(1, 2)
               - depthwise_fwd(x, w, s, d, p)).abs().max().item()
    library_ms = cuda_ms(library)
    nbytes = 4 * (B * T * C + K * C + B * t_out * C)
    ops = 2 * B * t_out * C * K
    print(f'K4 at {DW_MAIN}: {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; '
          f'cuDNN agrees to {lib_err:.2e}; {fwd_plan(t_out, K, s, d)}')
    return ms, plain_ms, library_ms, nbytes, ops


def k5_numbers():
    """K5 at C1's shape; the yardstick is cuDNN's weight gradient
    (torch.nn.grad.conv1d_weight, one convolution_backward call)."""
    B, T, C, K, s, d = DW_MAIN
    (x, w, g), p = dw_inputs(*DW_MAIN, 31, DEVICE)
    t_out = g.shape[1]
    ms = cuda_ms(lambda: depthwise_wgrad(x, g, K, s, d, p))
    b2b = cuda_ms(lambda: depthwise_wgrad(x, g, K, s, d, p), queued=False)
    print(f'K5 {ms:.4f} ms queued (both launches), {b2b:.4f} ms back to '
          'back')
    plain_ms = cuda_ms(lambda: depthwise_wgrad_reference(x, g, K, s, d, p),
                       iters=5)
    xt, gt = x.transpose(1, 2), g.transpose(1, 2)

    def library():
        return torch.nn.grad.conv1d_weight(xt, (C, 1, K), gt, stride=s,
                                           padding=p, dilation=d, groups=C)
    lib_err = rel_err(library()[:, 0, :].t(),
                      depthwise_wgrad(x, g, K, s, d, p))
    library_ms = cuda_ms(library)
    nbytes = 4 * (B * T * C + B * t_out * C + K * C)
    ops = 2 * B * t_out * C * K
    print(f'K5 at {DW_MAIN}: {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; '
          f'cuDNN agrees to {lib_err:.2e} (relative); '
          f'{wgrad_plan(B, t_out, K, s, d)}')
    return ms, plain_ms, library_ms, nbytes, ops


def sep_library(x, wdw, wpw, d, p):
    """cuDNN: the depthwise conv (groups = Cin), then the 1x1 conv."""
    cin = x.shape[2]
    h = torch.nn.functional.conv1d(x.transpose(1, 2),
                                   wdw.t().unsqueeze(1).contiguous(),
                                   padding=p, dilation=d, groups=cin)
    return torch.nn.functional.conv1d(h, wpw.t().unsqueeze(2).contiguous())


def k6_k7_numbers():
    """K6 and K7 at each of QuartzNet's unit shapes (B=32, 404 frames,
    ragged lengths), averaged over the 76 launches of a forward: per
    launch ms, plain ms, library ms (cuDNN: the depthwise and 1x1 convs;
    for K7 their backward, forward + backward minus forward), bytes and
    operations."""
    B, T = BATCH, 404
    tot6 = np.zeros(5)
    tot7 = np.zeros(5)
    for i, ((cin, cout, K, d), count) in enumerate(SEP_PATH_UNITS.items()):
        (x, wdw, wpw, g), l1, l2, p = sep_inputs(B, T, cin, cout, K, d,
                                                 60 + i, DEVICE)
        t_out = g.shape[1]
        ms6 = cuda_ms(lambda: sep_fwd(x, l1, l2, wdw, wpw, d, p), iters=10)
        plain6 = cuda_ms(lambda: sep_fwd_reference(x, l1, l2, wdw, wpw, d,
                                                   p), iters=3, warmup=1)
        lib6 = cuda_ms(lambda: sep_library(x, wdw, wpw, d, p), iters=10)
        ms7 = cuda_ms(lambda: sep_bwd(x, l1, l2, wdw, wpw, g, d, p),
                      iters=10)
        plain7 = cuda_ms(lambda: sep_bwd_reference(x, l1, l2, wdw, wpw, g, d,
                                                   p), iters=3, warmup=1)
        ins = [t.detach().requires_grad_() for t in (x, wdw, wpw)]
        gt = g.transpose(1, 2)

        def lib_fwd():
            return sep_library(*ins, d, p)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), ins, gt)
        lib7 = max(cuda_ms(lib_fwd_bwd, iters=10) - cuda_ms(lib_fwd,
                                                            iters=10), 0.0)
        ops6 = 2 * B * t_out * cin * (K + cout)
        bytes6 = 4 * (B * T * cin + K * cin + cin * cout + B * t_out * cout
                      + 2 * B)
        ops7 = sum(k7_part_ops(x, l1, l2, wdw, wpw, g).values())
        bytes7 = 4 * (2 * B * T * cin + B * t_out * cout + 2 * K * cin
                      + 2 * cin * cout + 2 * B)
        tot6 += count * np.array([ms6, plain6, lib6, bytes6, ops6])
        tot7 += count * np.array([ms7, plain7, lib7, bytes7, ops7])
        print(f'K6/K7 at (Cin, Cout, K, d)=({cin}, {cout}, {K}, {d}) x{count}'
              f': K6 {ms6:.4f} ms ({ops6 / ms6 / 1e9:.1f} TFLOP/s; plain '
              f'{plain6:.3f}, cuDNN {lib6:.4f}), K7 {ms7:.4f} ms '
              f'({ops7 / ms7 / 1e9:.1f} TFLOP/s; plain {plain7:.3f}, cuDNN '
              f'backward {lib7:.4f})')
    n = sum(SEP_PATH_UNITS.values())
    print(f'K6 per forward: {tot6[0]:.3f} ms over {n} launches '
          f'({tot6[4] / 1e12:.3f} TFLOP); K7 per backward: {tot7[0]:.3f} ms '
          f'({tot7[4] / 1e12:.3f} TFLOP)')
    k7_split_per_backward()
    return tuple(tot6 / n), tuple(tot7 / n)


def k7_split_per_backward(split: bool = True) -> float:
    """K7 at each of QuartzNet's unit shapes (B=32, 404 frames, ragged
    lengths, the inputs ``k6_k7_numbers`` times): its whole time
    (``cuda_ms``) and, with ``split``, each of its kernels' device time by
    part (``k7_split``) with TFLOP/s and bound; then the totals per
    backward (76 calls). Returns K7's ms a backward."""
    total, parts_total, ops_total = 0.0, {}, {}
    for i, ((cin, cout, K, d), count) in enumerate(SEP_PATH_UNITS.items()):
        (x, wdw, wpw, g), l1, l2, p = sep_inputs(BATCH, 404, cin, cout, K, d,
                                                 60 + i, DEVICE)
        ms = cuda_ms(lambda: sep_bwd(x, l1, l2, wdw, wpw, g, d, p), iters=10)
        total += count * ms
        if not split:
            continue
        parts = k7_split(x, l1, l2, wdw, wpw, g, d, p)
        ops = k7_part_ops(x, l1, l2, wdw, wpw, g)
        for n, v in parts.items():
            parts_total[n] = parts_total.get(n, 0.0) + count * v
        for n, v in ops.items():
            ops_total[n] = ops_total.get(n, 0) + count * v
        print(f'K7 split at (Cin, Cout, K, d)={(cin, cout, K, d)} x{count}: '
              f'{ms:.4f} ms; ' + k7_split_line(parts, ops), flush=True)
    n = sum(SEP_PATH_UNITS.values())
    if split:
        print(f'K7 split per backward ({n} calls): {total:.3f} ms '
              f'({total / n:.4f} ms a call); '
              + k7_split_line(parts_total, ops_total), flush=True)
    return total


# K7's kernels by a piece of their (demangled) names -> the part of the
# backward each computes (csrc/sep_conv.cu's header).
K7_PARTS = (('gdw_gemm_kernel', '(i) gdw'), ('sep_bwd_dw_kernel', '(ii) dw'),
            ('pw_gemm_kernel', '(iii) dwpw'),
            ('sum_partials_kernel', '(iv,v) sums'))


def k7_part_ops(x, l1, l2, wdw, wpw, g) -> dict:
    """FLOP of each K7 part that the function needs on these inputs, over
    the frames the masks keep: two products of 2·Cin·Cout a frame before
    len2 (gdw is zero after it, and dwres, which dwpw reduces, too), and
    three depthwise passes of 2·Cin·K a frame (dx before len1, dwres and
    dwdw before len2)."""
    B, T, cin = x.shape
    K, cout, t_out = wdw.shape[0], wpw.shape[1], g.shape[1]
    if l1 is None:
        kept1, kept2 = B * T, B * t_out
    else:
        kept1 = int(l1.clamp(0, T).sum())
        kept2 = int(l2.clamp(0, t_out).sum())
    mm = 2 * kept2 * cin * cout
    return {'(i) gdw': mm, '(ii) dw': 2 * cin * K * (kept1 + 2 * kept2),
            '(iii) dwpw': mm}


def k7_split(x, l1, l2, wdw, wpw, g, d, p, iters: int = 10) -> dict:
    """Device ms of one K7 call by part, from torch.profiler's kernel rows
    over ``iters`` calls (after a warm-up): each part's mean launch in the
    trace times its launches a call (the sums two, the rest one), since
    in a process that profiled before, the trace can miss some launches."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        sep_bwd(x, l1, l2, wdw, wpw, g, d, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            sep_bwd(x, l1, l2, wdw, wpw, g, d, p)
        torch.cuda.synchronize()
    total, seen = {}, {}
    for e in kernel_rows(prof):
        part = next((name for key, name in K7_PARTS if key in e.key), e.key)
        total[part] = total.get(part, 0.0) + e.self_device_time_total / 1e3
        seen[part] = seen.get(part, 0) + e.count
    per_call = {n: 2 if n == '(iv,v) sums' else 1 for n in total}
    off = {n: c for n, c in seen.items() if c != iters * per_call[n]}
    if off:
        print(f'k7_split: launches in the trace over {iters} calls: {off}')
    return {n: total[n] / seen[n] * per_call[n] for n in total}


def k7_split_line(parts: dict, ops: dict) -> str:
    """Each part's ms, with its TFLOP/s and its bound at the FP32 peak."""
    return ', '.join(
        f'{n} {ms:.4f} ms' + (f' ({ops[n] / ms / 1e9:.1f} TFLOP/s, bound '
                              f'{ops[n] / FP32_FLOPS * 1e3:.4f} ms)'
                              if n in ops else '')
        for n, ms in sorted(parts.items()))


# ---------------------------------------------------------------- decoding

PEAKY_SHAPE = (32, 404, 29)  # the main path's eval-step output [B, T', V]
PEAKY_K, PEAKY_ALPHA, PEAKY_BETA = 8, 0.5, 1.0
HOTWORDS = ['the', 'would', 'people']
PY_UTTS = 4                  # utterances the float64 Python DP checks
NBEST_RTOL = 1e-5            # n-best log scores, card vs CPU search
HYP_SCORE_RTOL = 1e-5        # a device/host hypothesis difference must be
#                              a tie of the host DP's ranked scores
LOSS_SAME_RTOL = 1e-5        # CLI loss vs the same state restored by hand


def random_probs(rng, T: int, V: int, peaky: bool = True) -> np.ndarray:
    """The JAX package's tests/test_beam_device.py::_random_probs."""
    logits = rng.standard_normal((T, V)) * (3.0 if peaky else 1.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def manifest_texts(manifest: str) -> list:
    with open(manifest) as f:
        return [json.loads(line)['text'] for line in f if line.strip()]


def phase_lm(manifest: str, root: str) -> str:
    """A 3-gram ARPA trained by the port's ngram_train from the corpus
    transcripts."""
    path = os.path.join(root, 'corpus_3gram.arpa')
    t0 = time.time()
    lm = train_arpa(manifest_texts(manifest), path, order=3)
    print(f'LM: 3-gram over {len(manifest_texts(manifest))} transcripts '
          f'({len(lm.probs[0])} unigrams, {len(lm.probs[1])} bigrams, '
          f'{len(lm.probs[2])} trigrams) in {time.time() - t0:.2f} s')
    return path


def phase_decoding_peaky(lm_path: str):
    """Sharpened log-probs at the main shape: the device search on the card
    and on the CPU, the C++ host search and (on PY_UTTS utterances) the
    float64 Python DP give the same strings, LM-free, LM-fused, with
    hotwords and with both; the card's and the CPU's n-best scores agree."""
    B, T, V = PEAKY_SHAPE
    labels = resolve_labels(port_eval.LABELS)
    rng = np.random.default_rng(0)
    probs = np.stack([random_probs(rng, T, V) for _ in range(B)]).astype(
        np.float32)
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[0] = T
    lp = np.log(probs)
    lp_card = torch.from_numpy(lp).to(DEVICE)
    lm = ArpaLM(lm_path)

    def lm_prob(sentence: str) -> float:
        return 10.0 ** lm.score(sentence)
    kw = dict(k=PEAKY_K, beta=PEAKY_BETA)
    for what, use_lm, hot in (('LM-free', False, None),
                              ('LM-fused', True, None),
                              ('hotwords', False, HOTWORDS),
                              ('LM-fused + hotwords', True, HOTWORDS)):
        times = {}
        if use_lm or hot:
            outs = []
            for x in (lp_card, lp):
                t0 = time.perf_counter()
                outs.append(beam_search_device_lm(
                    x, lens, labels, lm_prob if use_lm else None,
                    alpha=PEAKY_ALPHA, hotwords=hot, **kw))
                times['card' if x is lp_card else 'cpu'] = \
                    time.perf_counter() - t0
            card, cpu = outs
        else:
            nbest = []
            for x in (lp_card, lp):
                t0 = time.perf_counter()
                nbest.append(beam_search_device(x, lens, labels,
                                                n_best=PEAKY_K, **kw))
                times['card' if x is lp_card else 'cpu'] = \
                    time.perf_counter() - t0
            strings = [[[''.join(labels[i] for i in h[0]) for h in hyps]
                        for hyps in r] for r in nbest]
            worst = max(abs(ha[j] - hb[j]) / abs(hb[j])
                        for ra, rb in zip(*nbest) for ha, hb in zip(ra, rb)
                        for j in (1, 2))
            check(strings[0] == strings[1] and worst <= NBEST_RTOL,
                  f'peaky {what}: card and CPU n-best lists (k={PEAKY_K}) '
                  f'equal, scores within {worst:.2e} relative (gate '
                  f'{NBEST_RTOL})')
            card, cpu = [[s[0] for s in r] for r in strings]
        t0 = time.perf_counter()
        host = [prefix_beam_search_native(
            probs[b, :lens[b]], labels, lm=lm if use_lm else None,
            alpha=PEAKY_ALPHA, hotwords=hot, **kw) for b in range(B)]
        times['host C++'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = [prefix_beam_search(
            probs[b, :lens[b]], labels, lm=lm_prob if use_lm else None,
            alpha=PEAKY_ALPHA, hotwords=hot, **kw) for b in range(PY_UTTS)]
        times[f'host Python ({PY_UTTS} utts)'] = time.perf_counter() - t0
        bad = [b for b in range(B) if not card[b] == cpu[b] == host[b]]
        check(not bad and py == host[:PY_UTTS],
              f'peaky {what}, B={B} T={T} V={V} k={PEAKY_K}: card, CPU and '
              f'host C++ strings equal on all {B} utterances (differ on '
              f'{bad}), Python DP equal on {PY_UTTS}; '
              f'{sum(" " in h for h in host)} hypotheses hold a space; '
              + ', '.join(f'{k} {v:.2f} s' for k, v in times.items()))


class timed_evaluate:
    """Records the wall time of ``evaluate.evaluate`` while
    ``evaluate.main`` runs inside the ``with`` block."""

    def __enter__(self):
        self.seconds = None
        self._orig = port_eval.evaluate

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = self._orig(*a, **k)
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t0
            return out
        port_eval.evaluate = wrapped
        return self

    def __exit__(self, *exc):
        port_eval.evaluate = self._orig
        return False


def run_cli(argv, counters=()) -> tuple:
    """evaluate.main(argv): (result, stdout lines, stderr, launches,
    evaluate() seconds)."""
    for fn in counters:
        fn.launches = 0
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            timed_evaluate() as tm:
        rc = port_eval.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, 'evaluate.main returned 0')
    lines = out.getvalue().strip().splitlines()
    launches = {fn.__name__: fn.launches for fn in counters}
    return json.loads(lines[-1]), lines[:-1], err.getvalue(), launches, \
        tm.seconds


def run_model_outputs(run_dir: str, manifest: str, average_last: int):
    """The ``average_last`` state of a run restored by hand (not through
    evaluate.main): (model, frontend, labels, {path: model output [T', V]
    on the host}, the greedy loss of ``evaluate()``)."""
    cfg = run_config(run_dir)
    labels = build_labels(cfg['model'])
    state = average_checkpoints(
        Checkpointer(os.path.join(run_dir, 'checkpoints')), average_last)
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(state['model'])
    model.to(DEVICE).eval()
    fe = build_frontend(cfg['model'], dither=0.0, device=DEVICE)
    loader = port_eval.make_loader(manifest, BATCH, fe, labels)
    greedy = port_eval.evaluate(model, fe, loader,
                                port_eval.GreedyDecoder(labels), DEVICE)
    outs = {}
    for batch in loader:
        _, out, lens = port_eval.eval_step(
            model, fe, port_eval.to_device(batch, DEVICE), 'model')
        out, lens = out.cpu().numpy(), lens.cpu().numpy()
        for j, path in enumerate(batch['paths']):
            if batch['batch_mask'][j]:
                outs[path] = out[j, :lens[j]]
    return model, fe, labels, outs, greedy['loss']


def read_dump(path: str) -> dict:
    with open(path) as f:
        return {r['path']: r for r in map(json.loads, f) if r}


def phase_decoding_w2l(manifest: str, run_dir: str, lm_path: str,
                       root: str, card: str) -> dict:
    """evaluate.main --model-path <Wav2Letter-20 run> --average-last 2
    --lm-path <arpa> --word-timings --dump-jsonl, on the device backend and
    on the host backend: equal hypotheses (a difference only where the
    host DP ranks the two within HYP_SCORE_RTOL), K1 and K2 launched, and
    the CLI's loss equal to the same state restored by hand."""
    common = ['--model-path', run_dir, '--test-manifest', manifest,
              '--device', str(DEVICE), '--batch-size', str(BATCH),
              '--average-last', '2', '--lm-path', lm_path, '--word-timings']
    runs = {}
    for backend in ('device', 'host'):
        dump = os.path.join(root, f'w2l_{backend}.jsonl')
        runs[backend] = run_cli(
            common + ['--beam-backend', backend, '--dump-jsonl', dump],
            counters=(stft_mel_log, ctc_alpha)) + (read_dump(dump),)
        result, lines, err, launches, secs, _ = runs[backend]
        print(f'evaluate.main --beam-backend {backend} (Wav2Letter-20, '
              f'beam + LM): {json.dumps(result)}; {err.strip()}; '
              f'launches {launches}; evaluate() {secs:.2f} s, '
              f'{result["num_utterances"] / secs:.1f} utt/s [{card}]')
        check(launches['stft_mel_log'] > 0 and launches['ctc_alpha'] > 0
              and 'Averaged last 2 checkpoints (through step 6)' in err
              and sum(l.startswith('timings  :') for l in lines) == N_UTTS
              and result['num_utterances'] == N_UTTS,
              f'{backend} backend: K1 and K2 launched, the last 2 '
              f'checkpoints averaged through step 6, {N_UTTS} timing lines')
    dev, host = runs['device'][-1], runs['host'][-1]
    check(sorted(dev) == sorted(host) and len(dev) == N_UTTS,
          f'both dumps hold the {N_UTTS} utterances')
    diff = [p for p in host if dev[p]['hyp'] != host[p]['hyp']]
    _, _, labels, outs, hand_loss = run_model_outputs(run_dir, manifest, 2)
    cli_loss = runs['device'][0]['loss']
    rel = abs(cli_loss - hand_loss) / abs(hand_loss)
    check(rel <= LOSS_SAME_RTOL and runs['host'][0]['loss'] == cli_loss,
          f'the --average-last 2 state restored by hand, greedy: loss '
          f'{hand_loss:.6f} vs the CLI\'s {cli_loss:.6f} (rel {rel:.1e}, gate '
          f'{LOSS_SAME_RTOL})')
    lm = ArpaLM(lm_path)
    for p in diff:
        probs = np.exp(outs[p])
        nbest = dict(prefix_beam_search(
            probs, labels, lm=lambda s: 10.0 ** lm.score(s),
            k=DEFAULT_BEAM_K, alpha=DEFAULT_BEAM_ALPHA,
            beta=DEFAULT_BEAM_BETA, prune=DEFAULT_BEAM_PRUNE,
            return_nbest=DEFAULT_BEAM_K))
        a, b = dev[p]['hyp'], host[p]['hyp']
        sa, sb = nbest.get(a), nbest.get(b)
        print(f'  {os.path.basename(p)}: device {a!r} host score {sa}, '
              f'host {b!r} host score {sb}')
        check(sa is not None and sb is not None
              and abs(sa - sb) <= HYP_SCORE_RTOL * max(abs(sa), abs(sb)),
              f'{os.path.basename(p)}: the hypotheses differ only by a tie '
              f'(gate {HYP_SCORE_RTOL} relative)')
    words = sum(len(r['hyp'].split()) for r in host.values())
    print(f'Wav2Letter-20 device vs host backend: {N_UTTS - len(diff)} of '
          f'{N_UTTS} hypotheses equal ({words} words in all), {len(diff)} '
          'ties')
    return {b: (runs[b][0], runs[b][4]) for b in runs}


def phase_decoding_qn(manifest: str, run_dir: str, card: str):
    """The probabilities branch: QuartzNet-15x5's run, host beam, no LM."""
    result, _, err, launches, secs = run_cli(
        ['--model-path', run_dir, '--test-manifest', manifest, '--device',
         str(DEVICE), '--batch-size', str(BATCH), '--beam-search-params',
         f'k={DEFAULT_BEAM_K}', '--beam-backend', 'host'],
        counters=(stft_mel_log, ctc_alpha, depthwise_fwd, sep_fwd))
    print(f'evaluate.main --beam-backend host (QuartzNet-15x5, k='
          f'{DEFAULT_BEAM_K}): {json.dumps(result)}; {err.strip()}; '
          f'launches {launches}; evaluate() {secs:.2f} s, '
          f'{result["num_utterances"] / secs:.1f} utt/s [{card}]')
    check(launches['depthwise_fwd'] > 0 and launches['sep_fwd'] > 0
          and 'Loaded checkpoint at step 6' in err
          and result['num_utterances'] == N_UTTS
          and all(math.isfinite(result[k]) for k in ('loss', 'wer', 'cer')),
          'QuartzNet-15x5 beam evaluation: K4 and K6 launched, finite '
          'loss/WER/CER')


def host_ms(fn, reps: int = 3, warmup: bool = True) -> float:
    """Mean wall ms of ``fn`` over ``reps`` calls, synchronised."""
    if warmup:
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def search_launches(fn, frames: int) -> tuple:
    """(device ops: kernels and copies, the same a frame, device-busy ms)
    of one call, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = kernel_rows(prof)
    n = sum(e.count for e in events)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    return n, n / frames, busy


def phase_decoding_timing(manifest: str, run_dir: str, lm_path: str,
                          card: str, cli: dict):
    """Decode time of one Wav2Letter-20 batch (B=32) under each decoder,
    evaluate() end to end under each, and the device search's launches."""
    model, fe, labels, _, _ = run_model_outputs(run_dir, manifest, 2)
    loader = port_eval.make_loader(manifest, BATCH, fe, labels)
    torch.cuda.synchronize()
    batch = port_eval.to_device(next(iter(loader)), DEVICE)
    _, ids, lens = port_eval.eval_step(model, fe, batch)
    _, lp, _ = port_eval.eval_step(model, fe, batch, 'model')
    torch.cuda.synchronize()
    B, T, _ = lp.shape
    greedy = port_eval.GreedyDecoder(labels)
    host_lm = PrefixBeamSearchLMDecoder(lm_path, labels)
    dev_free = DeviceBeamDecoder(labels, device=DEVICE)
    dev_lm = DeviceBeamDecoder(labels, lm_path=lm_path, device=DEVICE)
    sizes = lens.cpu().numpy()
    rows = (
        ('host greedy (ids to the host, collapse)', 5,
         lambda: greedy.decode_ids(ids.cpu().numpy(), sizes)),
        ('host C++ beam + LM (log-probs to the host, exp)', 1,
         lambda: host_lm.decode(np.exp(lp.cpu().numpy()), sizes)),
        ('device beam, LM-free', 3,
         lambda: dev_free.decode_log_probs(lp, lens)),
        ('device beam + LM, fused', 1,
         lambda: dev_lm.decode_log_probs(lp, lens)))
    for what, reps, fn in rows:
        ms = host_ms(fn, reps, warmup=reps > 1)
        print(f"decode a batch, Wav2Letter-20 B={B} T'={T}, "
              f'k={DEFAULT_BEAM_K}: {what}: {ms:.2f} ms [{card}]')
    for what, dec in (('LM-free', dev_free), ('+ LM, fused', dev_lm)):
        n, per_frame, busy = search_launches(
            lambda: dec.decode_log_probs(lp, lens), T)
        print(f'device beam {what}, one batch of {T} frames: {n} device '
              f'ops, kernels and copies ({per_frame:.1f} a frame), device '
              f'busy {busy:.2f} ms (profiler) [{card}]')
    for what, dec in (('greedy', greedy), ('device beam, LM-free',
                                           dev_free)):
        t0 = time.perf_counter()
        result = port_eval.evaluate(model, fe, loader, dec, DEVICE)
        secs = time.perf_counter() - t0
        print(f'evaluate() end to end, Wav2Letter-20, {what}: {secs:.2f} s '
              f'for {result["num_utterances"]} utterances, '
              f'{result["num_utterances"] / secs:.1f} utt/s [{card}]')
    for backend, (result, secs) in cli.items():
        print(f'evaluate() end to end, Wav2Letter-20, {backend} beam + LM '
              f'(+ word timings): {secs:.2f} s for '
              f'{result["num_utterances"]} utterances, '
              f'{result["num_utterances"] / secs:.1f} utt/s [{card}]')


def kernel_entry(name, source, replaces, launches, err, numbers):
    ms, plain_ms, library_ms, nbytes, ops = numbers
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': int(launches),
            'max_abs_err': float(err), 'ms': float(ms),
            'plain_ms': float(plain_ms), 'bound_ms': float(max(t_bytes, t_ops)),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': float(library_ms)}


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
    k4_err, k5_err = phase_k4_k5()
    k6_err, k7_err = phase_k6_k7()
    with tempfile.TemporaryDirectory() as root:
        manifest, longest = write_corpus(root)
        s_main = -(-longest // 16) * 16  # the loader's target padding
        k2_err, k2_main, k2_long = phase_k2(s_main)
        k3_err = phase_k3(k2_main, k2_long)
        # Wav2Letter-20
        phase_main_path(manifest)
        phase_cpu_reference()
        phase_timing(manifest, card)
        launches, w2l_run = phase_train_main(manifest, root)
        torch.cuda.empty_cache()
        phase_train_cpu_reference(root)
        phase_overfit(root)
        torch.cuda.empty_cache()
        phase_train_timing(manifest, root, card)
        torch.cuda.empty_cache()
        # QuartzNet-15x5
        qn = dict(overrides=QN, what='QuartzNet-15x5')
        ev = phase_main_path(manifest, **qn)
        n_batches = N_UTTS // BATCH
        check(ev['depthwise_fwd'] == n_batches
              and ev['sep_fwd'] == QN_UNITS * n_batches,
              f'QuartzNet forward launches K4 once and K6 {QN_UNITS} times: '
              f'{ev["depthwise_fwd"]} and {ev["sep_fwd"]} over {n_batches} '
              'batches')
        phase_cpu_reference(**qn)
        phase_timing(manifest, card, **qn)
        qn_launches, qn_run = phase_train_main(
            manifest, root, overrides=QN + ['optimizer=novograd'],
            what='QuartzNet-15x5', kernels=tuple(
                fn.__name__ for fn in TRAIN_COUNTERS))
        torch.cuda.empty_cache()
        phase_jasper_train_cpu_reference(root, QN + ['optimizer=novograd'],
                                         'QuartzNet-15x5')
        phase_overfit(root, **qn, lr=1e-3, steps=60)
        torch.cuda.empty_cache()
        phase_train_timing(manifest, root, card,
                           overrides=QN + ['optimizer=novograd'],
                           what='QuartzNet-15x5')
        torch.cuda.empty_cache()
        # Decoding: the training phases' runs, beam search and an LM
        lm_path = phase_lm(manifest, root)
        phase_decoding_peaky(lm_path)
        cli = phase_decoding_w2l(manifest, w2l_run, lm_path, root, card)
        phase_decoding_qn(manifest, qn_run, card)
        phase_decoding_timing(manifest, w2l_run, lm_path, card, cli)
    k6_numbers, k7_numbers = k6_k7_numbers()
    src = 'wav2letter_pytorch_tpu_torch/csrc/'
    tpu = 'wav2letter_pytorch_tpu/ops/'
    kernels = [
        kernel_entry('stft_mel_log', src + 'stft_mel.cu',
                     tpu + 'stft_pallas.py:44', launches['stft_mel_log'],
                     k1_err, k1_numbers(*k1_main)),
        kernel_entry('ctc_alpha', src + 'ctc_alpha.cu',
                     tpu + 'ctc_pallas.py:62', launches['ctc_alpha'], k2_err,
                     k2_numbers(k2_main)),
        kernel_entry('ctc_beta', src + 'ctc_beta.cu',
                     tpu + 'ctc_pallas.py:86', launches['ctc_beta'], k3_err,
                     k3_numbers(k2_main)),
        kernel_entry('depthwise_fwd', src + 'depthwise.cu',
                     tpu + 'depthwise_pallas.py:76',
                     qn_launches['depthwise_fwd'], k4_err, k4_numbers()),
        kernel_entry('depthwise_wgrad', src + 'depthwise.cu',
                     tpu + 'depthwise_pallas.py:94',
                     qn_launches['depthwise_wgrad'], k5_err, k5_numbers()),
        kernel_entry('sep_fwd', src + 'sep_conv.cu',
                     tpu + 'sep_conv_pallas.py:69', qn_launches['sep_fwd'],
                     k6_err, k6_numbers),
        kernel_entry('sep_bwd', src + 'sep_conv.cu',
                     tpu + 'sep_conv_pallas.py:93', qn_launches['sep_bwd'],
                     k7_err, k7_numbers),
    ]
    long = {}
    for name, fn in (('ctc_alpha', k2_numbers), ('ctc_beta', k3_numbers)):
        ms, _, library_ms, nbytes, ops = fn(k2_long, 'long', plain=False)
        long[name] = {'ms': ms, 'library_ms': library_ms,
                      'bound_ms': ctc_bound_ms(nbytes, ops)}
    print(json.dumps({'ctc_long_shape': list(CTC_LONG), **long}))
    print(f'total {time.time() - t_start:.1f} s [{card}]')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
