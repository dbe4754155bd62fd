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
   shape; plus a float64 oracle and an impossible alignment.
5. Main path: 64 synthetic ~8 s utterances written as WAV files, evaluated
   by ``wav2letter_pytorch_tpu_torch.evaluate.main`` on cuda with the full
   20-layer Wav2Letter (seeded random weights) at B=32; both kernels must
   have launched. The eval step on the card is also held against the same
   step on the CPU (plain versions) on a small input. Then per-batch time,
   utterances per second, peak memory and a profiler breakdown.
6. One ``{"kernels": [...]}`` line: per kernel its launches on the main
   path, max error against the plain version, time, plain time, roofline
   bound and the time of the nearest single PyTorch call (timed here only).

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
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.ops.ctc import reduce_ctc
from wav2letter_pytorch_tpu_torch.ops.ctc_kernel import (ctc_alpha,
                                                         ctc_alpha_reference)
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
# Main path: full-width Wav2Letter-20, B=32, ~8 s utterances. Lengths in
# (127840, 129120] samples share the loader's bucket edge 129120 (808
# frames), so every batch has the main path's shape.
N_UTTS, BATCH, LEN_LO, LEN_HI = 64, 32, 127841, 129120
DEVICE = torch.device('cuda')
# Operations per lattice update in K2: two logaddexp (max, sub, abs, exp,
# log1p, add) and the emission add.
K2_OPS_PER_UPDATE = 13
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


def phase_k2(main_s: int):
    dev = DEVICE
    errs = []
    for i, (B, T, L, S) in enumerate(((8, 120, 31, 40), (8, 100, 31, 40),
                                      (16, 800, 31, 70))):
        args = k2_inputs(B, T, L, S, i, dev)
        errs.append(k2_compare(f'grid{i}', args))
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
    return max(errs), main


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

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            port_eval.eval_step(model, fe, b)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e6
    # Kernel and memcpy rows only: operator rows repeat their kernels' time.
    events = [e for e in prof.key_averages()
              if str(getattr(e, 'device_type', '')).endswith('CUDA')
              and getattr(e, 'self_device_time_total', 0) > 0]
    busy = sum(e.self_device_time_total for e in events)
    if busy <= 0:
        print('profiler: no device time recorded (not measured)')
        return per_batch
    print(f'profiler, {len(batches)} eval steps: device busy {busy / 1e3:.3f}'
          f' ms of {window / 1e3:.3f} ms wall ({100 * busy / window:.1f}%)')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f'  {100 * e.self_device_time_total / busy:5.1f}%  '
              f'{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} '
              f'{e.key[:90]}')
    return per_batch


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


def k2_numbers(args):
    lp, ll, tg, tl = args
    B, T, L = lp.shape
    ms = cuda_ms(lambda: ctc_alpha(*args))
    plain_ms = cuda_ms(lambda: ctc_alpha_reference(*args), iters=3,
                       warmup=1)
    lp_tbl = lp.transpose(0, 1)

    def library():
        return torch.nn.functional.ctc_loss(lp_tbl, tg, ll, tl,
                                            reduction='none',
                                            zero_infinity=True)
    with torch.no_grad():
        lib_err = (library() - reduce_ctc(ctc_alpha(*args), tl, 'none')
                   ).abs().max().item()
        library_ms = cuda_ms(library)
    lens = torch.clamp(ll.long(), 1, T).cpu()
    n_lat = (2 * tl.long().cpu() + 1)
    nbytes = int(4 * (lens.sum().item() * L + B * tg.shape[1] + 3 * B))
    ops = int(K2_OPS_PER_UPDATE * ((lens - 1) * n_lat).sum().item())
    print(f'K2 at B={B}, T={T}, L={L}, S={tg.shape[1]}: {ops / 1e6:.1f} '
          f'Mop, {nbytes / 1e6:.2f} MB, {T} dependent steps; '
          f'F.ctc_loss agrees to {lib_err:.2e}')
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
        launches = phase_main_path(manifest)
        phase_cpu_reference()
        phase_timing(manifest, card)
    kernels = [
        kernel_entry('stft_mel_log', 'wav2letter_pytorch_tpu_torch/csrc/'
                     'stft_mel.cu', 'wav2letter_pytorch_tpu/ops/'
                     'stft_pallas.py:44', launches['stft_mel_log'], k1_err,
                     k1_numbers(*k1_main)),
        kernel_entry('ctc_alpha', 'wav2letter_pytorch_tpu_torch/csrc/'
                     'ctc_alpha.cu', 'wav2letter_pytorch_tpu/ops/'
                     'ctc_pallas.py:62', launches['ctc_alpha'], k2_err,
                     k2_numbers(k2_main)),
    ]
    print(f'total {time.time() - t_start:.1f} s [{card}]')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
