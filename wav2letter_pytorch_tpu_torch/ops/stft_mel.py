"""K1: fused STFT -> power -> mel -> log1p, as a CUDA kernel and in plain
PyTorch.

Replaces ``wav2letter_pytorch_tpu/ops/stft_pallas.py::stft_mel_log_pallas``.
``stft_mel_log`` launches ``csrc/stft_mel.cu`` (a real FFT and a banded mel)
for a CUDA tensor and runs ``stft_mel_log_reference`` (the dense DFT) for a
CPU tensor; it never falls back from one to the other.
``stft_mel_log.launches`` counts kernel launches. The kernel reads the
window, the twiddles and the mel band table of ``K1Tables``, which
``build_tables`` makes once per frontend.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build

LOG_ZERO_GUARD = 2.0 ** -24
# n_fft the kernel takes: powers of two in this range.
MIN_FFT, MAX_FFT = 64, 4096


@dataclass(frozen=True)
class K1Tables:
    """What the kernel reads besides the audio: ``window`` [n_fft] f32 (zero
    outside the centred window), ``twiddles`` [n_fft, 2] f32 (cos, sin of
    2 pi k / n_fft, computed in float64), ``bands`` [n_mels, 3] int32 (first
    bin, bin count, offset into ``weights``) and ``weights`` (each filter's
    nonzero run of ``fb_t``, packed)."""
    window: torch.Tensor
    twiddles: torch.Tensor
    bands: torch.Tensor
    weights: torch.Tensor


def check_n_fft(n_fft: int) -> None:
    """Raise ValueError for an n_fft the kernel does not take."""
    if not (MIN_FFT <= n_fft <= MAX_FFT and n_fft & (n_fft - 1) == 0):
        raise ValueError(f'stft_mel_log: the kernel takes n_fft a power of '
                         f'two in [{MIN_FFT}, {MAX_FFT}], got {n_fft}')


def twiddle_table(n_fft: int) -> np.ndarray:
    """[n_fft, 2] float32: cos and sin of 2 pi k / n_fft, in float64 first."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def mel_bands(fb_t: np.ndarray):
    """Band table of a filterbank ``fb_t`` [n_bins, n_mels]: ``bands``
    [n_mels, 3] int32 (first bin, count, offset) covering each filter's
    nonzero support from its first to its last nonzero bin, and the packed
    ``weights`` float32. An all-zero filter gets count 0."""
    n_mels = fb_t.shape[1]
    bands = np.zeros((n_mels, 3), np.int32)
    weights = []
    off = 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb_t[:, m])
        if nz.size:
            lo, hi = int(nz[0]), int(nz[-1]) + 1
            bands[m] = (lo, hi - lo, off)
            weights.append(fb_t[lo:hi, m])
            off += hi - lo
        else:
            bands[m] = (0, 0, off)
    w = (np.concatenate(weights) if weights else np.zeros(0)).astype(
        np.float32)
    return bands, w


def build_tables(window: np.ndarray, fb_t: np.ndarray) -> dict:
    """The kernel's tables as numpy arrays (``K1Tables``' fields) for a
    window [n_fft] and a filterbank [1 + n_fft // 2, n_mels]; raises
    ValueError for an n_fft the kernel does not take."""
    n_fft = window.shape[0]
    check_n_fft(n_fft)
    if fb_t.shape[0] != 1 + n_fft // 2:
        raise ValueError(f'stft_mel_log: filterbank {fb_t.shape} does not '
                         f'fit n_fft {n_fft}')
    bands, weights = mel_bands(fb_t)
    return dict(window=np.asarray(window, np.float32),
                twiddles=twiddle_table(n_fft), bands=bands, weights=weights)


def stft_mel_log_reference(padded: torch.Tensor, n_frames: int, hop: int,
                           dft_re: torch.Tensor, dft_im: torch.Tensor,
                           fb_t: torch.Tensor) -> torch.Tensor:
    """Plain version: explicit frames, two DFT matmuls, power, mel matmul,
    log. ``padded`` [B, P]; ``dft_re``/``dft_im`` [n_fft, n_bins];
    ``fb_t`` [n_bins, n_mels]. Returns [B, n_frames, n_mels] in the input
    dtype (float64 inputs give a float64 oracle)."""
    n_fft = dft_re.shape[0]
    frames = padded.unfold(1, n_fft, hop)[:, :n_frames]  # [B, F, n_fft]
    re = frames @ dft_re
    im = frames @ dft_im
    mel = (re * re + im * im) @ fb_t
    return torch.log1p(mel + LOG_ZERO_GUARD)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library, its functions' ctypes signatures set once."""
    lib = _build.load('stft_mel')
    lib.stft_mel_log_smem_bytes.restype = ctypes.c_longlong
    lib.stft_mel_log_smem_bytes.argtypes = [ctypes.c_int] * 2
    fn = lib.stft_mel_log_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    return lib


@functools.cache
def _smem_bytes(hop: int, n_fft: int) -> int:
    smem = _library().stft_mel_log_smem_bytes(hop, n_fft)
    if smem > _build.SMEM_LIMIT_BYTES:
        raise ValueError(f'stft_mel_log: hop {hop}, n_fft {n_fft} need '
                         f'{smem} bytes of shared memory per block, over '
                         f'the limit of {_build.SMEM_LIMIT_BYTES}')
    return smem


def _launch(padded, n_frames, hop, fb_t, tables):
    B, P = padded.shape
    n_bins, n_mels = fb_t.shape
    if tables is None:
        raise ValueError('stft_mel_log: a CUDA tensor needs the kernel\'s '
                         'tables (K1Tables, built by the frontend)')
    n_fft = tables.window.shape[0]
    check_n_fft(n_fft)
    want = {'window': (n_fft,), 'twiddles': (n_fft, 2),
            'bands': (n_mels, 3)}
    for name in ('padded', 'window', 'twiddles', 'bands', 'weights'):
        t = padded if name == 'padded' else getattr(tables, name)
        dtype = torch.int32 if name == 'bands' else torch.float32
        if t.device != padded.device or t.dtype != dtype:
            raise ValueError(f'stft_mel_log: {name} must be {dtype} on '
                             f'{padded.device}, got {t.dtype} on {t.device}')
        if not t.is_contiguous() or (name != 'padded' and t.data_ptr() % 16):
            raise ValueError(f'stft_mel_log: {name} must be contiguous'
                             + ('' if name == 'padded' else
                                ' and 16-byte aligned'))
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f'stft_mel_log: {name} must be {want[name]}, '
                             f'got {tuple(t.shape)}')
    if n_bins != 1 + n_fft // 2:
        raise ValueError(f'stft_mel_log: filterbank {tuple(fb_t.shape)} '
                         f'does not fit n_fft {n_fft}')
    if n_frames < 1 or (n_frames - 1) * hop + n_fft > P:
        raise ValueError(f'stft_mel_log: {n_frames} frames of {n_fft} '
                         f'samples at hop {hop} do not fit in {P} samples')
    lib = _library()
    _smem_bytes(hop, n_fft)
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32,
                      device=padded.device)
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stft_mel_log_launch(
            padded.data_ptr(), B, P, tables.window.data_ptr(),
            tables.twiddles.data_ptr(), n_fft, tables.bands.data_ptr(),
            tables.weights.data_ptr(), n_mels, hop, n_frames, out.data_ptr(),
            stream)
    _build.check(lib, code, 'stft_mel_log launch')
    stft_mel_log.launches += 1
    return out


def stft_mel_log(padded: torch.Tensor, n_frames: int, hop: int,
                 dft_re: torch.Tensor, dft_im: torch.Tensor,
                 fb_t: torch.Tensor,
                 tables: K1Tables | None = None) -> torch.Tensor:
    """Log-mel features ``[B, n_frames, n_mels]`` of centre-padded audio
    ``padded`` [B, P]; frame f covers samples [f*hop, f*hop + n_fft).

    A CUDA tensor goes through the kernel, which reads ``tables`` and not
    the dense bases (float32, contiguous; raises without tables, on an
    n_fft it does not take, on anything else it does not take or on a
    failed launch); a CPU tensor through ``stft_mel_log_reference``.
    """
    if padded.device.type == 'cuda':
        return _launch(padded, n_frames, hop, fb_t, tables)
    if padded.device.type != 'cpu':
        raise ValueError(f'stft_mel_log: unsupported device {padded.device}')
    return stft_mel_log_reference(padded, n_frames, hop, dft_re, dft_im, fb_t)


stft_mel_log.launches = 0
