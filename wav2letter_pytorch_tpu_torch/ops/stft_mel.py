"""K1: fused STFT -> power -> mel -> log1p, as a CUDA kernel and in plain
PyTorch.

Replaces ``wav2letter_pytorch_tpu/ops/stft_pallas.py::stft_mel_log_pallas``.
``stft_mel_log`` launches ``csrc/stft_mel.cu`` for a CUDA tensor and runs
``stft_mel_log_reference`` for a CPU tensor; it never falls back from one
to the other. ``stft_mel_log.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

LOG_ZERO_GUARD = 2.0 ** -24


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


def _launch(padded, n_frames, hop, dft_re, dft_im, fb_t):
    B, P = padded.shape
    n_fft, n_bins = dft_re.shape
    n_mels = fb_t.shape[1]
    for name, t in (('padded', padded), ('dft_re', dft_re),
                    ('dft_im', dft_im), ('fb_t', fb_t)):
        if t.device != padded.device or t.dtype != torch.float32:
            raise ValueError(f'stft_mel_log: {name} must be float32 on '
                             f'{padded.device}, got {t.dtype} on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'stft_mel_log: {name} must be contiguous')
    if dft_im.shape != dft_re.shape or fb_t.shape[0] != n_bins:
        raise ValueError(f'stft_mel_log: bases {tuple(dft_re.shape)}, '
                         f'{tuple(dft_im.shape)} and filterbank '
                         f'{tuple(fb_t.shape)} do not agree')
    if n_frames < 1 or (n_frames - 1) * hop + n_fft > P:
        raise ValueError(f'stft_mel_log: {n_frames} frames of {n_fft} '
                         f'samples at hop {hop} do not fit in {P} samples')
    lib = _build.load('stft_mel')
    lib.stft_mel_log_smem_bytes.restype = ctypes.c_longlong
    lib.stft_mel_log_smem_bytes.argtypes = [ctypes.c_int] * 3
    smem = lib.stft_mel_log_smem_bytes(hop, n_fft, n_mels)
    if smem > _build.SMEM_LIMIT_BYTES:
        raise ValueError(f'stft_mel_log: hop {hop}, n_fft {n_fft}, '
                         f'{n_mels} mels need {smem} bytes of shared memory '
                         f'per block, over the limit of '
                         f'{_build.SMEM_LIMIT_BYTES}')
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32,
                      device=padded.device)
    fn = lib.stft_mel_log_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(padded.data_ptr(), B, P, dft_re.data_ptr(),
                  dft_im.data_ptr(), n_fft, n_bins, fb_t.data_ptr(), n_mels,
                  hop, n_frames, out.data_ptr(), stream)
    _build.check(lib, code, 'stft_mel_log launch')
    stft_mel_log.launches += 1
    return out


def stft_mel_log(padded: torch.Tensor, n_frames: int, hop: int,
                 dft_re: torch.Tensor, dft_im: torch.Tensor,
                 fb_t: torch.Tensor) -> torch.Tensor:
    """Log-mel features ``[B, n_frames, n_mels]`` of centre-padded audio
    ``padded`` [B, P]; frame f covers samples [f*hop, f*hop + n_fft).

    A CUDA tensor goes through the kernel (float32, contiguous; raises on
    anything else or on a failed launch); a CPU tensor through
    ``stft_mel_log_reference``.
    """
    if padded.device.type == 'cuda':
        return _launch(padded, n_frames, hop, dft_re, dft_im, fb_t)
    if padded.device.type != 'cpu':
        raise ValueError(f'stft_mel_log: unsupported device {padded.device}')
    return stft_mel_log_reference(padded, n_frames, hop, dft_re, dft_im, fb_t)


stft_mel_log.launches = 0
