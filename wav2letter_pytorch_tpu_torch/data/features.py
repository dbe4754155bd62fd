"""Batched, masked log-mel (or MFCC) spectrogram frontend (PyTorch).

Same numerics as ``wav2letter_pytorch_tpu.data.features``: int16 PCM in
as ``x / 32768`` (exact), optional dither, pre-emphasis 0.97, reflect
centre padding by n_fft // 2 at each sample's own length, a windowed real
DFT (symmetric window centred in an n_fft = 2^ceil(log2(window)) frame),
power, a Slaney mel filterbank, ``log1p(mel + 2^-24)``, with
``feature_type='mfcc'`` an orthonormal DCT-II over the log-mel bands,
then per-feature normalisation over each sample's valid frames (unbiased
std) with padding frames zeroed. Serving can instead
normalise with fixed corpus statistics (``norm_stats``, CMVN) or not at all
(``normalize=False``, the raw masked features CMVN is measured on).

The framing -> DFT -> power -> mel -> log part is kernel K1
(``ops/stft_mel.py``): a real FFT and a banded mel in a CUDA kernel on the
card, its plain PyTorch version (a dense DFT) on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..config import CHOICES
from ..parallel.mesh import draw_rows
from ..ops.stft_mel import (MAX_FFT, MIN_FFT, K1Tables, build_tables,
                            check_n_fft, stft_mel_log,
                            stft_mel_log_reference)

DITHER = 1e-5
PREEMPH = 0.97
LOG_ZERO_GUARD = 2.0 ** -24
NORM_EPS = 1e-5
# ``model.stft_method`` (``config.CHOICES``): 'auto' and 'pallas' run K1
# (its plain version on a CPU tensor); the JAX package's three XLA
# formulations (a strided conv, a frame matmul, an FFT) are one plain
# dense DFT here, on either device.
PLAIN_METHODS = ('conv', 'matmul', 'fft')


# --------------------------------------------------------------------------
# Mel filterbank (Slaney mel scale, Slaney normalisation; librosa's default)
# --------------------------------------------------------------------------

def hz_to_mel(hz):
    hz = np.asanyarray(hz, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    linear = hz / f_sp
    log = (min_log_mel
           + np.log(np.maximum(hz, min_log_hz) / min_log_hz) / logstep)
    return np.where(hz >= min_log_hz, log, linear)


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    linear = mel * f_sp
    log = min_log_hz * np.exp(logstep * (mel - min_log_mel))
    return np.where(mel >= min_log_mel, log, linear)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Triangular mel filterbank [n_mels, 1 + n_fft//2] from 0 Hz to
    Nyquist, Slaney-normalised."""
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def get_window(name: str, length: int) -> np.ndarray:
    """Symmetric (periodic=False) window of ``length`` samples."""
    n = np.arange(length, dtype=np.float64)
    denom = max(length - 1, 1)
    if name == 'hamming':
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / denom)
    elif name == 'hann':
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / denom)
    elif name == 'blackman':
        w = (0.42 - 0.5 * np.cos(2 * np.pi * n / denom)
             + 0.08 * np.cos(4 * np.pi * n / denom))
    elif name == 'bartlett':
        w = 1.0 - np.abs(2.0 * n / denom - 1.0)
    elif name in ('none', None):
        w = np.ones(length)
    else:
        raise ValueError(f'unknown window: {name!r}')
    return w.astype(np.float32)


@dataclass(frozen=True)
class AudioConfig:
    """Audio/feature settings; the defaults are ``configs/audio/
    standard_16k.yaml`` of the JAX package (16 kHz, 20 ms Hamming window,
    10 ms hop)."""
    sample_rate: int = 16000
    window_size: float = 0.02     # seconds
    window_stride: float = 0.01   # seconds
    window: str = 'hamming'

    @property
    def window_size_samples(self) -> int:
        return int(self.sample_rate * self.window_size)

    @property
    def hop_samples(self) -> int:
        return int(self.sample_rate * self.window_stride)

    @property
    def n_fft(self) -> int:
        return 2 ** math.ceil(math.log2(self.window_size_samples))


def num_frames(num_samples: int, hop: int) -> int:
    """Frame count for a centre-padded STFT: 1 + floor(T / hop)."""
    return 1 + num_samples // hop


def dct_basis(n_mels: int, n_mfcc: int) -> np.ndarray:
    """Orthonormal DCT-II basis ``[n_mels, n_mfcc]`` (float32)."""
    k = np.arange(n_mels)[:, None]
    j = np.arange(n_mfcc)[None, :]
    dct = np.cos(np.pi * (2 * k + 1) * j / (2 * n_mels))
    dct *= np.sqrt(2.0 / n_mels)
    dct[:, 0] *= np.sqrt(0.5)
    return dct.astype(np.float32)


class SpectrogramFrontend(nn.Module):
    """Log-mel extractor: ``forward(audio [B, T], sample_lengths [B])``
    returns ``(features [B, n_frames, C], frame_lengths [B])``, C the
    ``n_mels`` log-mel bands or, with ``feature_type='mfcc'``, the first
    ``n_mfcc`` (default ``n_mels``) coefficients of their DCT. ``audio``
    is float32, or int16 PCM (the int16 wire), taken as ``x / 32768``.

    The DFT bases and the filterbank are buffers, so ``.to(device)`` moves
    them with the module; so are kernel K1's tables (twiddles, mel band
    table; not saved in a state dict), built once here for every n_fft the
    kernel takes.

    ``norm_stats``: ``(mean [n_mels], std [n_mels])`` corpus statistics;
    features are then normalised as ``(x - mean) / (std + 1e-5)`` in place
    of the per-utterance statistics. ``normalize=False`` emits the raw
    log-mel features (padding frames zeroed).

    ``stft_method`` is the JAX package's ``model.stft_method``: ``auto``
    and ``pallas`` run K1 (``pallas`` raises here for an n_fft the kernel
    does not take), ``conv``, ``matmul`` and ``fft`` its plain version on
    any device.
    """

    def __init__(self, audio_conf: AudioConfig = AudioConfig(),
                 n_mels: int = 64, dither: float = DITHER,
                 device: str | torch.device = 'cpu',
                 norm_stats=None, normalize: bool = True,
                 feature_type: str = 'logmel', n_mfcc: int | None = None,
                 stft_method: str = 'auto'):
        super().__init__()
        choices = CHOICES['model.stft_method']
        if stft_method not in choices:
            raise ValueError(f'stft_method must be one of {choices}, got '
                             f'{stft_method!r}')
        self.stft_method = stft_method
        self.conf = audio_conf
        self.n_mels = n_mels
        if feature_type not in ('logmel', 'mfcc'):
            raise ValueError(f'unknown feature_type: {feature_type!r}')
        self.feature_type = feature_type
        self.n_mfcc = n_mfcc or n_mels
        if feature_type == 'mfcc':
            self.register_buffer('dct', torch.from_numpy(
                dct_basis(n_mels, self.n_mfcc)).to(device))
        self.dither = dither
        self.normalize_features = normalize
        self.has_norm_stats = norm_stats is not None
        if self.has_norm_stats:
            for name, a in zip(('norm_mean', 'norm_std'), norm_stats):
                self.register_buffer(name, torch.as_tensor(
                    np.asarray(a, np.float32)).to(device))
        self.hop = audio_conf.hop_samples
        self.n_fft = n_fft = audio_conf.n_fft
        win_len = audio_conf.window_size_samples

        window = get_window(audio_conf.window, win_len)
        # Centre the window inside the n_fft frame (torch.stft semantics
        # when win_length < n_fft).
        left = (n_fft - win_len) // 2
        padded = np.zeros(n_fft, dtype=np.float32)
        padded[left:left + win_len] = window
        # Windowed real DFT bases: frames @ dft_re == Re rfft(frames * window).
        k = np.arange(n_fft)[:, None]
        f = np.arange(1 + n_fft // 2)[None, :]
        ang = 2.0 * np.pi * k * f / n_fft
        dft_re = (np.cos(ang) * padded[:, None]).astype(np.float32)
        dft_im = (-np.sin(ang) * padded[:, None]).astype(np.float32)
        fb_t = mel_filterbank(audio_conf.sample_rate, n_fft, n_mels).T.copy()

        self.register_buffer('window', torch.from_numpy(padded).to(device))
        self.register_buffer('dft_re', torch.from_numpy(dft_re).to(device))
        self.register_buffer('dft_im', torch.from_numpy(dft_im).to(device))
        self.register_buffer('fb_t', torch.from_numpy(fb_t).to(device))
        self.has_k1_tables = MIN_FFT <= n_fft <= MAX_FFT
        if stft_method == 'pallas':
            check_n_fft(n_fft)
        if self.has_k1_tables:
            tables = build_tables(padded, fb_t)
            for name in ('twiddles', 'bands', 'weights'):
                self.register_buffer(f'k1_{name}',
                                     torch.from_numpy(tables[name]).to(device),
                                     persistent=False)

    def k1_tables(self) -> K1Tables | None:
        """Kernel K1's tables on the module's device (None for an n_fft
        the kernel does not take: the CUDA path then raises)."""
        if not self.has_k1_tables:
            return None
        return K1Tables(self.window, self.k1_twiddles, self.k1_bands,
                        self.k1_weights)

    def frame_lengths(self, sample_lengths: torch.Tensor) -> torch.Tensor:
        return 1 + sample_lengths.to(torch.int32) // self.hop

    def center_pad(self, audio: torch.Tensor,
                   sample_lengths: torch.Tensor) -> torch.Tensor:
        """Reflect-pad each row by n_fft // 2 at its own length:
        ``[B, T]`` -> ``[B, T + n_fft]``. The left edge reflects the row's
        start; samples ``L .. L + pad - 1`` (after the left pad) become the
        reflection of the row about its last valid sample ``L - 1``."""
        B, _ = audio.shape
        pad = self.n_fft // 2
        left = audio[:, 1:pad + 1].flip(1)
        base = torch.cat([left, audio, audio.new_zeros(B, pad)], dim=1)
        L = sample_lengths.to(torch.int64)[:, None]
        p = L + torch.arange(pad, device=audio.device)[None, :]
        period = torch.clamp(2 * L - 2, min=1)
        m = p % period
        # Reflected index, clamped into the row as an out-of-range gather
        # is in JAX (only reachable for an empty row).
        ref_idx = ((L - 1) - (m - (L - 1)).abs()).clamp(min=0)
        right = torch.gather(audio, 1, ref_idx)
        return base.scatter(1, pad + p, right)

    @property
    def feat_dim(self) -> int:
        """Channels of a feature frame: n_mfcc under MFCC, else n_mels."""
        return self.n_mfcc if self.feature_type == 'mfcc' else self.n_mels

    def forward(self, audio: torch.Tensor, sample_lengths: torch.Tensor,
                generator: torch.Generator | None = None):
        """``generator`` enables dithering (training); evaluation passes
        none."""
        feats = self.log_mel(audio, sample_lengths, generator)
        return self.normalize(self.cepstra(feats), sample_lengths)

    def cepstra(self, feats: torch.Tensor) -> torch.Tensor:
        """Under MFCC, the DCT of log-mel ``feats`` [B, F, n_mels] ->
        [B, F, n_mfcc]; the log-mel features themselves otherwise."""
        if self.feature_type != 'mfcc':
            return feats
        return torch.matmul(feats, self.dct)

    def log_mel(self, audio: torch.Tensor, sample_lengths: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Raw log-mel features [B, n_frames, n_mels], before
        normalisation (padding frames not yet zeroed)."""
        padded = self.prepare(audio, sample_lengths, generator)
        return self.mel(padded, num_frames(audio.shape[1], self.hop))

    def mel(self, padded: torch.Tensor, n_frames: int,
            tables: K1Tables | None = None) -> torch.Tensor:
        """K1 over ``n_frames`` frames of ``padded`` [B, P] (``tables``:
        ``k1_tables()``, cached by a caller), or its plain version under
        ``stft_method`` conv / matmul / fft."""
        args = (padded, n_frames, self.hop, self.dft_re, self.dft_im,
                self.fb_t)
        if self.stft_method in PLAIN_METHODS:
            return stft_mel_log_reference(*args)
        return stft_mel_log(*args, self.k1_tables() if tables is None
                            else tables)

    def prepare(self, audio: torch.Tensor, sample_lengths: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """int16 to float (``x / 32768``), dither (with a generator),
        pre-emphasis and centre padding: ``[B, T]`` -> the
        ``[B, T + n_fft]`` input of kernel K1."""
        if not audio.is_floating_point():  # int16 PCM
            # 1/32768 is a power of two: the floats equal the host's
            # int16 / 32768 bit for bit.
            audio = audio.to(torch.float32) * (1.0 / 32768.0)
        else:
            audio = audio.to(torch.float32)
        B, T = audio.shape
        sample_lengths = sample_lengths.to(device=audio.device,
                                           dtype=torch.int32)
        if generator is not None and self.dither > 0:
            valid = (torch.arange(T, device=audio.device)[None, :]
                     < sample_lengths[:, None])
            noise = draw_rows(torch.randn, audio.shape, generator,
                              device=audio.device)
            audio = audio + self.dither * noise * valid

        # Pre-emphasis: x[t] - 0.97 * x[t-1], first sample unchanged.
        audio = torch.cat([audio[:, :1],
                           audio[:, 1:] - PREEMPH * audio[:, :-1]], dim=1)
        return self.center_pad(audio, sample_lengths)

    def normalize(self, feats: torch.Tensor, sample_lengths: torch.Tensor):
        """Per-feature normalisation of raw features ``feats`` (log-mel,
        or MFCC after ``cepstra``) over each
        sample's valid frames (unbiased std), then padding frames zeroed.
        Returns ``(features, frame_lengths)``. With ``norm_stats`` the
        corpus statistics replace the per-utterance ones; with
        ``normalize=False`` the features are only masked."""
        flens = self.frame_lengths(sample_lengths.to(feats.device))
        mask = (torch.arange(feats.shape[1], device=feats.device)[None, :]
                < flens[:, None])
        maskf = mask[:, :, None].to(feats.dtype)
        if not self.normalize_features:
            return feats * maskf, flens
        if self.has_norm_stats:
            feats = (feats - self.norm_mean) / (self.norm_std + NORM_EPS)
            return feats * maskf, flens
        count = torch.clamp(flens, min=1).to(feats.dtype)[:, None, None]
        mean = torch.sum(feats * maskf, dim=1, keepdim=True) / count
        var = torch.sum((feats - mean) ** 2 * maskf, dim=1,
                        keepdim=True) / torch.clamp(count - 1.0, min=1.0)
        feats = (feats - mean) / (torch.sqrt(var) + NORM_EPS)
        return feats * maskf, flens
