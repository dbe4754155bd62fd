"""Kernel K1's host tables and its real-FFT schedule, on the CPU.

The CUDA kernel (``csrc/stft_mel.cu``) runs only on the card. What it
computes is modelled here in numpy float32 with the same tables the
frontend builds: the twiddle table (float64 cos/sin stored as float32),
the Stockham passes (radix 2 first when log2(n_fft/2) is odd, then radix
4), the split step to the real spectrum, and the banded mel. The model is
held against ``np.fft.rfft`` in float64 and, through the banded mel, against
the plain K1 (``stft_mel_log_reference``, the dense DFT).
"""

import numpy as np
import pytest
import torch

from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend,
                                                        mel_filterbank)
from wav2letter_pytorch_tpu_torch.ops.stft_mel import (LOG_ZERO_GUARD,
                                                       build_tables,
                                                       check_n_fft,
                                                       mel_bands,
                                                       stft_mel_log_reference,
                                                       twiddle_table)

torch.set_num_threads(1)

N_FFTS = [64, 128, 256, 512, 1024, 2048, 4096]
MEL_CASES = [(sr, n_mels) for sr in (16000, 8000) for n_mels in (40, 64, 80)]
# The float32 FFT against float64 rfft, max |d| / max |X|: ~1.6e-7 seen at
# 4096 (12 passes of float32 rounding); 1e-6 leaves room.
FFT_RTOL = 1e-6
# Raw log-mel of the model vs the dense-DFT plain version, both float32
# (the frontend tests' tolerance for two float32 orders of the same sums).
RAW_TOL = 1e-4


def complex_fft_model(z: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """The kernel's M-point complex FFT of the rows of ``z`` [F, M]
    (complex64) with the twiddle table ``tw`` [2M, 2]: W_M^m = tw[2m]."""
    F, M = z.shape
    N = 2 * M
    log2_m = M.bit_length() - 1
    radices = [2] * (log2_m % 2) + [4] * (log2_m // 2)
    x = z.astype(np.complex64)
    p = 1
    for R in radices:
        i = np.arange(M // R)
        k = i & (p - 1)
        u = [x[:, i + r * (M // R)] for r in range(R)]
        for r in range(1, R):
            idx = r * k * (N // (R * p))
            w = (tw[idx, 0] - 1j * tw[idx, 1]).astype(np.complex64)
            u[r] = (u[r] * w).astype(np.complex64)
        if R == 2:
            v = [u[0] + u[1], u[0] - u[1]]
        else:
            a0, a1 = u[0] + u[2], u[0] - u[2]
            a2, a3 = u[1] + u[3], u[1] - u[3]
            v = [a0 + a2, a1 - 1j * a3, a0 - a2, a1 + 1j * a3]
        y = np.empty_like(x)
        j = (i - k) * R + k
        for r in range(R):
            y[:, j + r * p] = v[r]
        x, p = y, p * R
    return x


def rfft_model(frames: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """Real spectrum [F, n_fft/2 + 1] of float32 ``frames`` [F, n_fft]:
    z[n] = x[2n] + i x[2n+1], the complex FFT, then the split step."""
    M = frames.shape[1] // 2
    Z = complex_fft_model(frames[:, 0::2] + 1j * frames[:, 1::2], tw)
    k = np.arange(M + 1)
    zk, zc = Z[:, k % M], np.conj(Z[:, (M - k) % M])
    w = (tw[k, 0] - 1j * tw[k, 1]).astype(np.complex64)
    return (0.5 * (zk + zc) - 0.5j * w * (zk - zc)).astype(np.complex64)


def banded_mel_log(power: np.ndarray, bands: np.ndarray,
                   weights: np.ndarray) -> np.ndarray:
    """The kernel's banded mel and log of ``power`` [..., n_bins]."""
    mel = np.zeros(power.shape[:-1] + (len(bands),), np.float32)
    for m, (first, count, off) in enumerate(bands):
        band = slice(first, first + count)
        mel[..., m] = power[..., band] @ weights[off:off + count]
    return np.log1p(mel + np.float32(LOG_ZERO_GUARD))


@pytest.mark.parametrize('n_fft', N_FFTS)
def test_fft_model_matches_rfft(n_fft):
    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((3, n_fft)).astype(np.float32)
    tw = twiddle_table(n_fft)
    got = rfft_model(frames, tw)
    ref = np.fft.rfft(frames.astype(np.float64), axis=1)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < FFT_RTOL, err


def test_twiddles_are_float64_cos_sin_rounded():
    tw = twiddle_table(512)
    ang = 2 * np.pi * np.arange(512) / 512
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], np.sin(ang).astype(np.float32))


@pytest.mark.parametrize('sr,n_mels', MEL_CASES)
def test_band_table_rebuilds_the_filterbank(sr, n_mels):
    n_fft = AudioConfig(sample_rate=sr).n_fft
    fb_t = mel_filterbank(sr, n_fft, n_mels).T.copy()
    bands, weights = mel_bands(fb_t)
    dense = np.zeros_like(fb_t)
    for m, (first, count, off) in enumerate(bands):
        dense[first:first + count, m] = weights[off:off + count]
        nz = np.flatnonzero(fb_t[:, m])
        if nz.size:  # the band covers the filter's whole support
            assert first <= nz[0] and nz[-1] < first + count
        else:
            assert count == 0
    np.testing.assert_array_equal(dense, fb_t)
    assert weights.size == bands[:, 1].sum()
    assert (np.diff(bands[:, 2]) == bands[:-1, 1]).all()


@pytest.mark.parametrize('sr,n_mels', MEL_CASES)
def test_banded_fft_mel_matches_plain_k1(sr, n_mels):
    conf = AudioConfig(sample_rate=sr)
    fe = SpectrogramFrontend(conf, n_mels=n_mels, dither=0.0)
    rng = np.random.default_rng(sr + n_mels)
    T = sr // 4
    t = np.arange(T) / sr
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)[None]
             + 0.1 * rng.standard_normal((2, T))).astype(np.float32)
    lens = np.array([T, T // 2], np.int32)
    audio[1, lens[1]:] = 0.0
    padded = fe.prepare(torch.from_numpy(audio), torch.from_numpy(lens))
    nf = 1 + T // fe.hop
    ref = stft_mel_log_reference(padded, nf, fe.hop, fe.dft_re, fe.dft_im,
                                 fe.fb_t).numpy()

    tables = fe.k1_tables()
    frames = padded.unfold(1, fe.n_fft, fe.hop)[:, :nf].numpy()
    frames = frames * tables.window.numpy()
    spec = rfft_model(frames.reshape(-1, fe.n_fft), tables.twiddles.numpy())
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    got = banded_mel_log(power, tables.bands.numpy(),
                         tables.weights.numpy()).reshape(ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RAW_TOL)


@pytest.mark.parametrize('n_fft', [32, 320, 8192])
def test_unsupported_n_fft_raises(n_fft):
    with pytest.raises(ValueError, match='n_fft'):
        check_n_fft(n_fft)
    window = np.ones(n_fft, np.float32)
    fb_t = np.zeros((1 + n_fft // 2, 8), np.float32)
    with pytest.raises(ValueError, match='n_fft'):
        build_tables(window, fb_t)


def test_frontend_builds_tables_only_for_kernel_sizes():
    fe = SpectrogramFrontend(AudioConfig(window_size=0.5))  # n_fft 8192
    assert fe.n_fft == 8192 and fe.k1_tables() is None
    fe = SpectrogramFrontend(AudioConfig())
    tables = fe.k1_tables()
    assert tables.twiddles.shape == (512, 2)
    assert tables.bands.dtype == torch.int32
    # The tables are not part of the saved state.
    assert set(fe.state_dict()) == {'window', 'dft_re', 'dft_im', 'fb_t'}
