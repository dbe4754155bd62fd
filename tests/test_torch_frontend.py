"""Port frontend and kernel K1's plain version vs the JAX package.

The same seeded numpy audio goes through the JAX ``SpectrogramFrontend``
(strided-conv STFT) and the fused Pallas kernel in interpret mode, and
through the port's frontend on the CPU, where ``stft_mel_log`` runs its
plain PyTorch version. Geometries: 16 kHz, 8 kHz (n_fft 256) and a 15 ms
hop (n_fft not a multiple of the hop), with ragged lengths, dither off.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudioConfig
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu.data.features import get_window as jax_window
from wav2letter_pytorch_tpu.data.features import \
    mel_filterbank as jax_filterbank
from wav2letter_pytorch_tpu.ops.stft_pallas import stft_mel_log_pallas
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend,
                                                        get_window,
                                                        mel_filterbank)
from wav2letter_pytorch_tpu_torch.ops.stft_mel import (stft_mel_log,
                                                       stft_mel_log_reference)

torch.set_num_threads(1)

# Raw log-mel: both sides are float32 sums of 512 products in a different
# order; 1e-4 absolute leaves ample room over the ~1e-6 seen.
RAW_TOL = 1e-4
# Normalised features divide by a per-feature std, which can be small and
# amplifies raw differences: 1e-3, as in the JAX frontend's own tests.
NORM_TOL = 1e-3

GEOMETRIES = {
    '16k': dict(sample_rate=16000),
    '8k': dict(sample_rate=8000),
    '16k-hop15ms': dict(sample_rate=16000, window_stride=0.015),
}


def _batch(sr, seed=0):
    """Three rows of half a second (8k: 4000 samples) with ragged lengths,
    zero-padded as the loader pads them."""
    rng = np.random.default_rng(seed)
    n = sr // 2
    t = np.arange(n) / sr
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)[None]
             + 0.1 * rng.standard_normal((3, n))).astype(np.float32)
    lens = np.array([n, 3 * n // 4, n // 3 - 1], np.int32)
    audio[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    return audio, lens


@pytest.mark.parametrize('geometry', sorted(GEOMETRIES))
def test_frontend_matches_jax_conv_path(geometry):
    kw = GEOMETRIES[geometry]
    audio, lens = _batch(kw['sample_rate'])
    ref, ref_lens = JaxFrontend(JaxAudioConfig(**kw), n_mels=64,
                                stft_method='conv', dither=0.0)(audio, lens)
    raw_ref, _ = JaxFrontend(JaxAudioConfig(**kw), n_mels=64,
                             stft_method='conv', dither=0.0,
                             normalize=False)(audio, lens)

    fe = SpectrogramFrontend(AudioConfig(**kw), n_mels=64, dither=0.0)
    a, l = torch.from_numpy(audio), torch.from_numpy(lens)
    with torch.no_grad():
        ours, our_lens = fe(a, l)
        raw = fe.log_mel(a, l)
    mask = (np.arange(raw.shape[1])[None, :]
            < our_lens.numpy()[:, None])[:, :, None]

    np.testing.assert_array_equal(our_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(raw.numpy() * mask, np.asarray(raw_ref),
                               rtol=0, atol=RAW_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=NORM_TOL)


@pytest.mark.parametrize('geometry', sorted(GEOMETRIES))
def test_plain_k1_matches_pallas_kernel_interpret(geometry):
    """Same centre-padded input into the Pallas kernel (interpret mode) and
    the port's plain K1."""
    kw = GEOMETRIES[geometry]
    audio, lens = _batch(kw['sample_rate'], seed=1)
    fe = SpectrogramFrontend(AudioConfig(**kw), n_mels=64, dither=0.0)
    padded = fe.center_pad(torch.from_numpy(audio), torch.from_numpy(lens))
    n_frames = 1 + audio.shape[1] // fe.hop
    ref = stft_mel_log_pallas(jnp.asarray(padded.numpy()), n_frames, fe.hop,
                              fe.n_fft, fe.dft_re.numpy(), fe.dft_im.numpy(),
                              fe.fb_t.numpy(), interpret=True)
    ours = stft_mel_log(padded, n_frames, fe.hop, fe.dft_re, fe.dft_im,
                        fe.fb_t)
    assert ours.shape == (3, n_frames, 64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=RAW_TOL)


def test_plain_k1_float64_oracle():
    """float32 plain K1 against itself in float64 (the oracle the card's
    comparison also uses)."""
    audio, lens = _batch(16000, seed=2)
    fe = SpectrogramFrontend(AudioConfig(), n_mels=64, dither=0.0)
    padded = fe.center_pad(torch.from_numpy(audio), torch.from_numpy(lens))
    nf = 1 + audio.shape[1] // fe.hop
    ours = stft_mel_log(padded, nf, fe.hop, fe.dft_re, fe.dft_im, fe.fb_t)
    oracle = stft_mel_log_reference(padded.double(), nf, fe.hop,
                                    fe.dft_re.double(), fe.dft_im.double(),
                                    fe.fb_t.double())
    np.testing.assert_allclose(ours.numpy(), oracle.numpy(), rtol=0,
                               atol=RAW_TOL)


@pytest.mark.parametrize('length', [1, 2, 100, 255, 256, 257, 4000])
def test_center_pad_reflects_at_each_rows_length(length):
    """Each row is reflect-padded at its own length, as torch.stft
    (center=True, reflect) pads a row cut to that length."""
    rng = np.random.default_rng(length)
    T = 4000
    x = np.zeros((1, T), np.float32)
    x[0, :length] = rng.standard_normal(length)
    fe = SpectrogramFrontend(AudioConfig(), n_mels=64)
    pad = fe.n_fft // 2
    padded = fe.center_pad(torch.from_numpy(x), torch.tensor([length]))
    assert padded.shape == (1, T + 2 * pad)
    if length > pad:
        ref = torch.nn.functional.pad(torch.from_numpy(x[:, :length])[None],
                                      (pad, pad), mode='reflect')[0]
        np.testing.assert_array_equal(padded[:, :length + 2 * pad].numpy(),
                                      ref.numpy())
    # right reflection of a short row wraps like the JAX formula
    L = length
    idx = L + np.arange(pad)
    period = max(2 * L - 2, 1)
    ref_idx = np.maximum((L - 1) - np.abs(idx % period - (L - 1)), 0)
    np.testing.assert_array_equal(padded[0, pad + L:2 * pad + L].numpy(),
                                  x[0, ref_idx])


def test_filterbank_and_window_match_jax():
    for sr, n_fft in ((16000, 512), (8000, 256)):
        np.testing.assert_array_equal(mel_filterbank(sr, n_fft, 64),
                                      jax_filterbank(sr, n_fft, 64))
    for name in ('hamming', 'hann', 'blackman', 'bartlett', 'none'):
        np.testing.assert_array_equal(get_window(name, 320),
                                      jax_window(name, 320))


def test_dither_uses_the_generator():
    audio, lens = _batch(16000)
    fe = SpectrogramFrontend(AudioConfig(), n_mels=64)
    a, l = torch.from_numpy(audio), torch.from_numpy(lens)
    x1, _ = fe(a, l, generator=torch.Generator().manual_seed(3))
    x2, _ = fe(a, l, generator=torch.Generator().manual_seed(3))
    x3, _ = fe(a, l, generator=torch.Generator().manual_seed(4))
    x0, _ = fe(a, l)
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    assert not torch.equal(x1, x3) and not torch.equal(x1, x0)


def test_k1_wrapper_counts_only_kernel_launches():
    fe = SpectrogramFrontend(AudioConfig(), n_mels=64)
    before = stft_mel_log.launches
    x = torch.zeros(1, 16000 + fe.n_fft)
    out = stft_mel_log(x, 101, fe.hop, fe.dft_re, fe.dft_im, fe.fb_t)
    assert out.shape == (1, 101, 64)
    assert stft_mel_log.launches == before  # plain path on the CPU
