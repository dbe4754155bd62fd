"""The port's serving forward (BN fold, int8 weights, int8 activations,
batched inference, CMVN frontend) vs the JAX package's ``serving``.

The model is the JAX serving tests' small Wav2Letter (``tests/
test_streaming.py::SMALL_LAYERS``: 3 layers of width 12 over 8 mel bands,
a stride-2 entry and a dilated layer, BatchNorm statistics perturbed so the
fold does work), carried across with ``weights.state_dict_from_flax``.
Inputs come from seeded numpy; the port runs on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_streaming import N_MELS, SMALL_LAYERS, _build
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu.decoding import GreedyDecoder as JaxGreedy
from wav2letter_pytorch_tpu.models.base import same_pad_amount
from wav2letter_pytorch_tpu.serving import infer as jinfer
from wav2letter_pytorch_tpu_torch import serving
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.models.wav2letter import Wav2Letter
from wav2letter_pytorch_tpu_torch.serving import infer
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

# Float32 convs in another summation order: log-probs agree to ~3e-7.
LOGP_TOL = 1e-4
# int8 activations: the int32 sums equal JAX's and the scales divide as
# JAX's do, so only the float32 steps between layers may round apart
# (~2.4e-7 seen). A single int8 rounding flip would show as ~1e-2 and fail.
Q8_TOL = 1e-5
LABELS = list('_abcde ')
CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def small():
    """(JAX variables as numpy, the port's model, the port's state dict)."""
    _, variables, _ = _build(SMALL_LAYERS)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    sd = state_dict_from_flax(variables)
    model = Wav2Letter(len(LABELS), input_size=N_MELS, layers=SMALL_LAYERS,
                       mid_layers=len(SMALL_LAYERS))
    model.load_state_dict(sd, strict=True)
    return variables, model.eval(), sd


def _feats(T=301, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, T, N_MELS)).astype(np.float32)
    lens = np.array([T, T - 51], np.int32)
    feats[1, T - 51:] = 0.0
    return feats, lens


def _audio(lengths, seed=1):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((len(lengths), max(lengths))) * 0.1) \
        .astype(np.float32)
    for b, L in enumerate(lengths):
        audio[b, L:] = 0.0
    return audio, np.asarray(lengths, np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_q8(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert d.max() <= Q8_TOL, d.max()


def test_fold_and_quantize_bit_equal(small):
    variables, model, sd = small
    want = jserve.fold_batchnorm(variables, len(SMALL_LAYERS))
    for got in (serving.fold_batchnorm(model, len(SMALL_LAYERS)),
                serving.fold_batchnorm(sd)):
        assert len(got) == len(want) == 4
        for (gw, gb), (ww, wb) in zip(got, want):
            assert gw.dtype == ww.dtype == np.float32
            np.testing.assert_array_equal(gw, ww)
            np.testing.assert_array_equal(gb, wb)
    q_got = serving.quantize_folded(got)
    q_want = jserve.quantize_folded(want)
    for g, w in zip(q_got, q_want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert serving.quantized_bytes(q_got) == jserve.quantized_bytes(q_want)
    with pytest.raises(ValueError, match='blocks'):
        serving.fold_batchnorm(sd, 2)


@pytest.mark.parametrize('T', [301, 300])
@pytest.mark.parametrize('padding_mode', ['reflect', 'zeros'])
@pytest.mark.parametrize('weights', ['f32', 'int8'])
def test_offline_forward_matches_jax(small, T, padding_mode, weights):
    variables, _, sd = small
    folded = jserve.fold_batchnorm(variables, len(SMALL_LAYERS))
    if weights == 'int8':
        folded = jserve.quantize_folded(folded)
    feats, lens = _feats(T)
    want, want_lens = jserve.offline_forward(SMALL_LAYERS, folded, feats,
                                             lens, padding_mode=padding_mode)
    for w in (folded, infer.to_device(folded, CPU)):
        got, got_lens = serving.offline_forward(
            SMALL_LAYERS, w, _t(feats), _t(lens), padding_mode=padding_mode)
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGP_TOL, rtol=0)


def test_offline_forward_is_the_model_in_eval_mode(small):
    _, model, _ = small
    feats, lens = _feats(300)
    with torch.no_grad():
        want, want_lens = model(_t(feats), _t(lens))
        got, got_lens, acts = serving.offline_forward(
            SMALL_LAYERS, serving.fold_batchnorm(model), _t(feats), _t(lens),
            return_activations=True)
    assert torch.equal(got_lens, want_lens)
    torch.testing.assert_close(got, want, atol=LOGP_TOL, rtol=0)
    assert [tuple(a.shape) for a in acts] == [
        (2, 300, N_MELS), (2, 150, 12), (2, 150, 12), (2, 150, 12)]


@pytest.mark.parametrize('padding_mode', ['reflect', 'zeros'])
@pytest.mark.parametrize('static', [False, True])
def test_q8_first_layer_accumulators_equal_jax(small, padding_mode, static):
    """Same int8 input, same int8 weights: the int32 sums are exact, so
    the port's im2col x torch._int_mm equals JAX's integer convolution."""
    variables, _, _ = small
    q0 = jserve.quantize_folded(
        jserve.fold_batchnorm(variables, len(SMALL_LAYERS)))[0][0]
    k, s, d = 7, 2, 1
    feats, lens = _feats(301)
    scales = [0.03] if static else None
    j_scale = jinfer._act_scale(jnp.asarray(feats), scales, 0,
                                jnp.asarray(lens))
    j_xq = jinfer.quantize_act(jnp.asarray(feats), j_scale)
    left, right = same_pad_amount(301, k, s, d)
    j_xq = jnp.pad(j_xq, ((0, 0), (left, right), (0, 0)),
                   mode='reflect' if padding_mode == 'reflect'
                   else 'constant')
    want = jax.lax.conv_general_dilated(
        j_xq, jnp.asarray(q0), window_strides=(s,), padding='VALID',
        rhs_dilation=(d,), dimension_numbers=('NWC', 'WIO', 'NWC'),
        preferred_element_type=jnp.int32)
    p_scale = infer._act_scale(_t(feats), scales, 0, _t(lens))
    np.testing.assert_array_equal(p_scale.numpy(), np.asarray(j_scale))
    p_xq = infer.quantize_act(_t(feats), p_scale)
    for q in (_t(q0), infer.to_device([(q0, np.ones(12, np.float32), None)],
                                      CPU)[0][0]):
        got = infer.conv_q8(p_xq, q, s, d, padding_mode)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('static', [False, True])
@pytest.mark.parametrize('f32_layers', [(), (0, 'head')])
def test_q8_forward_matches_jax(small, static, f32_layers):
    variables, _, _ = small
    folded = jserve.fold_batchnorm(variables, len(SMALL_LAYERS))
    folded_q = jserve.quantize_folded(folded)
    feats, lens = _feats(301)
    scales = None
    if static:
        audio, alens = _audio([24000, 20000], seed=7)
        scales = serving.calibrate_activation_scales(
            SMALL_LAYERS, folded,
            SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0),
            audio, alens)
    want, want_lens = jserve.offline_forward_q8(
        SMALL_LAYERS, folded_q, feats, lens, act_scales=scales,
        f32_layers=f32_layers)
    got, got_lens = serving.offline_forward_q8(
        SMALL_LAYERS, infer.to_device(folded_q, CPU), _t(feats), _t(lens),
        act_scales=scales, f32_layers=f32_layers)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    _close_q8(got.numpy(), want)
    sizes = got_lens.numpy()
    assert GreedyDecoder(LABELS).decode(got.numpy(), sizes) == \
        JaxGreedy(LABELS).decode(np.asarray(want), sizes)


def test_int_mm_pads_to_the_card_shapes():
    rng = np.random.default_rng(3)
    for m, k, n in ((3, 60, 29), (40, 704, 256), (17, 8, 8)):
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
        got = infer.int_mm(_t(a), _t(b))
        np.testing.assert_array_equal(
            got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    # An im2col of one row at dilation 1 reshapes to a view whose rows
    # overlap (row stride 16 < 64 columns).
    x = _t(rng.integers(-127, 128, (1, 80, 16)).astype(np.int8))
    cols = x.unfold(1, 4, 1).transpose(2, 3).reshape(77, 64)
    assert not cols.is_contiguous()
    b = rng.integers(-127, 128, (64, 24)).astype(np.int8)
    np.testing.assert_array_equal(
        infer.int_mm(cols, _t(b)).numpy(),
        cols.numpy().astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize('mode', ['f32', 'int8', 'int8_full'])
def test_mesh_inference_matches_jax(small, mode):
    """B=8 (the JAX tests' 8 host devices): the frontend and the folded
    stack in one call, against JAX's MeshInference on the same audio."""
    variables, _, _ = small
    folded = jserve.fold_batchnorm(variables, len(SMALL_LAYERS))
    if mode != 'f32':
        folded = jserve.quantize_folded(folded)
    T = 24000
    audio, lens = _audio([T, T - 1000, T - 2000, T - 3000] * 2)
    jmi = jserve.MeshInference(SMALL_LAYERS, folded,
                               JaxFrontend(JaxAudio(), n_mels=N_MELS,
                                           dither=0.0), mode=mode)
    want, want_lens = jmi.logprobs(audio, lens)
    mi = serving.MeshInference(
        SMALL_LAYERS, folded,
        SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0),
        mode=mode, device='cpu')
    got, got_lens = mi.logprobs(audio, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    if mode == 'int8_full':
        _close_q8(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=LOGP_TOL, rtol=0)
    assert mi.transcribe(audio, lens, GreedyDecoder(LABELS)) == \
        jmi.transcribe(audio, lens, JaxGreedy(LABELS))


def test_mesh_inference_errors(small):
    variables, _, _ = small
    folded = jserve.fold_batchnorm(variables, len(SMALL_LAYERS))
    fe = SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0)
    with pytest.raises(ValueError, match='int8_full'):
        serving.MeshInference(SMALL_LAYERS, folded, fe, mode='int8_full',
                              device='cpu')
    with pytest.raises(ValueError, match='unknown mode'):
        serving.MeshInference(SMALL_LAYERS, folded, fe, mode='bf16',
                              device='cpu')


def test_cmvn_and_raw_frontends_match_jax():
    """``norm_stats`` (fixed CMVN) and ``normalize=False`` (raw, masked)
    against the JAX frontend; the per-utterance default is unchanged."""
    rng = np.random.default_rng(4)
    stats = (rng.standard_normal(N_MELS).astype(np.float32),
             rng.uniform(0.5, 2.0, N_MELS).astype(np.float32))
    audio, lens = _audio([16000, 12345], seed=5)
    for kw in ({'norm_stats': stats}, {'normalize': False}, {}):
        want, want_lens = JaxFrontend(JaxAudio(), n_mels=N_MELS, dither=0.0,
                                      stft_method='conv', **kw)(audio, lens)
        fe = SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0,
                                 **kw)
        got, got_lens = fe(_t(audio), _t(lens))
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-3, rtol=0)
        pad = got.numpy()[1, int(got_lens[1]):]
        assert pad.size and not pad.any()
