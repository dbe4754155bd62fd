"""bf16 compute (``model.compute_dtype=bf16``) of the port against the JAX
package's, on the CPU.

The JAX package's bf16 mode keeps parameters, optimizer state, BatchNorm
statistics and gradients in float32 and rounds only the convs' inputs,
weights and outputs through bfloat16 (flax ``nn.Conv(dtype=bfloat16)``;
the Pallas kernels' "bf16 in -> bf16 out, f32 accumulate"). Here the same
seeded numpy inputs go through both sides:

* K4 (forward and input gradient), K5, K6 and K7 at bf16 x: the port's
  plain versions (what the kernels are held to on the card) and its
  autograd Functions against ``depthwise_conv1d`` / ``sep_conv1d`` in
  interpret mode on the same bf16 inputs. A bf16 output must equal JAX's
  or be one bf16 ulp from it (the float32 sums behind it are taken in
  other orders, and a sum that lands near a rounding boundary may round
  the other way); a float32 output must pass the f32 tests' gates.
* Wav2Letter (``reflect`` and ``zeros``) and the narrowed QuartzNet (the
  JAX Pallas branches, interpret mode) in bf16, eval and train mode:
  log-probs and BatchNorm statistics, and the port at least 10x closer to
  JAX's bf16 than JAX's bf16 is to JAX's f32, in mean absolute difference
  (the roundings sit where JAX's do: the port's float32 model, the
  control, sits exactly as far as JAX's f32, a factor of 1.0).
* One train step from the same weights against the JAX trainer in bf16
  (SGD for Wav2Letter, NovoGrad for QuartzNet), and the bf16 training of
  ``tests/test_bf16.py`` (final loss within 30 % of f32's).
* The config (bf16 accepted, parameters float32), ``padding_mode=zeros``
  in float32, and ``train.main`` then ``evaluate.main`` on a bf16 run
  with ``--cpu``.
* The gates of bf16 under data, tensor and sequence parallelism
  (``assert_parallel_bf16``), which ``tests/test_torch_parallel.py``,
  ``test_torch_tensor_parallel.py`` and ``test_torch_seq_parallel.py``
  hold their gloo ranks to.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import wav2letter_pytorch_tpu.ops.depthwise_pallas as jax_dwp
import wav2letter_pytorch_tpu.ops.sep_conv_pallas as jax_scp
from wav2letter_pytorch_tpu.config import load_config as jax_load_config
from wav2letter_pytorch_tpu.models import Jasper as JaxJasper
from wav2letter_pytorch_tpu.models import Wav2Letter as JaxWav2Letter
from wav2letter_pytorch_tpu.training import Trainer as JaxTrainer
from wav2letter_pytorch_tpu.training import build as jax_build
from wav2letter_pytorch_tpu_torch import evaluate as port_eval
from wav2letter_pytorch_tpu_torch import train as train_cli
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.evaluate import make_loader
from wav2letter_pytorch_tpu_torch.models.base import get_same_padding
from wav2letter_pytorch_tpu_torch.models.jasper import Jasper
from wav2letter_pytorch_tpu_torch.models.wav2letter import Wav2Letter
from wav2letter_pytorch_tpu_torch.ops.depthwise import (
    depthwise_conv1d, depthwise_fwd_reference, depthwise_wgrad_reference,
    out_length as dw_out_length)
from wav2letter_pytorch_tpu_torch.ops.sep_conv import (
    mask_lengths, out_length as sep_out_length, sep_bwd_reference,
    sep_conv1d, sep_fwd_reference)
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_labels,
                                                         build_model,
                                                         build_optimizer,
                                                         load_run)
from wav2letter_pytorch_tpu_torch.training.checkpoint import Checkpointer
from wav2letter_pytorch_tpu_torch.training.trainer import (Trainer,
                                                           masked_ctc_mean,
                                                           to_device)
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax
from tests.test_models import W2L_LAYERS
from tests.test_torch_jasper import (QUARTZNET_NARROW, _pallas_interpret,
                                     _variables as jasper_variables)
from tests.test_torch_model import LAYERS as W2L_NARROW
from tests.test_torch_model import _flax_variables as w2l_variables

torch.set_num_threads(1)

BF16 = torch.bfloat16
F_IN, N_LABELS = 16, 29
# bf16 outputs: JAX's to the bit or one bf16 ulp off (float32 sums in
# other orders on each side, then one rounding).
MAX_ULPS = 1
# float32 outputs of the bf16 kernels: the f32 tests' gates
# (tests/test_torch_depthwise.py, tests/test_torch_sep_conv.py).
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# depthwise: (B, T, C, K, stride, dilation); C = 12 and 13 are not
# multiples of 8 (the kernels' one-element copies of bf16)
DW_CASES = [(2, 40, 16, 7, 1, 1), (2, 41, 16, 7, 2, 1), (2, 40, 16, 5, 1, 2),
            (2, 33, 12, 5, 1, 1), (1, 30, 13, 4, 2, 1)]
# separable unit: (B, T, Cin, Cout, K, dilation)
SEP_CASES = [(2, 40, 16, 24, 7, 1), (2, 40, 12, 16, 5, 2),
             (1, 30, 16, 8, 6, 1)]


def bf16_values(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (to nearest even), as float32."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))


def ulps(a, b) -> np.ndarray:
    """|a - b| in bfloat16 ulps; a and b hold bfloat16 values (float32
    arrays or bf16 tensors)."""
    def ordered(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().float().numpy()
        v = np.asarray(v, np.float32)
        bits = v.view(np.uint32)
        assert not (bits & 0xFFFF).any(), 'not a bfloat16 value'
        b16 = (bits >> 16).astype(np.int64)
        mag = b16 & 0x7FFF
        return np.where(b16 >> 15, -mag, mag)
    return np.abs(ordered(a) - ordered(b))


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# ------------------------------------------------------------- K4 and K5


def _dw_inputs(B, T, C, K, s, d, seed):
    rng = np.random.default_rng(seed)
    p = get_same_padding(K, s, d)
    t_out = dw_out_length(T, K, s, d, p)
    x = bf16_values(rng.standard_normal((B, T, C)))
    w = bf16_values(0.3 * rng.standard_normal((K, C)))
    g = bf16_values(rng.standard_normal((B, t_out, C)))
    return x, w, g, p


@pytest.mark.parametrize('B,T,C,K,s,d', DW_CASES)
def test_k4_k5_bf16_match_jax_pallas(B, T, C, K, s, d):
    """K4 forward and input gradient (bf16) and K5 (float32, then rounded
    to bf16 as ``dw.astype(w.dtype)``), plain and through
    ``DepthwiseConv1d``, against the Pallas kernels in interpret mode."""
    x, w, g, p = _dw_inputs(B, T, C, K, s, d, 0)
    jx, jw, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))
    jy, vjp = jax.vjp(lambda a, b: jax_dwp.depthwise_conv1d(
        a, b, s, d, p, interpret=True), jx, jw)
    jdx, jdw = vjp(jg)
    assert jy.dtype == jdx.dtype == jdw.dtype == jnp.bfloat16
    jdw32 = jax_dwp._dw_pallas_wgrad(jx, jg, K, s, d, p, True)
    assert jdw32.dtype == jnp.float32

    tx, tw, tg = (torch.from_numpy(a).to(BF16) for a in (x, w, g))
    y = depthwise_fwd_reference(tx, tw, s, d, p)
    assert y.dtype == BF16
    assert ulps(y, jy).max() <= MAX_ULPS
    dw32 = depthwise_wgrad_reference(tx, tg, K, s, d, p)
    assert dw32.dtype == torch.float32
    np.testing.assert_allclose(dw32.numpy(), to_np(jdw32), rtol=0,
                               atol=GRAD_TOL)

    xa, wa = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    ya = depthwise_conv1d(xa, wa, s, d, p)
    ya.backward(tg)
    assert xa.grad.dtype == wa.grad.dtype == BF16
    assert ulps(ya, jy).max() <= MAX_ULPS
    assert ulps(xa.grad, jdx).max() <= MAX_ULPS
    assert ulps(wa.grad, jdw).max() <= MAX_ULPS


def test_k4_in_bf16_moves_away_from_f32():
    """The bf16 output is a rounding of the float32 sum, not the float32
    sum itself: the plain version rounds where the kernel does."""
    x, w, _, p = _dw_inputs(2, 40, 16, 7, 1, 1, 3)
    y32 = depthwise_fwd_reference(torch.from_numpy(x), torch.from_numpy(w),
                                  1, 1, p)
    y16 = depthwise_fwd_reference(torch.from_numpy(x).to(BF16),
                                  torch.from_numpy(w).to(BF16), 1, 1, p)
    assert torch.equal(y16, y32.to(BF16))
    assert not torch.equal(y16.float(), y32)


# ------------------------------------------------------------- K6 and K7


def _sep_inputs(B, T, Cin, Cout, K, d, seed):
    rng = np.random.default_rng(seed)
    p = get_same_padding(K, 1, d)
    x = bf16_values(rng.standard_normal((B, T, Cin)))
    wdw = (rng.standard_normal((K, Cin)) * 0.1).astype(np.float32)
    wpw = (rng.standard_normal((Cin, Cout)) * 0.2).astype(np.float32)
    lens = (rng.integers(T // 2, T, size=B) + 0.5).astype(np.float32)
    g = rng.standard_normal((B, sep_out_length(T, K, d, p), Cout)).astype(
        np.float32)
    return x, wdw, wpw, lens, g, p


@pytest.mark.parametrize('use_mask', [True, False])
@pytest.mark.parametrize('B,T,Cin,Cout,K,d', SEP_CASES)
def test_k6_k7_bf16_x_match_jax_pallas(B, T, Cin, Cout, K, d, use_mask):
    """K6 reads bf16 x (y float32); K7 gives dx in bf16 and dwdw, dwpw in
    float32: the plain versions and ``SepConv1d`` against ``sep_conv1d`` in
    interpret mode on the same bf16 x."""
    x, wdw, wpw, lens, g, p = _sep_inputs(B, T, Cin, Cout, K, d, 1)
    jl = jnp.asarray(lens) if use_mask else None
    jy, vjp = jax.vjp(lambda a, b, c: jax_scp.sep_conv1d(
        a, jl, b, c, d, p, use_mask, interpret=True),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wdw), jnp.asarray(wpw))
    jdx, jdwdw, jdwpw = vjp(jnp.asarray(g))
    assert jy.dtype == jnp.float32 and jdx.dtype == jnp.bfloat16

    tx = torch.from_numpy(x).to(BF16)
    tl = torch.from_numpy(lens) if use_mask else None
    len1, len2 = (mask_lengths(tl, K, d, p) if use_mask else (None, None))
    tw = [torch.from_numpy(a) for a in (wdw, wpw)]
    y = sep_fwd_reference(tx, len1, len2, *tw, d, p)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), to_np(jy), rtol=0, atol=FWD_TOL)
    dx, dwdw, dwpw = sep_bwd_reference(tx, len1, len2, *tw,
                                       torch.from_numpy(g), d, p)
    assert dx.dtype == BF16 and dwdw.dtype == dwpw.dtype == torch.float32
    assert ulps(dx, jdx).max() <= MAX_ULPS
    for got, ref in ((dwdw, jdwdw), (dwpw, jdwpw)):
        np.testing.assert_allclose(got.numpy(), to_np(ref), rtol=0,
                                   atol=GRAD_TOL)

    xa = tx.clone().requires_grad_()
    wa = [t.clone().requires_grad_() for t in tw]
    ya = sep_conv1d(xa, tl, *wa, d, p, use_mask=use_mask)
    ya.backward(torch.from_numpy(g))
    assert xa.grad.dtype == BF16
    assert ulps(xa.grad, jdx).max() <= MAX_ULPS
    for got, ref in zip([t.grad for t in wa], (jdwdw, jdwpw)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), to_np(ref), rtol=0,
                                   atol=GRAD_TOL)


# ---------------------------------------------------------------- models

# Log-probs / probabilities of the narrow models in bf16, port vs JAX.
# The roundings are the same, but an activation a float32 ulp apart
# (eval-mode BatchNorm: ATen folds (x - mean) * invstd * w + b otherwise
# than flax) now and then rounds to the neighbouring bf16 value, and that
# moves what follows by about a bf16 ulp (2^-8 relative): measured 4.0e-3
# (W2L eval), 1.9e-7 (W2L train), 1.1e-8 / 4.8e-7 (QuartzNet eval / train);
# JAX's own bf16 sits 5.9e-3 (W2L eval) and 5.3e-5 / 7.3e-2 (QuartzNet)
# from its f32.
BF16_ATOL = 2e-2
STATS_BF16_ATOL = 2e-2     # new running mean / var of train mode
# Mean |port bf16 - JAX bf16| at least this many times below mean |JAX
# bf16 - JAX f32|. Measured: W2L eval 33.1x (reflect) / 22.1x (zeros),
# train 4.0e4x / 3.6e4x; QuartzNet eval 2.3e3x, train 7.1e4x; the port's
# float32 model, the control, 1.0x.
CLOSER = 10.0
# the narrow Wav2Letter without dropout (train mode draws no masks)
W2L_LAYERS_NO_DROPOUT = [dict(layer, dropout=-1.0) for layer in W2L_NARROW]


def _w2l_pair(padding_mode, dtype, variables):
    jm = JaxWav2Letter(layers=W2L_LAYERS_NO_DROPOUT, num_labels=N_LABELS,
                       mid_layers=3, precision='highest',
                       padding_mode=padding_mode,
                       dtype=None if dtype is None else jnp.bfloat16)
    pm = Wav2Letter(N_LABELS, input_size=F_IN, layers=W2L_LAYERS_NO_DROPOUT,
                    mid_layers=3, padding_mode=padding_mode,
                    compute_dtype=dtype)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, pm


def _closeness(port, jax16, jax32) -> float:
    """How many times closer ``port`` is to JAX's bf16 output than JAX's
    bf16 is to JAX's f32, in mean absolute difference."""
    near = float(np.abs(port - jax16).mean())
    far = float(np.abs(jax16 - jax32).mean())
    return far / max(near, 1e-30)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('padding_mode', ['reflect', 'zeros'])
def test_wav2letter_bf16_matches_flax(padding_mode, train):
    _, variables = w2l_variables()
    rng = np.random.default_rng(11)
    T = 40
    x = rng.standard_normal((3, T, F_IN)).astype(np.float32)
    lens = np.array([T, 31, 22], np.int32)
    jm16, pm16 = _w2l_pair(padding_mode, BF16, variables)
    jm32, pm32 = _w2l_pair(padding_mode, None, variables)
    assert all(p.dtype == torch.float32 for p in pm16.parameters())
    pm16.train(train)
    out, out_lens = pm16(torch.from_numpy(x), torch.from_numpy(lens))
    control, _ = pm32.train(train)(torch.from_numpy(x),
                                   torch.from_numpy(lens))
    assert out.dtype == torch.float32
    apply = dict(train=train, mutable=['batch_stats'] if train else False)
    r16 = jm16.apply(variables, jnp.asarray(x), jnp.asarray(lens), **apply)
    r32 = jm32.apply(variables, jnp.asarray(x), jnp.asarray(lens), **apply)
    (ref16, ref_lens), (ref32, _) = ((r16[0], r32[0]) if train
                                     else (r16, r32))
    got, j16, j32 = to_np(out), to_np(ref16), to_np(ref32)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got, j16, rtol=0, atol=BF16_ATOL)
    assert _closeness(got, j16, j32) >= CLOSER
    assert _closeness(to_np(control), j16, j32) < 2.0
    if train:
        theirs = state_dict_from_flax({'params': variables['params'],
                                       'batch_stats': jax.device_get(
                                           r16[1]['batch_stats'])})
        ours = pm16.state_dict()
        for k in ours:
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(ours[k].numpy(),
                                           theirs[k].numpy(), rtol=0,
                                           atol=STATS_BF16_ATOL, err_msg=k)


@pytest.mark.parametrize('T', [40, 37])
def test_wav2letter_zero_padding_f32_matches_flax(T):
    """``padding_mode=zeros`` in float32 (the conv's own padding when the
    SAME pad is symmetric, ``F.pad`` otherwise) against flax's."""
    _, variables = w2l_variables()
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, F_IN)).astype(np.float32)
    lens = np.array([T, T - 9], np.int32)
    jm, pm = _w2l_pair('zeros', None, variables)
    ref, _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                      train=False)
    refl, _ = _w2l_pair('reflect', None, variables)[0].apply(
        variables, jnp.asarray(x), jnp.asarray(lens), train=False)
    with torch.no_grad():
        ours, _ = pm.eval()(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    assert np.abs(np.asarray(ref) - np.asarray(refl)).max() > 1e-2


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_quartznet_bf16_matches_flax_pallas(train, monkeypatch):
    """The narrowed QuartzNet through the JAX Pallas branches (K4 for the
    strided C1, K6/K7 for every other separable unit) in bf16."""
    blocks = QUARTZNET_NARROW
    _, variables = jasper_variables(blocks)
    _pallas_interpret(monkeypatch)
    rng = np.random.default_rng(7)
    T = 64
    x = rng.standard_normal((3, T, F_IN)).astype(np.float32)
    lens = np.array([T, 50, 37], np.int32)
    outs = {}
    for name, dtype in (('16', jnp.bfloat16), ('32', None)):
        jm = JaxJasper(jasper_blocks=blocks, num_labels=N_LABELS,
                       mid_layers=len(blocks), precision='highest',
                       dtype=dtype)
        outs[name] = jm.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                              train=train,
                              mutable=['batch_stats'] if train else False)
    models = {}
    for name, dtype in (('16', BF16), ('32', None)):
        models[name] = Jasper(blocks, N_LABELS, input_size=F_IN,
                              mid_layers=len(blocks), compute_dtype=dtype)
        models[name].load_state_dict(
            state_dict_from_flax(variables, blocks), strict=True)
        models[name].train(train)
    model = models['16']
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out, out_lens = model(torch.from_numpy(x), torch.from_numpy(lens))
    control, _ = models['32'](torch.from_numpy(x), torch.from_numpy(lens))
    ref16, ref32 = ((outs['16'][0], outs['32'][0]) if train
                    else (outs['16'], outs['32']))
    got, j16, j32 = to_np(out), to_np(ref16[0]), to_np(ref32[0])
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref16[1]))
    np.testing.assert_allclose(got, j16, rtol=0, atol=BF16_ATOL)
    assert _closeness(got, j16, j32) >= CLOSER
    assert _closeness(to_np(control), j16, j32) < 2.0
    if train:
        theirs = state_dict_from_flax(
            {'params': variables['params'],
             'batch_stats': jax.device_get(outs['16'][1]['batch_stats'])},
            blocks)
        ours = model.state_dict()
        for k in ours:
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(ours[k].numpy(),
                                           theirs[k].numpy(), rtol=0,
                                           atol=STATS_BF16_ATOL, err_msg=k)


# bf16's drift from f32 at full depth (Wav2Letter-20, QuartzNet-15x5 at
# 1/8 width; B=2, 100 frames, train mode on the batch statistics): far
# past tests/test_bf16.py's 0.15 at 2 layers, for JAX itself (its default
# XLA path) as for the port. Measured means: JAX 0.149 / port 0.150
# (Wav2Letter-20), JAX 0.766 / port 0.737 (QuartzNet-15x5); maxima 0.81 /
# 0.83 and 4.1 / 3.2. chip_smoke.py's full-depth gates on the card are
# twice JAX's means. The port's mean must lie within a factor of 1.5 of
# JAX's either way.
DRIFT_FACTOR = 1.5


@pytest.mark.parametrize('name', ['wav2letter', 'quartznet'])
def test_bf16_drift_at_full_depth_matches_jax(name):
    from wav2letter_pytorch_tpu_torch.config import QUARTZNET_MODEL
    from wav2letter_pytorch_tpu_torch.models.wav2letter import \
        WAV2LETTER_LAYERS
    rng = np.random.default_rng(0)
    T = 100
    x = rng.standard_normal((2, T, 64)).astype(np.float32)
    lens = np.array([T, T], np.int32)
    if name == 'wav2letter':
        spec = [dict(l, dropout=-1.0, output_size=l['output_size'] // 8)
                for l in WAV2LETTER_LAYERS]

        def jax_model(dtype):
            return JaxWav2Letter(layers=spec, num_labels=N_LABELS,
                                 mid_layers=len(spec), precision='highest',
                                 dtype=dtype)

        def port_model(dtype):
            return Wav2Letter(N_LABELS, input_size=64, layers=spec,
                              mid_layers=len(spec), compute_dtype=dtype)
        blocks = None
    else:
        blocks = [dict(b, layer_size=b['layer_size'] // 8)
                  for b in QUARTZNET_MODEL['jasper_blocks']]

        def jax_model(dtype):
            return JaxJasper(jasper_blocks=blocks, num_labels=N_LABELS,
                             mid_layers=len(blocks), precision='highest',
                             dtype=dtype)

        def port_model(dtype):
            return Jasper(blocks, N_LABELS, input_size=64,
                          mid_layers=len(blocks), compute_dtype=dtype)
    variables = jax_model(None).init(jax.random.PRNGKey(0), jnp.asarray(x),
                                     jnp.asarray(lens), train=False)
    drift = {}
    outs = {}
    for dtype in (None, jnp.bfloat16):
        (out, _), _ = jax_model(dtype).apply(
            variables, jnp.asarray(x), jnp.asarray(lens), train=True,
            mutable=['batch_stats'])
        outs[dtype] = to_np(out)
    drift['jax'] = float(np.abs(outs[jnp.bfloat16] - outs[None]).mean())
    sd = state_dict_from_flax(jax.device_get(variables), blocks)
    for dtype in (None, BF16):
        model = port_model(dtype)
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs[dtype] = to_np(model.train()(torch.from_numpy(x),
                                              torch.from_numpy(lens))[0])
    drift['port'] = float(np.abs(outs[BF16] - outs[None]).mean())
    assert drift['jax'] > 0.1, drift
    assert 1 / DRIFT_FACTOR < drift['port'] / drift['jax'] < DRIFT_FACTOR, \
        drift


# --------------------------------------------------------------- training

WORDS = ['hello', 'world', 'the', 'quick', 'brown', 'fox', "it's", 'zz']
# One bf16 train step, port vs the JAX trainer from the same weights: the
# losses within 1e-3 relative and the update's relative distance below
# 2e-2 (a bf16 ulp is 2^-8 relative: the weight gradients pass through
# bf16 conv outputs and, for K4/K5, a bf16 dw; the head's bf16 bias
# gradient is a sum that XLA may take in bf16 and the port takes in
# float32). Measured: losses 1.7e-7 (W2L) and 0 (QuartzNet)
# apart, updates 5.6e-3 and 4.3e-3, BN statistics 1.0e-7 and 4.2e-8.
STEP_LOSS_RTOL = 1e-3
STEP_UPDATE_RTOL = 2e-2


@pytest.fixture(scope='module')
def manifest(tmp_path_factory):
    root = tmp_path_factory.mktemp('corpus')
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        # one length bucket (edge 9120 samples): one compiled JAX program
        n = int(rng.integers(7841, 9121))
        t = np.arange(n) / 16000
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 800) * t)
                 * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        write_wav(str(root / f'utt{i}.wav'), audio, 16000)
        text = ' '.join(rng.choice(WORDS, size=int(rng.integers(1, 3))))
        rows.append({'audio_filepath': str(root / f'utt{i}.wav'),
                     'text': text})
    path = root / 'manifest.jsonl'
    path.write_text('\n'.join(json.dumps(r) for r in rows) + '\n')
    return str(path)


def _rel(a: dict, b: dict, keys) -> float:
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in keys)
    den = sum(float((b[k].double() ** 2).sum()) for k in keys)
    return float(np.sqrt(num / den))


def _flow(items) -> str:
    return '[' + ', '.join('{' + ', '.join(f'{k}: {v}' for k, v in i.items())
                           + '}' for i in items) + ']'


STEP_CASES = {
    # Wav2Letter (3 narrow layers, no dropout), the default SGD
    'wav2letter_sgd': (['model.mid_layers=3', 'model.optimizer.lr=0.05'],
                       'layers', W2L_LAYERS_NO_DROPOUT),
    # the narrowed QuartzNet (K4 for C1, K6/K7 for the rest), NovoGrad
    'quartznet_novograd': (['model=quartznet',
                            f'model.mid_layers={len(QUARTZNET_NARROW)}',
                            'optimizer=novograd', 'model.optimizer.lr=0.01'],
                           'jasper_blocks', QUARTZNET_NARROW),
}


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_bf16_train_step_matches_jax(case, manifest, tmp_path, monkeypatch):
    overrides, key, items = STEP_CASES[case]
    overrides = [f'data.train_manifest={manifest}',
                 f'data.val_manifest={manifest}', *overrides,
                 'model.compute_dtype=bf16']
    _pallas_interpret(monkeypatch)
    jcfg = jax_load_config(overrides + [f'model.{key}={_flow(items)}',
                                        'model.stft_method=conv',
                                        'trainer.mesh.data=1'])
    labels = jax_build.build_labels(jcfg.model)
    tx, sched = jax_build.build_optimizer(jcfg.model, 1, 10)
    jmodel = jax_build.build_model(jcfg.model, len(labels))
    assert jmodel.dtype == jnp.bfloat16
    jtr = JaxTrainer(jcfg, jmodel,
                     jax_build.build_frontend(jcfg.model, dither=0.0), tx,
                     sched, jax_build.build_decoder(jcfg.model, labels),
                     run_dir=str(tmp_path / 'jax'))
    cfg = load_config(overrides)
    cfg['model'][key] = items
    blocks = items if key == 'jasper_blocks' else None
    fe = build_frontend(cfg['model'], dither=0.0)
    batches = [b for b in make_loader(manifest, 2, fe, prefetch=0)]
    assert len(batches) == 2
    state = jtr.init_state(batches[0])
    variables = jax.device_get({'params': state.params,
                                'batch_stats': state.batch_stats})
    model = build_model(cfg['model'], len(labels))
    assert model.compute_dtype == BF16
    model.load_state_dict(state_dict_from_flax(variables, blocks),
                          strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, schedule = build_optimizer(model.parameters(), cfg['model'],
                                          1, 10)
    tr = Trainer(cfg, model, fe, optimizer, schedule, GreedyDecoder(labels),
                 device='cpu', run_dir=str(tmp_path / 'port'))
    # op by op, as flax's bf16 rounds: under jit, XLA on the CPU fuses the
    # bf16 ops and rounds elsewhere than the model's code says
    state, jloss, _, _ = jtr._train_step(
        state, {k: v for k, v in batches[0].items()
                if isinstance(v, np.ndarray)})
    loss, _, _ = tr.train_step(to_device(batches[0], torch.device('cpu')))
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=STEP_LOSS_RTOL)
    theirs = state_dict_from_flax(jax.device_get(
        {'params': state.params, 'batch_stats': state.batch_stats}), blocks)
    ours = model.state_dict()
    assert all(v.dtype == torch.float32 for k, v in ours.items()
               if not k.endswith('num_batches_tracked'))
    assert all(v.dtype == torch.float32
               for st in optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())
    # a conv bias that feeds BatchNorm has an exact gradient of zero, so
    # both sides' are rounding noise, which NovoGrad's per-tensor
    # normalisation turns into a full step (tests/test_torch_train_step.py)
    pre_bn = {k for k in ours if k.endswith('conv1.bias')
              and k.replace('conv1.bias', 'batch_norm.weight') in ours}
    params = [k for k in ours if k.endswith(('.weight', '.bias'))
              and k not in pre_bn]
    update = _rel({k: ours[k] - before[k] for k in params},
                  {k: theirs[k] - before[k] for k in params}, params)
    assert update < STEP_UPDATE_RTOL, update
    stats = [k for k in ours if k.endswith(('running_mean', 'running_var'))]
    assert _rel(ours, theirs, stats) < STEP_UPDATE_RTOL


def test_bf16_training_converges_like_f32():
    """``tests/test_bf16.py::test_bf16_training_converges_like_f32`` on the
    port: the same tiny corpus, 30 Adam steps (lr 3e-3) of a 2-layer
    Wav2Letter in f32 and in bf16 from the same weights; each loss halves
    and the bf16 final loss is within 30 % of the f32 one."""
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((4, 96, 64)).astype(
        np.float32))
    flens = torch.tensor([96, 96, 80, 64])
    targets = torch.from_numpy(rng.integers(1, 29, size=(4, 12)).astype(
        np.int32))
    tlens = torch.full((4,), 12, dtype=torch.int32)
    mask = torch.ones(4)
    init = Wav2Letter(29, input_size=64, layers=W2L_LAYERS, mid_layers=2,
                      generator=torch.Generator().manual_seed(0)).state_dict()
    finals = {}
    for name, dtype in (('f32', None), ('bf16', BF16)):
        model = Wav2Letter(29, input_size=64, layers=W2L_LAYERS, mid_layers=2,
                           compute_dtype=dtype)
        model.load_state_dict(init)
        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=3e-3)
        gen = torch.Generator().manual_seed(1)
        losses = []
        for _ in range(30):
            gen.manual_seed(1)   # the JAX test's fixed dropout key
            out, out_lens = model(feats, flens, generator=gen)
            loss = masked_ctc_mean(out, out_lens, targets, tlens, mask)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss))
        assert np.isfinite(losses).all(), losses
        assert losses[-1] < losses[0] * 0.5, (name, losses)
        finals[name] = losses[-1]
    assert abs(finals['bf16'] - finals['f32']) / finals['f32'] < 0.3, finals


# ---------------------------------------------------- config, entry points


def test_config_accepts_bf16_and_parameters_stay_f32():
    base = ['data.train_manifest=x', 'data.val_manifest=y']
    for value in ('bf16', 'bfloat16'):
        cfg = load_config(base + [f'model.compute_dtype={value}',
                                  'model.padding_mode=zeros'])
        model = build_model(cfg['model'], 29)
        assert model.compute_dtype == BF16
        assert model.padding_mode == 'zeros'
        assert all(b.padding_mode == 'zeros'
                   for b in list(model.conv1ds)[:-1])
        assert all(p.dtype == torch.float32 for p in model.parameters())
    cfg = load_config(base + ['model=quartznet', 'model.compute_dtype=bf16'])
    model = build_model(cfg['model'], 29)
    assert model.compute_dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert build_model(load_config(base)['model'], 29).compute_dtype is None


def test_float_models_keep_their_dtype():
    """Without compute_dtype a model computes in its parameters' dtype:
    float64 models (the card checks' oracles) stay float64 end to end."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 40, F_IN))).double()
    lens = torch.tensor([40, 31])
    for model in (Wav2Letter(N_LABELS, input_size=F_IN,
                             layers=W2L_LAYERS_NO_DROPOUT, mid_layers=3),
                  Jasper(QUARTZNET_NARROW, N_LABELS, input_size=F_IN,
                         mid_layers=len(QUARTZNET_NARROW))):
        out, _ = model.double().train()(x, lens)
        assert out.dtype == torch.float64


# ------------------------------------------ bf16 under DP, TP and SP
#
# tests/test_torch_parallel.py, test_torch_tensor_parallel.py and
# test_torch_seq_parallel.py run these models in bf16 on gloo ranks
# (``tests/torch_parallel_worker.py::bf16_record``) and hold them here:
# the narrow Wav2Letter (3 layers) at twice its widths and a QuartzNet of
# 4 blocks (C1, a block of two fused units with a residual, a dilated
# unit, a 1x1 conv), so that every conv shards at model=4 (8 channels a
# shard or more), from JAX's initial weights. The depth is the CPU
# tests' (as for the card's bf16 step against the CPU's): in train mode
# a rank's BatchNorm statistics over its channel slice or frames are
# summed in another order than one process's, and a float32 difference
# that moves an input across a bf16 rounding boundary grows about
# tenfold a normalised conv (QuartzNet-15x5's narrowed blocks of five
# repeats moved one update by 0.10 at model=4).
PAR_W2L = [dict(l, output_size=2 * l['output_size'], dropout=-1.0)
           for l in W2L_NARROW]
PAR_QN = [dict(layer_size=32, kernel_size=33, stride=2, residual=False,
               separable=True),
          dict(layer_size=32, kernel_size=13, repeat=2, residual=True,
               separable=True),
          dict(layer_size=48, kernel_size=9, dilation=2, residual=False,
               separable=True),
          dict(layer_size=64, kernel_size=1, residual=False,
               separable=False)]
PARALLEL_BF16 = {'w2l_reflect': ('reflect', PAR_W2L),
                 'w2l_zeros': ('zeros', PAR_W2L),
                 'qn': (None, PAR_QN)}
# One train step from the shared initial weights, a parallel run against
# one process in bf16: the relative distance of the updates (as
# STEP_UPDATE_RTOL's) at most this. The ranks' partial sums are rounded
# to bf16 apiece before they are added: a tensor-parallel conv's input
# gradient (each rank's Cout slice, K7's on the fused unit), a halo
# frame's gradient (each seq rank's outputs), a data-parallel weight
# gradient (each rank's rows). Each partial's rounding is at most half a
# bf16 ulp of it, 2^-9 relative; one process rounds the whole sum once
# (``test_partial_sums_within_their_roundings`` holds a column conv's
# input gradient to that bound). That bound is relative to the sum of
# the partials' magnitudes, not to their sum, and it compounds layer by
# layer backward, so it sets no tighter bar on an update than the
# roundings in other places that the one-process bf16 step is held to
# JAX's with: STEP_UPDATE_RTOL. Measured over three seeds (data=2 x
# model=2, model=4, data=4): Wav2Letter 3.3-4.6e-3, 2.8-3.6e-3,
# 2.2-4.3e-3, QuartzNet 4.8-5.1e-3, 4.6-4.7e-3, 1.9-2.4e-3; the port's
# one-process step against JAX's reads 5.6e-3 / 4.3e-3.
PARALLEL_UPDATE_RTOL = STEP_UPDATE_RTOL


def parallel_bf16_overrides(name) -> list:
    """``PARALLEL_BF16[name]``'s overrides (no mesh), for
    ``invariance_trainer``."""
    padding, spec = PARALLEL_BF16[name]
    base = ['data.train_manifest=x', 'data.val_manifest=y',
            'model.input_size=16', f'model.mid_layers={len(spec)}',
            'model.compute_dtype=bf16', 'trainer.string_metrics_interval=0']
    if padding is None:
        return base + ['model=quartznet', f'model.jasper_blocks={_flow(spec)}']
    return base + [f'model.layers={_flow(spec)}',
                   f'model.padding_mode={padding}']


def _parallel_jax_model(name, dtype):
    padding, spec = PARALLEL_BF16[name]
    if padding is None:
        return JaxJasper(jasper_blocks=spec, num_labels=N_LABELS,
                         mid_layers=len(spec), precision='highest',
                         dtype=dtype)
    return JaxWav2Letter(layers=spec, num_labels=N_LABELS,
                         mid_layers=len(spec), precision='highest',
                         padding_mode=padding, dtype=dtype)


def parallel_bf16_init(name, root, seed: int = 1) -> dict:
    """A parallel bf16 case of ``name``: its overrides, JAX's initial
    weights (``variables``, from a threefry key: the JAX trainer switches
    the default generator to rbg) and the path of them as a port state
    dict (``init``)."""
    padding, spec = PARALLEL_BF16[name]
    variables = jax.device_get(_parallel_jax_model(name, None).init(
        jax.random.key(seed, impl='threefry2x32'),
        jnp.zeros((1, 64, 16), jnp.float32), jnp.array([64]), train=False))
    init = os.path.join(root, f'init_{name}.pt')
    torch.save(state_dict_from_flax(variables,
                                    spec if padding is None else None), init)
    return {'name': name, 'overrides': parallel_bf16_overrides(name),
            'init': init, 'variables': variables}


def parallel_bf16_refs(case: dict, root) -> dict:
    """What ``parallel_bf16_init``'s case is held to, added to it: one
    port process's ``bf16_record`` (``one``), and JAX's one-process
    eval-mode log-probs in bf16 and f32 on the same features (``jax16``,
    ``jax32``)."""
    from tests.torch_parallel_worker import bf16_batch, bf16_record
    name, overrides = case['name'], case['overrides']
    batch = bf16_batch()
    fe = build_frontend(load_config(overrides)['model'], dither=0.0)
    feats, flens = fe(torch.from_numpy(batch['audio']),
                      torch.from_numpy(batch['audio_lengths']))
    x, lens = jnp.asarray(feats.numpy()), jnp.asarray(flens.numpy())
    case['one'] = bf16_record(overrides, case['init'],
                              os.path.join(root, f'one_{name}'))
    jasper = PARALLEL_BF16[name][0] is None
    with pytest.MonkeyPatch.context() as mp:
        if jasper:   # QuartzNet: the JAX Pallas branches
            _pallas_interpret(mp)
        for key, dtype in (('jax16', jnp.bfloat16), ('jax32', None)):
            y, _ = _parallel_jax_model(name, dtype).apply(
                case['variables'], x, lens, train=False)
            if jasper:   # Jasper's eval emits probabilities
                y = jnp.log(jnp.clip(y.astype(jnp.float32), 1e-30))
            case[key] = to_np(y)
    return case


def within_bf16_ulp(a, b) -> np.ndarray:
    """Elementwise: float32 ``a`` within one bf16 ulp of ``b`` (the bf16
    spacing at the larger magnitude)."""
    a, b = to_np(a), to_np(b)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -126)
    return np.abs(a - b) <= 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_parallel_bf16(got: dict, case: dict) -> None:
    """A parallel run's ``bf16_record`` against one port process in bf16
    (eval-mode log-probs within one bf16 ulp; the step's loss and, at
    PARALLEL_UPDATE_RTOL, its update from the shared initial weights)
    and against JAX's one-process bf16 model on the same weights (the
    bars of ``test_wav2letter_bf16_matches_flax``)."""
    one = case['one']
    logp = to_np(got['logp'])
    ok = within_bf16_ulp(logp, one['logp'])
    assert ok.all(), (f'{int((~ok).sum())} of {ok.size} log-probs more than '
                      'one bf16 ulp from one process', np.abs(
                          logp - to_np(one['logp'])).max())
    np.testing.assert_allclose(logp, case['jax16'], rtol=0, atol=BF16_ATOL)
    assert _closeness(logp, case['jax16'], case['jax32']) >= CLOSER
    assert got['loss'] == pytest.approx(one['loss'], rel=STEP_LOSS_RTOL)
    init = torch.load(case['init'])
    ours, theirs = got['state']['model'], one['state']['model']
    assert all(v.dtype == torch.float32 for k, v in ours.items()
               if not k.endswith('num_batches_tracked'))
    # a conv bias that feeds BatchNorm has an exact gradient of zero
    pre_bn = {k for k in ours if k.endswith('conv1.bias')
              and k.replace('conv1.bias', 'batch_norm.weight') in ours}
    params = [k for k in ours if k.endswith(('.weight', '.bias'))
              and k not in pre_bn]
    moved = {k: ours[k] - init[k] for k in params}
    want = {k: theirs[k] - init[k] for k in params}
    update = _rel(moved, want, params)
    assert update < PARALLEL_UPDATE_RTOL, (update, max(
        (_rel(moved, want, [k]), k) for k in params))
    stats = [k for k in ours if k.endswith(('running_mean', 'running_var'))]
    assert _rel(ours, theirs, stats) < PARALLEL_UPDATE_RTOL


def _logged(run_dir: str) -> dict:
    """metrics.csv of a run: {metric: {step: value}}."""
    out = {}
    with open(os.path.join(run_dir, 'metrics.csv')) as f:
        for line in f.read().splitlines()[1:]:
            _, step, metric, value = line.split(',')
            out.setdefault(metric, {})[int(step)] = float(value)
    return out


def assert_train_main_bf16(par_run: str, one_run: str) -> None:
    """``train.main`` in bf16 on a parallel grid against the same run in
    one process, from the same seeded weights: every logged train and
    validation loss at STEP_LOSS_RTOL; the parallel run's last checkpoint
    float32 and loaded strict=True into one process built from its
    config; its update from the initial weights and its BN statistics at
    PARALLEL_UPDATE_RTOL of one process's."""
    got, want = _logged(par_run), _logged(one_run)
    for metric in ('train_loss', 'val_loss'):
        assert got[metric].keys() == want[metric].keys(), metric
        for step, v in want[metric].items():
            assert got[metric][step] == pytest.approx(
                v, rel=STEP_LOSS_RTOL), (metric, step)
    with open(os.path.join(par_run, 'config.json')) as f:
        cfg = json.load(f)
    assert cfg['model']['compute_dtype'] == 'bf16'
    ours, theirs = (Checkpointer(os.path.join(r, 'checkpoints')).restore()
                    for r in (par_run, one_run))
    assert ours['step'] == theirs['step'] > 0
    ours, theirs = ours['model'], theirs['model']
    assert all(v.dtype == torch.float32 for k, v in ours.items()
               if not k.endswith('num_batches_tracked'))
    model = build_model(cfg['model'], len(build_labels(cfg['model'])),
                        seed=int(cfg['trainer'].get('seed', 0)))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(ours, strict=True)
    pre_bn = {k for k in ours if k.endswith('conv1.bias')
              and k.replace('conv1.bias', 'batch_norm.weight') in ours}
    params = [k for k in ours if k.endswith(('.weight', '.bias'))
              and k not in pre_bn]
    update = _rel({k: ours[k] - init[k] for k in params},
                  {k: theirs[k] - init[k] for k in params}, params)
    assert update < PARALLEL_UPDATE_RTOL, update
    stats = [k for k in ours if k.endswith(('running_mean', 'running_var'))]
    assert _rel(ours, theirs, stats) < PARALLEL_UPDATE_RTOL


TEXTS = ['abba', 'cab', 'dad at bat', 'a cat sat', 'bad cab', 'tact']
NARROW_QUARTZNET = ['model=quartznet', 'model.mid_layers=3',
                    'model.jasper_blocks.0.layer_size=16',
                    'model.jasper_blocks.0.kernel_size=11',
                    'model.jasper_blocks.1.layer_size=16',
                    'model.jasper_blocks.1.kernel_size=7',
                    'model.jasper_blocks.2.layer_size=16',
                    'model.jasper_blocks.2.kernel_size=5',
                    'model.jasper_blocks.2.repeat=2']
NARROW_W2L = ['model.mid_layers=2',
              'model.layers=[{output_size: 16, kernel_size: 7, stride: 2, '
              'dilation: 1, dropout: 0.1}, {output_size: 16, kernel_size: 4, '
              'stride: 1, dilation: 1, dropout: 0.1}]']


def _tiny_corpus(root, n=6):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        t = np.arange(int((0.3 + 0.1 * (i % 3)) * 16000)) / 16000
        audio = (0.3 * np.sin(2 * np.pi * (250 + 60 * i) * t)
                 + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
        path = root / f'utt{i}.wav'
        write_wav(str(path), audio, 16000)
        rows.append({'audio_filepath': str(path), 'text': TEXTS[i % 6]})
    manifest = root / 'train.jsonl'
    manifest.write_text('\n'.join(json.dumps(r) for r in rows))
    return str(manifest)


@pytest.mark.parametrize('name,model_overrides', [
    ('wav2letter_zeros', NARROW_W2L + ['model.padding_mode=zeros']),
    ('quartznet', NARROW_QUARTZNET)])
def test_train_and_evaluate_main_in_bf16(name, model_overrides, tmp_path,
                                         capsys):
    """``train.main`` on a ``compute_dtype=bf16`` run with ``--cpu``, then
    ``evaluate.main --model-path`` on it: the run evaluates in bf16 (the
    loss of the bf16 model restored by hand), its checkpoint holds float32
    tensors and loads into a float32 model unchanged."""
    manifest = _tiny_corpus(tmp_path)
    run_dir = tmp_path / 'run'
    base = [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', 'data.batch_size=2',
            'data.num_length_buckets=1', f'trainer.default_root_dir={run_dir}',
            'trainer.log_every_n_steps=1', 'trainer.max_epochs=1',
            'model.compute_dtype=bf16', *model_overrides, '--cpu']
    assert train_cli.main(base) == 0
    losses = [float(l.split(',')[3]) for l in
              (run_dir / 'metrics.csv').read_text().splitlines()[1:]
              if l.split(',')[2] == 'train_loss']
    assert len(losses) == 3 and all(np.isfinite(losses))
    state = Checkpointer(run_dir / 'checkpoints').restore()
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in state['model'].values())
    capsys.readouterr()
    assert port_eval.main(['--model-path', str(run_dir), '--test-manifest',
                           manifest, '--batch-size', '2', '--cpu']) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got['num_utterances'] == 6 and np.isfinite(got['loss'])

    # the same weights by hand, in bf16 and in float32: evaluate.main's
    # loss is the bf16 model's (to float32 summation order: the loader
    # batches the utterances otherwise) and far from the float32 one's
    cfg, model, labels, step = load_run(str(run_dir))
    assert step == 3 and model.compute_dtype == BF16
    f32 = build_model({**cfg['model'], 'compute_dtype': 'f32'}, len(labels))
    f32.load_state_dict(state['model'], strict=True)
    assert f32.compute_dtype is None
    for k, v in f32.state_dict().items():
        assert torch.equal(v, state['model'][k]), k
    fe = build_frontend(cfg['model'], dither=0.0)
    loss = {}
    for name, m in (('bf16', model), ('f32', f32)):
        loader = make_loader(manifest, 2, fe, labels, prefetch=0)
        loss[name] = port_eval.evaluate(m.eval(), fe, loader,
                                        GreedyDecoder(labels), 'cpu')['loss']
    near, far = (abs(got['loss'] - loss[k]) for k in ('bf16', 'f32'))
    assert near < far / 10, (near, far)
