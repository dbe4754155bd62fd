"""The port's Jasper streamer vs the JAX package's, on the CPU.

``serving/streaming_jasper.py`` of the port (``fold_jasper``,
``StreamingJasper`` in f32, int8 and int8_full) is held against the JAX
module of the same name on the same seeded weights (a flax init with
non-trivial BatchNorm statistics and norm scales, carried across with
``weights.state_dict_from_flax``) and the same seeded numpy audio, fed in
the same awkward pieces: the cases of ``tests/test_streaming_jasper.py``
(its block structures, ragged and boundary ends, dense residuals, grouped
convs, heads, the norm variants, the QuartzNet structure and the
structure fuzz). With fixed statistics the port's stream is also held to
the port's own eval-mode ``Jasper`` on the audio zero-padded past the
lookahead, at the JAX test's tolerance against its offline model.
K4's plain version (``depthwise_fwd`` on a CPU tensor) runs every
depthwise conv.
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_streaming import _run_stream
from tests.test_streaming_jasper import (HOP, JASPER_DENSE, JASPER_GROUPS,
                                         JASPER_HEADS, JASPER_SMALL, N_MELS,
                                         _build, _norm_blocks)
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu.config import load_config as jax_load_config
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu.models.jasper import Jasper as JaxJasper
from wav2letter_pytorch_tpu.serving import streaming_jasper as jsj
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.models.jasper import Jasper
from wav2letter_pytorch_tpu_torch.ops.depthwise import depthwise_fwd
from wav2letter_pytorch_tpu_torch.serving import streaming_jasper as sj
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

N_LABELS = 7
STATS = (np.zeros(N_MELS, np.float32), np.ones(N_MELS, np.float32))
# Port stream vs JAX stream, probabilities: float32 convs summed in
# another order (and K1's plain DFT against JAX's DFT conv).
STREAM_TOL = 1e-5
# The port's stream vs the port's offline Jasper: the JAX test's own
# tolerance for its stream against its offline model.
OFFLINE_ATOL, OFFLINE_RTOL = 1e-4, 1e-3
# Cumulative norms (group / instance / layer): the same statistics on both
# sides, summed in another order.
NORM_TOL = 1e-5
# int8 weights and int8_full, port vs JAX: the int32 sums are equal and
# the scales divide as JAX's, so only float32 steps may round apart; one
# int8 rounding flip would show as ~1e-2.
Q8_TOL = 1e-5


def _pair(blocks, seed=0):
    """(JAX variables, the port's eval Jasper) on the same weights."""
    _, variables, _ = _build(blocks, num_labels=N_LABELS, seed=seed)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    model = Jasper(blocks, N_LABELS, input_size=N_MELS,
                   mid_layers=len(blocks))
    model.load_state_dict(state_dict_from_flax(variables, blocks),
                          strict=True)
    return variables, model.eval()


def _norm_pair(blocks, seed=3):
    """``_pair`` for blocks without BatchNorm, from a plain flax init (the
    JAX norm-variant test's, its PRNG pinned)."""
    frontend = JaxFrontend(JaxAudio(), n_mels=N_MELS, dither=0.0)
    jmodel = JaxJasper(jasper_blocks=blocks, num_labels=N_LABELS,
                       mid_layers=len(blocks))
    feats, flens = frontend(np.zeros((1, 8000), np.float32),
                            np.array([8000]))
    key = jax.random.key(seed, impl='threefry2x32')
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jmodel.init(key, feats, flens, train=False)))
    assert not variables.get('batch_stats')
    model = Jasper(blocks, N_LABELS, input_size=N_MELS,
                   mid_layers=len(blocks))
    model.load_state_dict(state_dict_from_flax(variables, blocks),
                          strict=True)
    return variables, model.eval()


def _streamers(blocks, variables, model, stats=STATS, **kw):
    """The JAX streamer and the port's (on the CPU) on the same weights."""
    norm = dict(norm='precomputed', norm_stats=stats) if stats is not None \
        else dict(norm='cumulative')
    kw = {**norm, **kw}
    return (jserve.StreamingJasper(
                blocks, N_LABELS, variables,
                JaxFrontend(JaxAudio(), n_mels=N_MELS, dither=0.0), **kw),
            sj.StreamingJasper(
                blocks, N_LABELS, model,
                SpectrogramFrontend(AudioConfig(), n_mels=N_MELS,
                                    dither=0.0), device='cpu', **kw))


def _geometry(sw):
    return (sw.prime_frames, sw.prime_out, sw.chunk_out, sw.lookahead_frames,
            sw._carries, sw._prime_outs, sw._chunk_outs, sw._fin_zeros,
            sw._fin_flush, sw._fin_out, sw._fin_frames, sw.scale,
            sw._len_coeffs_head)


def _audio(lengths, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((len(lengths), max(lengths))) * 0.1) \
        .astype(np.float32)
    for b, L in enumerate(lengths):
        audio[b, L:] = 0.0
    return audio


def _port_offline(model, audio, lengths, pad):
    """The port's eval-mode Jasper behind the offline frontend with the
    streams' fixed statistics, the audio zero-padded to ``pad`` samples."""
    buf = np.zeros((audio.shape[0], pad), np.float32)
    buf[:, :audio.shape[1]] = audio
    fe = SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0,
                             norm_stats=STATS)
    with torch.no_grad():
        feats, flens = fe(torch.from_numpy(buf), torch.tensor(lengths))
        probs, lens = model(feats, flens)
    return probs.numpy(), lens.numpy()


def _parity(blocks, tails, chunk_frames=16, n_chunks=3, seed=0):
    """The JAX test's ``_parity``: streams ending ``tails`` samples into
    the final chunk, fed in 1777-sample pieces; the port's probabilities
    within STREAM_TOL of JAX's and within the JAX test's tolerance of the
    port's offline forward, the valid counts equal to both."""
    variables, model = _pair(blocks, seed)
    jsw, sw = _streamers(blocks, variables, model, chunk_frames=chunk_frames)
    assert _geometry(sw) == _geometry(jsw)
    lengths = [sw.prime_samples + n_chunks * sw.chunk_samples + t
               for t in tails]
    audio = _audio(lengths, 42 + seed)
    got, valid = _run_stream(sw, audio, np.asarray(lengths))
    want, want_valid = _run_stream(jsw, audio, np.asarray(lengths))
    np.testing.assert_array_equal(valid, want_valid)
    assert got.shape == want.shape
    margin = (sw.lookahead_frames + 16) * HOP
    off, off_lens = _port_offline(model, audio, lengths,
                                  max(lengths) + margin)
    np.testing.assert_array_equal(valid, off_lens)
    for b, v in enumerate(valid):
        np.testing.assert_allclose(got[b, :v], want[b, :v], rtol=0,
                                   atol=STREAM_TOL)
        np.testing.assert_allclose(got[b, :v], off[b, :v],
                                   atol=OFFLINE_ATOL, rtol=OFFLINE_RTOL)
    return sw


def _config_blocks(name, idx, width=12):
    """Blocks ``idx`` of the JAX package's ``model=name`` config at toy
    width."""
    cfg = jax_load_config(['data.train_manifest=u', 'data.val_manifest=u',
                           f'model={name}'])
    blocks = []
    for i in idx:
        b = dict(cfg.model.jasper_blocks[i])
        b['layer_size'] = width
        blocks.append(b)
    return blocks


def _fuzz_blocks(seed):
    """``tests/test_streaming_jasper.py::test_jasper_structure_fuzz``'s
    draw."""
    rng = np.random.default_rng(200 + seed)
    blocks = [{'layer_size': 10, 'kernel_size': int(rng.integers(4, 12)),
               'stride': 2, 'residual': False,
               'separable': bool(rng.integers(0, 2))}]
    for _ in range(int(rng.integers(1, 4))):
        blocks.append({
            'layer_size': int(rng.choice([10, 12])),
            'kernel_size': int(rng.integers(2, 12)),
            'stride': 1,
            'dilation': int(rng.choice([1, 1, 2])),
            'repeat': int(rng.integers(1, 3)),
            'residual': bool(rng.integers(0, 2)),
            'residual_dense': bool(rng.integers(0, 2)),
            'residual_mode': str(rng.choice(['add', 'max'])),
            'separable': bool(rng.integers(0, 2)),
        })
    for b in blocks:
        if b.get('dilation', 1) > 1 and b.get('stride', 1) > 1:
            b['dilation'] = 1
    return blocks, int(rng.integers(0, 2560))


PARITY_CASES = {
    # separable + repeat 2 + a plain max-residual block; ragged ends
    'small': (JASPER_SMALL, [1311, 707], {}),
    'boundary': (JASPER_SMALL, [0, 2559], dict(n_chunks=2, seed=3)),
    'dense_residual': (JASPER_DENSE, [901], dict(seed=5)),
    'grouped': (JASPER_GROUPS, [911, 0], dict(seed=11)),
    'heads': (JASPER_HEADS, [707], dict(seed=12)),
}


@pytest.mark.parametrize('case', list(PARITY_CASES))
def test_stream_matches_jax_and_offline(case):
    blocks, tails, kw = PARITY_CASES[case]
    _parity(blocks, tails, **kw)


def test_quartznet_structure_streams():
    """QuartzNet's C1, one B block per kernel size, C2 (dilation 2) and C3
    at toy width (``test_quartznet_structure_streams``): repeat-5
    separable residual blocks stream exactly, and every depthwise conv of
    a phase is one K4 call."""
    blocks = _config_blocks('quartznet', [0, 1, 4, 7, 10, 13, 16, 17])
    assert any(int(b.get('dilation', 1)) > 1 for b in blocks)
    assert any(int(b.get('repeat', 1)) == 5 for b in blocks)
    before = depthwise_fwd.launches
    sw = _parity(blocks, [640], chunk_frames=32, n_chunks=1, seed=11)
    assert sw.lookahead_frames > 50
    assert depthwise_fwd.launches == before  # CPU: the plain version
    n_dw = sum(op['depthwise'] for blk in sw._blocks for rep in blk['reps']
               for op in rep['ops'])
    assert n_dw == 1 + 5 * 5 + 1


def test_jasper_flagship_structure_streams():
    """The 15-block Jasper config's geometry at toy width, chunk 32."""
    blocks = _config_blocks('jasper', range(15))
    sw = _parity(blocks, [640], chunk_frames=32, n_chunks=1, seed=7)
    assert sw.lookahead_frames > 100


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_structure_fuzz(seed):
    blocks, tail = _fuzz_blocks(seed)
    _parity(blocks, [tail], seed=seed)


@pytest.mark.parametrize('kind, ng', [('group', 2), ('group', -1),
                                      ('instance', 1), ('layer', 1)])
def test_norm_variants_match_jax(kind, ng):
    """Group / instance / layer norms with cumulative statistics: the
    port's stream within NORM_TOL of JAX's on a long stream, and, as the
    JAX test holds its own, converging to the offline model late in the
    stream (argmax agreement > 0.9, mean |d| < 0.05)."""
    blocks = _norm_blocks(kind, ng)
    variables, model = _norm_pair(blocks)
    jsw, sw = _streamers(blocks, variables, model, chunk_frames=16)
    assert _geometry(sw) == _geometry(jsw)
    length = sw.prime_samples + 16 * sw.chunk_samples + 640
    audio = _audio([length], 31)
    got, valid = _run_stream(sw, audio, np.array([length]))
    want, want_valid = _run_stream(jsw, audio, np.array([length]))
    np.testing.assert_array_equal(valid, want_valid)
    v = int(valid[0])
    np.testing.assert_allclose(got[0, :v], want[0, :v], rtol=0,
                               atol=NORM_TOL)
    # No padding margin: offline norm statistics count padded frames.
    off, off_lens = _port_offline(model, audio, [length], length)
    np.testing.assert_array_equal(valid, off_lens)
    late = slice(2 * v // 3, v)
    agree = np.mean(np.argmax(got[0, late], -1) == np.argmax(off[0, late],
                                                             -1))
    assert agree > 0.9, f'late-region argmax agreement {agree:.2f}'
    assert np.mean(np.abs(got[0, late] - off[0, late])) < 0.05


@pytest.mark.parametrize('mode, int8_dw', [('int8', False),
                                           ('int8_full', False),
                                           ('int8_full', True)])
def test_quantized_modes_match_jax(mode, int8_dw):
    """int8 weights and int8_full (also with int8 depthwise activations):
    the port's stream within Q8_TOL of JAX's on two ragged rows, and, as
    the JAX test holds its own, close to the f32 stream (mean |d| < 0.02,
    argmax agreement > 0.9)."""
    variables, model = _pair(JASPER_SMALL)
    kw = dict(chunk_frames=16, weights=mode)
    if int8_dw:
        kw['int8_depthwise'] = True
    jsw, sw = _streamers(JASPER_SMALL, variables, model, **kw)
    _, s32 = _streamers(JASPER_SMALL, variables, model, chunk_frames=16)
    lengths = [sw.prime_samples + 2 * sw.chunk_samples + 640,
               sw.prime_samples + 2 * sw.chunk_samples + 1999]
    audio = _audio(lengths, 9)
    got, valid = _run_stream(sw, audio, np.asarray(lengths))
    want, want_valid = _run_stream(jsw, audio, np.asarray(lengths))
    f32, f32_valid = _run_stream(s32, audio, np.asarray(lengths))
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(valid, f32_valid)
    for b, v in enumerate(valid):
        np.testing.assert_allclose(got[b, :v], want[b, :v], rtol=0,
                                   atol=Q8_TOL)
        assert np.mean(np.abs(got[b, :v] - f32[b, :v])) < 0.02
        assert np.mean(np.argmax(got[b, :v], -1)
                       == np.argmax(f32[b, :v], -1)) > 0.9


def _same_descriptors(got, want, path='fold'):
    """Equal nested dicts / lists / tuples, arrays equal to the bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_descriptors(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_descriptors(g, w, f'{path}[{i}]')
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, path
        np.testing.assert_array_equal(g, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), path


@pytest.mark.parametrize('case', ['small', 'dense', 'grouped', 'heads',
                                  'group_norm', 'quartznet'])
def test_fold_jasper_equals_jax(case):
    """``fold_jasper`` of the port's model (and of its state dict) equals
    the JAX ``fold_jasper`` of the flax tree descriptor for descriptor:
    folded BatchNorm, tiled heads, grouped pointwise kernels, plain
    residual convs and runtime norm descriptors, each array to the bit."""
    blocks = {'small': JASPER_SMALL, 'dense': JASPER_DENSE,
              'grouped': JASPER_GROUPS, 'heads': JASPER_HEADS,
              'group_norm': _norm_blocks('group', 2),
              'quartznet': _config_blocks('quartznet', [0, 1, 16, 17])}[case]
    variables, model = (_norm_pair(blocks) if case == 'group_norm'
                        else _pair(blocks, seed=4))
    want = jsj.fold_jasper(variables, blocks)
    _same_descriptors(sj.fold_jasper(model, blocks), want)
    _same_descriptors(sj.fold_jasper(model.state_dict(), blocks), want)


def test_unsupported_configs_raise_the_jax_texts():
    variables, model = _pair(JASPER_SMALL)
    fe = SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0)
    jfe = JaxFrontend(JaxAudio(), n_mels=N_MELS, dither=0.0)
    for change, match in ((dict(stride=2, residual=True), 'stride 1'),
                          (dict(separable=False, heads=4), 'separable')):
        bad = [dict(JASPER_SMALL[0], **change)]
        texts = []
        for build in (lambda: jserve.StreamingJasper(bad, N_LABELS,
                                                     variables, jfe),
                      lambda: sj.StreamingJasper(bad, N_LABELS, model, fe,
                                                 device='cpu')):
            with pytest.raises(ValueError, match=match) as e:
                build()
            texts.append(str(e.value))
        assert texts[0] == texts[1]
    with pytest.raises(ValueError, match='unknown weights mode'):
        sj.StreamingJasper(JASPER_SMALL, N_LABELS, model, fe, weights='q4',
                           device='cpu')
    with pytest.raises(ValueError, match='divisible'):
        sj.StreamingJasper(JASPER_SMALL, N_LABELS, model, fe,
                           chunk_frames=15, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            sj.StreamingJasper(JASPER_SMALL, N_LABELS, model, fe)
