"""The port's Jasper / QuartzNet vs the JAX package's, on the CPU.

Flax models of a few narrow blocks are initialised in JAX (BatchNorm
statistics and norm scales made non-trivial), carried across with
``weights.state_dict_from_flax`` and run in both frameworks on the same
seeded numpy features: in eval mode (probabilities and lengths) and in
train mode (log-probs and the new BatchNorm statistics; dropout off). JAX
runs its default XLA path and, for the narrowed QuartzNet, also its Pallas
branches (``W2L_DEPTHWISE=pallas``, ``W2L_SEPCONV=pallas``) in interpret
mode; the port runs the plain versions of K4-K7 on the CPU. Also: the
weight mapping against ``torch_state_dict_from_variables`` (and the full
QuartzNet-15x5 and Jasper-15 layouts), ``remat``, ``dropout_default``, the
configs against the JAX package's yaml, one NovoGrad train step and one
eval step against the JAX trainer, and ``train.main`` / ``evaluate.main``
with ``model=quartznet`` end to end.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import wav2letter_pytorch_tpu.ops.depthwise_pallas as jax_dwp
import wav2letter_pytorch_tpu.ops.sep_conv_pallas as jax_scp
from wav2letter_pytorch_tpu.config import load_config as jax_load_config
from wav2letter_pytorch_tpu.models import Jasper as JaxJasper
from wav2letter_pytorch_tpu.training import Trainer as JaxTrainer
from wav2letter_pytorch_tpu.training import build as jax_build
from wav2letter_pytorch_tpu.training.torch_import import \
    torch_state_dict_from_variables
from wav2letter_pytorch_tpu_torch import evaluate as port_eval
from wav2letter_pytorch_tpu_torch import train as train_cli
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.evaluate import make_loader
from wav2letter_pytorch_tpu_torch.models.jasper import Jasper
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_model,
                                                         build_optimizer)
from wav2letter_pytorch_tpu_torch.training.checkpoint import Checkpointer
from wav2letter_pytorch_tpu_torch.training.trainer import (Trainer,
                                                           eval_step,
                                                           to_device)
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

F_IN, N_LABELS = 16, 29

# QuartzNet narrowed: C1 (stride 2), a repeat-5 block, a repeat-2 block
# that widens, C2 (dilation 2), C3 (1x1, not separable).
QUARTZNET_NARROW = [
    dict(layer_size=16, kernel_size=33, stride=2, residual=False,
         separable=True),
    dict(layer_size=16, kernel_size=13, repeat=5, residual=True,
         separable=True),
    dict(layer_size=24, kernel_size=15, repeat=2, residual=True,
         separable=True),
    dict(layer_size=24, kernel_size=9, dilation=2, residual=False,
         separable=True),
    dict(layer_size=32, kernel_size=1, residual=False, separable=False),
]
CASES = {
    'quartznet': QUARTZNET_NARROW,
    'max_group_norm': [
        dict(layer_size=16, kernel_size=7, repeat=2, residual_mode='max',
             normalization='group', norm_groups=4),
        dict(layer_size=16, kernel_size=5, normalization='group',
             norm_groups=-1, activation='hardtanh')],
    'instance_layer_norm': [
        dict(layer_size=16, kernel_size=7, stride=2, residual=False,
             normalization='instance', activation='selu'),
        dict(layer_size=24, kernel_size=5, repeat=2, normalization='layer',
             conv_mask=False)],
    'dense_residual': [
        dict(layer_size=16, kernel_size=5, residual=False),
        dict(layer_size=16, kernel_size=5, repeat=2, residual_dense=True),
        dict(layer_size=16, kernel_size=7, residual_dense=True,
             kernel_size_factor=0.5)],
    'heads_groups_shuffle': [
        dict(layer_size=16, kernel_size=5, repeat=2, heads=4, groups=2),
        dict(layer_size=16, kernel_size=5, groups=4, separable=False)],
}
# Eval-mode probabilities: float32 convs in other orders, ~1e-7 seen.
PROB_TOL = 1e-5
# Train-mode log-probs through batch statistics (flax: E[x^2] - E[x]^2,
# torch: two passes): ~3e-6 seen.
LOGP_TOL = 1e-4
STATS_TOL = 1e-5


def _variables(blocks, seed=0, T=64):
    model = JaxJasper(jasper_blocks=blocks, num_labels=N_LABELS,
                      mid_layers=len(blocks), precision='highest')
    x = jnp.zeros((1, T, F_IN), jnp.float32)
    v = jax.device_get(model.init(jax.random.PRNGKey(seed), x,
                                  jnp.array([T]), train=False))
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for k, sub in tree.items():
            if isinstance(sub, dict):
                perturb(sub)
            elif k == 'mean':
                tree[k] = rng.normal(0.1, 0.2, sub.shape).astype(np.float32)
            elif k == 'var':
                tree[k] = rng.uniform(0.5, 1.5, sub.shape).astype(np.float32)
            elif k == 'scale':
                tree[k] = rng.normal(1.0, 0.1, sub.shape).astype(np.float32)
    perturb(v['params'])
    perturb(v.get('batch_stats', {}))
    return model, v


def _port(blocks, variables):
    model = Jasper(blocks, N_LABELS, input_size=F_IN, mid_layers=len(blocks))
    model.load_state_dict(state_dict_from_flax(variables, blocks),
                          strict=True)
    return model


def _pallas_interpret(monkeypatch):
    """The JAX package's Pallas branches, run in interpret mode."""
    monkeypatch.setenv('W2L_DEPTHWISE', 'pallas')
    monkeypatch.setenv('W2L_SEPCONV', 'pallas')
    dw, sep = jax_dwp.depthwise_conv1d, jax_scp.sep_conv1d
    monkeypatch.setattr(jax_dwp, 'depthwise_conv1d',
                        lambda *a, **k: dw(*a, **{**k, 'interpret': True}))
    monkeypatch.setattr(jax_scp, 'sep_conv1d',
                        lambda *a, **k: sep(*a, **{**k, 'interpret': True}))


MODEL_CASES = ([('quartznet', 'pallas')]
               + [(name, 'xla') for name in CASES])


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case,path', MODEL_CASES)
def test_model_matches_flax(case, path, train, monkeypatch):
    blocks = CASES[case]
    jmodel, variables = _variables(blocks)
    if path == 'pallas':
        _pallas_interpret(monkeypatch)
    rng = np.random.default_rng(7)
    T = 64
    x = rng.standard_normal((3, T, F_IN)).astype(np.float32)
    lens = np.array([T, 50, 37], np.int32)
    model = _port(blocks, variables).train(train)
    out, out_lens = model(torch.from_numpy(x), torch.from_numpy(lens))
    if train:
        (ref, ref_lens), upd = jmodel.apply(
            variables, jnp.asarray(x), jnp.asarray(lens), train=True,
            mutable=['batch_stats'])
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=LOGP_TOL)
        theirs = state_dict_from_flax(
            {'params': variables['params'],
             'batch_stats': jax.device_get(upd.get('batch_stats', {}))},
            blocks)
        ours = model.state_dict()
        stats = [k for k in ours if k.endswith(('running_mean',
                                                'running_var'))]
        for k in stats:
            np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                       rtol=0, atol=STATS_TOL, err_msg=k)
    else:
        ref, ref_lens = jmodel.apply(variables, jnp.asarray(x),
                                     jnp.asarray(lens), train=False)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=PROB_TOL)
        np.testing.assert_allclose(out.detach().sum(-1).numpy(), 1.0,
                                   rtol=1e-5)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))


@pytest.mark.parametrize('case', sorted(CASES))
def test_state_dict_matches_torch_import_export(case):
    blocks = CASES[case]
    _, variables = _variables(blocks, seed=1)
    ours = state_dict_from_flax(variables, blocks)
    ref = torch_state_dict_from_variables(variables, blocks)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)
    model = Jasper(blocks, N_LABELS, input_size=F_IN, mid_layers=len(blocks))
    assert sorted(model.state_dict()) == sorted(ref)


@pytest.mark.parametrize('name,depth', [('quartznet', 18), ('jasper', 15)])
def test_full_width_layout_matches_the_reference_export(name, depth):
    """QuartzNet-15x5 and Jasper-15 at full width: every key and shape of
    the port's state_dict is the reference export's (shapes from
    ``jax.eval_shape``, so nothing full-size is computed)."""
    cfg = load_config(['data.train_manifest=x', 'data.val_manifest=y',
                       f'model={name}', f'model.mid_layers={depth}'])
    blocks = cfg['model']['jasper_blocks']
    jmodel = JaxJasper(jasper_blocks=blocks, num_labels=N_LABELS,
                       mid_layers=depth)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64)),
                            jnp.array([64]), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    ref = torch_state_dict_from_variables(zeros, blocks)
    with torch.device('meta'):
        model = Jasper(blocks, N_LABELS, mid_layers=depth, device='meta')
    ours = model.state_dict()
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == tuple(np.shape(v)), k
    n = sum(p.numel() for p in model.parameters())
    if name == 'quartznet':
        assert n == 18_924_381 and model.scaling_factor == 2


def test_remat_gives_identical_loss_gradients_and_statistics():
    """``remat`` recomputes each block in the backward: the same dropout
    draws (replayed from the step's generator), the BatchNorm statistics
    moved once, the loss and every gradient bit-identical."""
    blocks = [dict(b, dropout=0.2) for b in QUARTZNET_NARROW]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 48, F_IN)).astype(
        np.float32))
    lens = torch.tensor([48, 35])
    results = []
    for remat in (False, True):
        model = Jasper(blocks, N_LABELS, input_size=F_IN, mid_layers=5,
                       remat=remat, generator=torch.Generator().manual_seed(0))
        model.train()
        out, _ = model(x, lens, generator=torch.Generator().manual_seed(9))
        loss = (out * torch.linspace(-1, 1, N_LABELS)).sum()
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                        model.named_parameters()},
                        model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert int(s1['jasper_encoder.0.mconv.2.num_batches_tracked']) == 1


def test_dropout_default_fills_blocks_without_their_own():
    cfg = load_config(['data.train_manifest=u', 'data.val_manifest=u',
                       'model=jasper', 'model.mid_layers=2',
                       '+model.dropout_default=0.3',
                       'model.jasper_blocks.1.layer_size=16',
                       '+model.jasper_blocks.1.dropout=0.05'])
    model = build_model(cfg['model'], N_LABELS)
    rates = [blk.out[1].rate for blk in model.jasper_encoder]
    assert rates == [0.3, 0.05]


@pytest.mark.parametrize('name', ['quartznet', 'jasper'])
def test_configs_match_the_jax_yaml(name):
    common = ['data.train_manifest=u', 'data.val_manifest=u', f'model={name}']
    ours = load_config(common)['model']
    theirs = jax_load_config(common).model.to_dict()
    for key in ('name', 'mid_layers', 'jasper_blocks', 'remat',
                'input_size', 'init_mode', 'labels'):
        assert ours[key] == theirs[key], key


@pytest.mark.parametrize('override,match', [
    ('model.init_mode=lecun', 'Unknown initialization mode'),
    ('model.name=conformer', 'Unknown model name'),
])
def test_build_refuses_unknown_names(override, match):
    cfg = load_config(['data.train_manifest=u', 'data.val_manifest=u',
                       'model=quartznet', 'model.mid_layers=1', override])
    with pytest.raises(ValueError, match=match):
        build_model(cfg['model'], N_LABELS)


@pytest.mark.parametrize('mode', ['xavier_uniform', 'xavier_normal',
                                  'kaiming_uniform', 'kaiming_normal'])
def test_init_modes_match_the_jax_distributions(mode):
    """``init_conv_`` draws from a torch.Generator with the distribution of
    the JAX package's ``conv_initializer``: the same standard deviation
    (within 2 %: ~68 k draws give ~0.3 % of sampling error) and the same
    support (uniform bound; normals truncated at two standard deviations)."""
    from wav2letter_pytorch_tpu.models.base import conv_initializer
    from wav2letter_pytorch_tpu_torch.models.base import init_conv_
    K, cin, cout = 33, 32, 64
    theirs = np.asarray(conv_initializer(mode)(jax.random.PRNGKey(0),
                                               (K, cin, cout), jnp.float32))
    ours = init_conv_(torch.empty(cout, cin, K), mode,
                      torch.Generator().manual_seed(0)).numpy()
    again = init_conv_(torch.empty(cout, cin, K), mode,
                       torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(ours, again)
    np.testing.assert_allclose(ours.std(), theirs.std(), rtol=2e-2)
    np.testing.assert_allclose(np.abs(ours).max(), np.abs(theirs).max(),
                               rtol=2e-2)


WORDS = ['hello', 'world', 'the', 'quick', 'brown', 'fox', "it's", 'zz']


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


def test_novograd_train_step_matches_jax(manifest, tmp_path):
    """Two NovoGrad steps of the narrowed QuartzNet (64 mels) through the
    port's Trainer and the JAX Trainer (XLA path), then one eval step each
    (Jasper's eval probabilities scored as log(max(p, 1e-30))). Dither off;
    the blocks have no dropout."""
    blocks = QUARTZNET_NARROW
    flow = ', '.join('{' + ', '.join(f'{k}: {v}' for k, v in b.items()) + '}'
                     for b in blocks)
    overrides = [f'data.train_manifest={manifest}',
                 f'data.val_manifest={manifest}', 'model=quartznet',
                 f'model.mid_layers={len(blocks)}', 'optimizer=novograd',
                 'model.optimizer.lr=0.01']
    jcfg = jax_load_config(overrides + [f'model.jasper_blocks=[{flow}]',
                                        'model.stft_method=conv',
                                        'trainer.mesh.data=1'])
    labels = jax_build.build_labels(jcfg.model)
    tx, sched = jax_build.build_optimizer(jcfg.model, 1, 10)
    jtr = JaxTrainer(jcfg, jax_build.build_model(jcfg.model, len(labels)),
                     jax_build.build_frontend(jcfg.model, dither=0.0), tx,
                     sched, jax_build.build_decoder(jcfg.model, labels),
                     run_dir=str(tmp_path / 'jax'))
    cfg = load_config(overrides)
    cfg['model']['jasper_blocks'] = blocks
    fe = build_frontend(cfg['model'], dither=0.0)
    batches = [b for b in make_loader(manifest, 2, fe, prefetch=0)]
    assert len(batches) == 2
    state = jtr.init_state(batches[0])
    variables = jax.device_get({'params': state.params,
                                'batch_stats': state.batch_stats})
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(state_dict_from_flax(variables, blocks),
                          strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, schedule = build_optimizer(model.parameters(), cfg['model'],
                                          1, 10)
    tr = Trainer(cfg, model, fe, optimizer, schedule, GreedyDecoder(labels),
                 device='cpu', run_dir=str(tmp_path / 'port'))
    jstep = jax.jit(jtr._train_step)
    for batch in batches:
        state, jloss, _, _ = jstep(state, {k: v for k, v in batch.items()
                                           if isinstance(v, np.ndarray)})
        loss, _, _ = tr.train_step(to_device(batch, torch.device('cpu')))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)

    theirs = state_dict_from_flax(jax.device_get(
        {'params': state.params, 'batch_stats': state.batch_stats}), blocks)
    ours = model.state_dict()
    params = [k for k in ours if k.endswith(('.weight', '.bias'))]
    stats = [k for k in ours if k.endswith(('running_mean', 'running_var'))]
    update = _rel({k: ours[k] - before[k] for k in params},
                  {k: theirs[k] - before[k] for k in params}, params)
    # float32 on both sides, the NovoGrad update normalised per tensor
    assert update < 1e-3, update
    assert _rel(ours, theirs, stats) < 1e-5

    model.eval()
    jeval = jax.jit(jtr._eval_step)
    for batch in batches:
        jloss, jids, jlens = jeval(state, {k: v for k, v in batch.items()
                                           if isinstance(v, np.ndarray)})
        loss, ids, lens = eval_step(model, fe,
                                    to_device(batch, torch.device('cpu')))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


TEXTS = ['abba', 'cab', 'dad at bat', 'a cat sat', 'bad cab', 'tact']
NARROW_QUARTZNET = ['model=quartznet', 'model.mid_layers=3',
                    'model.jasper_blocks.0.layer_size=16',
                    'model.jasper_blocks.0.kernel_size=11',
                    'model.jasper_blocks.1.layer_size=16',
                    'model.jasper_blocks.1.kernel_size=7',
                    'model.jasper_blocks.2.layer_size=16',
                    'model.jasper_blocks.2.kernel_size=5',
                    'model.jasper_blocks.2.repeat=2']


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


def test_train_and_evaluate_main_with_quartznet(tmp_path, capsys):
    manifest = _tiny_corpus(tmp_path)
    run_dir = tmp_path / 'run'
    base = [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', 'data.batch_size=2',
            'data.num_length_buckets=1', f'trainer.default_root_dir={run_dir}',
            'trainer.log_every_n_steps=1', '+model.dropout_default=0.1',
            'model.remat=true', *NARROW_QUARTZNET, '--device', 'cpu']
    assert train_cli.main(base + ['trainer.max_epochs=1']) == 0
    ck = Checkpointer(run_dir / 'checkpoints')
    assert ck.latest_step() == 3 and ck.load_extra() == {'epoch': 1}
    metrics = (run_dir / 'metrics.csv').read_text()
    for name in ('train_loss', 'val_loss', 'val_wer', 'train_wer'):
        assert name in metrics
    capsys.readouterr()
    assert train_cli.main(base + ['trainer.max_epochs=2', '--resume']) == 0
    assert 'Resumed from step 3' in capsys.readouterr().out
    assert Checkpointer(run_dir / 'checkpoints').latest_step() == 6
    losses = [float(l.split(',')[3]) for l in
              (run_dir / 'metrics.csv').read_text().splitlines()[1:]
              if l.split(',')[2] == 'train_loss']
    assert len(losses) == 6 and all(np.isfinite(losses))

    # evaluate.main takes the trained weights with the same overrides
    weights = tmp_path / 'sd.pt'
    torch.save(Checkpointer(run_dir / 'checkpoints').restore()['model'],
               weights)
    common = ['--test-manifest', manifest, '--device', 'cpu',
              '--batch-size', '2', *NARROW_QUARTZNET]
    assert port_eval.main(common + ['--weights', str(weights)]) == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(trained) == {'loss', 'num_utterances', 'cer', 'wer'}
    assert trained['num_utterances'] == 6 and np.isfinite(trained['loss'])
    model, fe, labels = port_eval.build('cpu', weights=str(weights),
                                        overrides=NARROW_QUARTZNET)
    assert isinstance(model, Jasper) and not model.training
    loader = make_loader(manifest, 2, fe, labels, prefetch=0)
    again = port_eval.evaluate(model, fe, loader, GreedyDecoder(labels),
                               'cpu')
    assert again == trained
    seeded, _, _ = port_eval.build('cpu', seed=5, overrides=NARROW_QUARTZNET)
    assert len(seeded.jasper_encoder) == 3
    assert port_eval.main(common + ['--seed', '5']) == 0
