"""Tensor parallelism of the port (``parallel/tp.py``) on the CPU.

Four gloo ranks (``tests/torch_tp_worker.py``, started once for the module
with torchrun's environment set by hand) are held against one process of
the port and against the JAX package's ``tests/test_tensor_parallel.py``
on its 8-device CPU mesh, from the same flax weights carried across with
``weights.state_dict_from_flax``, dropout off where the two are compared:

* ``make_mesh``'s data x model grid, its device order and the ``visible``
  error (JAX ``test_make_mesh_2d``); ``model_axis_spec``'s rule on JAX
  ``test_model_axis_spec_rules``' leaves and on every leaf of the JAX
  tests' Wav2Letter and Jasper models at model 2 and 4 (JAX shards a leaf
  exactly when the port shards its counterpart);
* data=2 x model=2, 3 SGD steps on the JAX tests' ``_cfg`` / ``_batch``,
  against JAX's (2, 2) mesh run and one port process (losses rtol 1e-5,
  parameters rtol 2e-4 atol 2e-6, JAX's own TP tolerance); the shards'
  layout after init and after a step (``[16, 32, 7]`` for JAX's
  ``(7, 32, 16)``, momenta alike, the head whole);
* checkpoints: a TP checkpoint restores bit-exact into one process and
  into data=4, and data=4's and one process's into TP;
* Jasper blocks (K4 on a channel slice, the fused K6/K7 unit with its
  depthwise weight gathered, grouped 1x1 convs with model above and below
  ``groups``, residual and dense-residual branches, a heads-folded conv),
  group, layer and instance norms, at model 2 and 4;
* ``train.main`` with ``trainer.mesh.model=2`` end to end against one
  process: ``gradient_clip_val`` with SGD and with NovoGrad,
  ``accumulate_grad_batches=2``, dither, dropout and SpecAugment on (the
  model=1 draws), the short last batch's masked rows all on the second
  replica, validation sums; a QuartzNet-style Jasper under remat; SIGTERM
  to one rank stops every rank at the same step, and one process resumes
  the TP checkpoint; ``evaluate.main`` on a TP run in one process;
* bf16 compute (``model.compute_dtype=bf16``): Wav2Letter (reflect and
  zeros) and QuartzNet at model=4 and data=2 x model=2 against one
  process in bf16 and JAX's bf16 model (``test_torch_bf16.py``'s
  ``assert_parallel_bf16``); bf16 column convs (``MaskedConv._column``,
  each grouping) equal to the one-process conv's columns, and their
  input gradients within the ranks' roundings of their partial sums.

JAX's ``test_tp_multi_step_dispatch`` has no counterpart:
``trainer.steps_per_dispatch`` stays refused (CUDA graphs are ROADMAP
A.3).
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tests.test_tensor_parallel import _batch as jax_batch
from tests.test_torch_bf16 import (PARALLEL_BF16, STEP_LOSS_RTOL,
                                   assert_parallel_bf16,
                                   assert_train_main_bf16,
                                   parallel_bf16_init, parallel_bf16_refs,
                                   ulps)
from tests.test_tensor_parallel import _make_trainer as jax_trainer
from tests.test_torch_parallel import (AUGMENT, JASPER_BLOCKS, W2L_LAYERS,
                                       _argv, _corpus, _latest, _metrics)
from tests.torch_parallel_worker import invariance_batch, invariance_trainer
from tests.torch_tp_worker import COLUMN_CASES, column_case
from wav2letter_pytorch_tpu.config import load_config as jax_load_config
from wav2letter_pytorch_tpu.parallel import make_mesh as jax_make_mesh
from wav2letter_pytorch_tpu.parallel import model_axis_spec as jax_spec
from wav2letter_pytorch_tpu.parallel import shard_batch
from wav2letter_pytorch_tpu.training import build_labels as jax_labels
from wav2letter_pytorch_tpu.training import build_model as jax_model
from wav2letter_pytorch_tpu_torch import evaluate as eval_cli
from wav2letter_pytorch_tpu_torch import parallel
from wav2letter_pytorch_tpu_torch import train as train_cli
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.parallel import tp
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_labels,
                                                         build_model)
from wav2letter_pytorch_tpu_torch.training.checkpoint import Checkpointer
from wav2letter_pytorch_tpu_torch.training.trainer import Trainer
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_tp_worker.py')
WORLD = 4
# JAX's TP tolerance (tests/test_tensor_parallel.py::test_tp_parity_vs_dp)
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-4, 2e-6
# train.main under TP vs one process (as tests/test_torch_parallel.py)
RUN_RTOL = 1e-5
# evaluate's loss on the TP run's weights vs the one-process run's
EVAL_RTOL = 1e-4


def _tp_cfg(data, model):
    """The port's overrides of the JAX tests' ``_cfg(tmp, data, model)``."""
    return ['data.train_manifest=x', 'data.val_manifest=y',
            'model.input_size=32', 'model.mid_layers=2',
            'model.layers=[{output_size: 32, kernel_size: 7, stride: 2, '
            'dilation: 1, dropout: 0.0}, {output_size: 32, kernel_size: 7, '
            'stride: 1, dilation: 1, dropout: 0.0}]',
            'trainer.string_metrics_interval=0',
            f'trainer.mesh.data={data}', f'trainer.mesh.model={model}']


# tests/test_tensor_parallel.py::test_tp_jasper_block_variants' blocks
JAX_JASPER = ('model.jasper_blocks=['
              '{layer_size: 32, kernel_size: 7, stride: 2, residual: false, '
              'separable: true}, '
              '{layer_size: 32, kernel_size: 7, stride: 1, residual: true, '
              'separable: true, groups: 2}, '
              '{layer_size: 64, kernel_size: 1, stride: 1, residual: false, '
              'separable: false}]')
# every Jasper unit kind: K4 + pointwise (stride 2), K4 + grouped pointwise
# (2 groups: model 2 one whole group a rank, model 4 half a group), fused
# K6/K7 repeats with a dense residual, grouped 48 -> 48 over 3 groups (a
# rank's slice straddles a group at model 2 and 4) with two dense panes,
# a 1x1 conv
BLOCKS = ('model.jasper_blocks=['
          '{layer_size: 32, kernel_size: 7, stride: 2, residual: false, '
          'separable: true}, '
          '{layer_size: 32, kernel_size: 7, stride: 1, residual: true, '
          'separable: true, groups: 2}, '
          '{layer_size: 48, kernel_size: 5, repeat: 2, residual: true, '
          'separable: true, residual_dense: true}, '
          '{layer_size: 48, kernel_size: 3, residual: true, separable: true, '
          'residual_dense: true, groups: 3}, '
          '{layer_size: 64, kernel_size: 1, residual: false, '
          'separable: false}]')
# norms: group with groups straddling the shards (3 of 48) and not (4),
# layer, instance, and a heads-folded depthwise conv
NORMS = ('model.jasper_blocks=['
         '{layer_size: 48, kernel_size: 7, stride: 2, residual: false, '
         'separable: true, normalization: group, norm_groups: 3}, '
         '{layer_size: 48, kernel_size: 5, residual: true, separable: true, '
         'normalization: layer}, '
         '{layer_size: 48, kernel_size: 5, residual: true, separable: true, '
         'heads: 16, normalization: group, norm_groups: 4}, '
         '{layer_size: 32, kernel_size: 1, residual: false, separable: false, '
         'normalization: instance}]')


def _jasper_cfg(blocks, n, data, model):
    return ['data.train_manifest=x', 'data.val_manifest=y', 'model=jasper',
            'model.input_size=32', f'model.mid_layers={n}', blocks,
            'trainer.string_metrics_interval=0',
            f'trainer.mesh.data={data}', f'trainer.mesh.model={model}']


JASPERS = {'jasper': (BLOCKS, 5), 'norms': (NORMS, 4)}


def _tp_train_cases(root):
    m6, m10 = _corpus(root, 6), _corpus(root, 10)
    tp2 = ['trainer.mesh.data=2', 'trainer.mesh.model=2']
    return {
        'w2l': (_argv(m6, '{run}', W2L_LAYERS, 'model.mid_layers=2',
                      'data.batch_size=4', 'trainer.max_epochs=2',
                      'trainer.accumulate_grad_batches=2',
                      'model.optimizer.lr=0.05',
                      'trainer.gradient_clip_val=0.05', AUGMENT), tp2),
        'qn': (_argv(m6, '{run}', 'model=quartznet', 'optimizer=novograd',
                     'model.mid_layers=3', JASPER_BLOCKS, 'model.remat=true',
                     'data.batch_size=4', 'trainer.max_epochs=1',
                     'trainer.gradient_clip_val=0.05', AUGMENT), tp2),
        'bf16': (_argv(m6, '{run}', W2L_LAYERS, 'model.mid_layers=2',
                       'data.batch_size=4', 'trainer.max_epochs=1',
                       'model.optimizer.lr=0.05',
                       'model.compute_dtype=bf16'), tp2),
        'sigterm': (_argv(m10, '{run}', W2L_LAYERS, 'model.mid_layers=2',
                          'data.batch_size=2', 'trainer.max_epochs=1',
                          'trainer.preempt_sync_every=3',
                          'model.optimizer.lr=0.05', AUGMENT), tp2),
    }


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _start(spec: dict, root) -> list:
    path = os.path.join(root, 'spec.json')
    with open(path, 'w') as f:
        json.dump(spec, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != 'WORLD_SIZE'}
    return [subprocess.Popen(
        [sys.executable, WORKER, path], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                 MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                 OMP_NUM_THREADS='1'),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def _wait(procs) -> None:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} exited {p.returncode}:\n{out}'


def _jax_run(tmp):
    """JAX's (2, 2) mesh run of test_tp_parity_vs_dp: (its initial
    variables as a port state dict, its 3 losses, its final variables as
    a port state dict)."""
    tr = jax_trainer(tmp, 2, 2)
    batch = jax_batch(8)
    tr.init_state(batch)
    init = state_dict_from_flax(jax.device_get(
        {'params': tr.state.params, 'batch_stats': tr.state.batch_stats}))
    step = tr._get_jitted('train')
    db = shard_batch(batch, tr.mesh)
    losses = []
    for _ in range(3):
        tr.state, loss, _, _ = step(tr.state, db)
        losses.append(float(loss))
    final = state_dict_from_flax(jax.device_get(
        {'params': tr.state.params, 'batch_stats': tr.state.batch_stats}))
    return init, losses, final


def _one_steps(overrides, init, run_dir, steps=3):
    tr = invariance_trainer(overrides, init, run_dir)
    batch = {k: torch.from_numpy(v) for k, v in invariance_batch().items()}
    losses = [float(tr.train_step(batch)[0]) for _ in range(steps)]
    state = tr.state_dict()
    tr.close()
    return tr, losses, state


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every 4-rank check in one launch, the one-process side computed
    while the ranks run."""
    root = str(tmp_path_factory.mktemp('tp'))
    jax_init, jax_losses, jax_final = _jax_run(os.path.join(root, 'jax'))
    inits = {'w2l': os.path.join(root, 'init_w2l.pt')}
    torch.save(jax_init, inits['w2l'])
    for name, (blocks, n) in JASPERS.items():
        cfg = load_config(_jasper_cfg(blocks, n, -1, 1))
        model = build_model(cfg['model'], len(build_labels(cfg['model'])))
        inits[name] = os.path.join(root, f'init_{name}.pt')
        torch.save(model.state_dict(), inits[name])
    # a one-process checkpoint after one step, for the restore into TP
    one_ck, _, _ = _one_steps(_tp_cfg(-1, 1), inits['w2l'],
                              os.path.join(root, 'one_ck'), steps=1)
    one_ck._save(one_ck.step)
    train = _tp_train_cases(root)
    steps = [{'kind': 'steps', 'name': 'tp_steps', 'model': 2, 'save': True,
              'overrides': _tp_cfg(2, 2), 'init': inits['w2l']}]
    for name, (blocks, n) in JASPERS.items():
        for m in (2, 4):
            steps.append({'kind': 'steps', 'name': f'{name}_m{m}',
                          'model': m, 'init': inits[name],
                          'overrides': _jasper_cfg(blocks, n, 4 // m, m)})
    bf16 = {name: parallel_bf16_init(name, root) for name in PARALLEL_BF16}
    steps += [{'kind': 'bf16', 'name': f'bf16_{name}_d{4 // m}m{m}',
               'model': m, 'init': case['init'],
               'overrides': case['overrides'] + [
                   f'trainer.mesh.data={4 // m}', f'trainer.mesh.model={m}']}
              for name, case in bf16.items() for m in (2, 4)]
    steps += [{'kind': 'columns', 'name': f'columns_m{m}', 'model': m}
              for m in (2, 4)]
    restores = [
        {'name': 'dp4_from_tp', 'model': 1, 'cfg': _tp_cfg(4, 1),
         'from': 'tp_steps', 'save': True},
        {'name': 'tp_from_dp4', 'model': 2, 'cfg': _tp_cfg(2, 2),
         'from': 'dp4_from_tp'},
        {'name': 'tp_from_one', 'model': 2, 'cfg': _tp_cfg(2, 2),
         'from': 'one_ck'}]
    spec = {'out': root, 'cases': steps + [
        {'kind': 'restore', 'name': r['name'], 'model': r['model'],
         'overrides': r['cfg'], 'init': inits['w2l'],
         'from': os.path.join(root, r['from']), 'save': r.get('save')}
        for r in restores] + [
        {'kind': 'train', 'name': name, 'model': 2,
         'argv': [a.replace('{run}', os.path.join(root, f'tp_{name}'))
                  for a in argv + extra],
         **({'kill_rank': 3, 'kill_at': 2} if name == 'sigterm' else {})}
        for name, (argv, extra) in train.items()]}
    procs = _start(spec, root)
    try:
        ones = {'w2l': _one_steps(_tp_cfg(-1, 1), inits['w2l'],
                                  os.path.join(root, 'one_w2l'))}
        for name, (blocks, n) in JASPERS.items():
            ones[name] = _one_steps(_jasper_cfg(blocks, n, -1, 1),
                                    inits[name],
                                    os.path.join(root, f'one_{name}'))
        for name, (argv, _) in train.items():
            run = os.path.join(root, f'one_{name}')
            assert train_cli.main([a.replace('{run}', run)
                                   for a in argv]) == 0
        for case in bf16.values():
            parallel_bf16_refs(case, root)
    finally:
        _wait(procs)
    return dict(root=root, ones=ones, jax=(jax_losses, jax_final),
                one_ck=os.path.join(root, 'one_ck'), train=train, bf16=bf16)


def _load(runs, name):
    return torch.load(os.path.join(runs['root'], f'{name}.pt'))


def _ranks(runs, name):
    return [json.load(open(os.path.join(runs['root'], f'{name}.rank{r}.json')))
            for r in range(WORLD)]


def _assert_params_close(got: dict, want: dict, rtol=PARAM_RTOL,
                         atol=PARAM_ATOL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if v.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                       atol=atol, err_msg=k)


def _assert_same_bits(got, want, path='state'):
    if torch.is_tensor(want):
        assert torch.is_tensor(got) and got.dtype == want.dtype, path
        assert torch.equal(got, want), path
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same_bits(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_bits(a, b, f'{path}[{i}]')
    else:
        assert got == want, path


# ---------------------------------------------------------------- meshes

def test_make_mesh_2d_is_jax_grid():
    """JAX test_make_mesh_2d: a 4 x 2 grid, -1 takes visible // model rows,
    the model index is the fast one, and 16 devices of 8 raise JAX's
    text."""
    ours, theirs = parallel.make_mesh(4, model=2, device='cpu'), \
        jax_make_mesh(4, model=2)
    assert ours.shape == dict(zip(theirs.axis_names, theirs.devices.shape))
    assert ours.axis_names == theirs.axis_names == ('data', 'model')
    # the model index is the fast one: JAX's entry (d, j) is device
    # d * 2 + j, the port's rank d * 2 + j is data index d, model index j
    # (test_train_main_under_tp_is_one_process checks the ranks' shards)
    ids = np.vectorize(lambda d: d.id)(theirs.devices)
    np.testing.assert_array_equal(ids - ids.min(), np.arange(8).reshape(4, 2))
    assert len(ours.devices) == 8
    assert parallel.data_extent(-1, 2, visible=8) == \
        jax_make_mesh(-1, model=2).devices.shape[0] == 4
    with pytest.raises(ValueError, match='visible') as e:
        jax_make_mesh(8, model=2)
    with pytest.raises(ValueError, match='visible') as f:
        parallel.data_extent(8, 2, visible=8)
    assert str(e.value) == str(f.value)
    assert parallel.make_mesh(device='cpu', model=2).shape == \
        {'data': 1, 'model': 2}
    grid = parallel.make_mesh(2, model=2, seq=2, device='cpu')
    assert grid.shape == {'data': 2, 'model': 2, 'seq': 2}
    assert grid.axis_names == jax_make_mesh(2, model=2, seq=2).axis_names


@pytest.mark.parametrize('torch_shape,flax_shape,dtype', [
    ((32, 32, 7), (7, 32, 32), np.float32),    # conv kernel: Cout
    ((32,), (32,), np.float32),                # bias / BN stat
    ((29, 32, 1), (1, 32, 29), np.float32),    # the 29-label head
    ((2,), (2,), np.uint32),                   # an RNG key
    ((), (), np.float32),                      # a scalar
    ((8,), (8,), np.float32),                  # too narrow to shard
])
def test_model_axis_spec_rules_as_jax(torch_shape, flax_shape, dtype):
    """JAX test_model_axis_spec_rules' leaves in the torch layout: the port
    shards dim 0 exactly where JAX shards the trailing dim."""
    want = jax_spec(np.zeros(flax_shape, dtype), 2)
    got = tp.model_axis_spec(np.zeros(torch_shape, dtype), 2)
    assert (got == 0) == (want != P()), (got, want)
    if got is not None:
        assert want == P(*([None] * (len(flax_shape) - 1) + ['model']))
    tensor = torch.zeros(torch_shape, dtype=torch.float32 if dtype ==
                         np.float32 else torch.int64)
    assert tp.model_axis_spec(tensor, 2) == got


def _flax_shapes(family):
    """(flax variable tree of ShapeDtypeStructs, jasper_blocks or None) of
    the JAX tests' Wav2Letter or Jasper model."""
    if family == 'w2l':
        cfg = jax_load_config(_tp_cfg(2, 2))
    else:
        cfg = jax_load_config(['data.train_manifest=x',
                               'data.val_manifest=y', 'model=jasper',
                               'model.input_size=32', 'model.mid_layers=3',
                               JAX_JASPER])
    model = jax_model(cfg.model, len(jax_labels(cfg.model)))
    x = jnp.zeros((1, 40, 32), jnp.float32)
    shapes = jax.eval_shape(lambda k: model.init(k, x, jnp.array([40]),
                                                 train=False),
                            jax.random.PRNGKey(0))
    blocks = None if family == 'w2l' else [
        dict(b) for b in cfg.model['jasper_blocks']][:3]
    return shapes, blocks


@pytest.mark.parametrize('m', [2, 4])
@pytest.mark.parametrize('family', ['w2l', 'jasper'])
def test_rule_shards_what_jax_shards(family, m):
    """Every flax leaf of the JAX tests' models, filled with 1 where JAX's
    model_axis_spec shards it and 0 where not, carried across with
    state_dict_from_flax: each port tensor is all 1 exactly where the
    port's rule shards it."""
    shapes, blocks = _flax_shapes(family)
    marked = jax.tree.map(
        lambda s: np.full(s.shape, float(jax_spec(s, m) != P()), np.float32),
        {'params': shapes['params'],
         'batch_stats': shapes.get('batch_stats', {})})
    sd = state_dict_from_flax(marked, blocks)
    cfg = load_config(_tp_cfg(-1, 1) if family == 'w2l' else _jasper_cfg(
        JAX_JASPER, 3, -1, 1))
    model = build_model(cfg['model'], len(build_labels(cfg['model'])))
    ours = model.state_dict()
    assert sd.keys() == ours.keys()
    sharded = 0
    for k, v in sd.items():
        if not v.is_floating_point():
            assert tp.model_axis_spec(ours[k], m) is None
            continue
        jax_shards = bool(v.flatten()[0])
        assert torch.all(v == v.flatten()[0])
        assert (tp.model_axis_spec(ours[k], m) == 0) == jax_shards, k
        sharded += jax_shards
    assert sharded > 0


# -------------------------------------------------------------- training

def test_tp_parity_vs_jax_and_one_process(runs):
    """data=2 x model=2, 3 SGD steps: the losses and parameters of JAX's
    (2, 2) mesh run and of one port process."""
    got = _load(runs, 'tp_steps')
    jax_losses, jax_final = runs['jax']
    _, one_losses, one_state = runs['ones']['w2l']
    np.testing.assert_allclose(got['losses'], jax_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got['losses'], one_losses, rtol=LOSS_RTOL)
    params = {k: v for k, v in got['state']['model'].items()
              if k in jax_final}
    _assert_params_close(params, jax_final)
    _assert_params_close(got['state']['model'], one_state['model'])


def test_tp_layout_after_init_and_step(runs):
    """Each rank holds half of every conv's Cout ([16, 32, 7], JAX's
    (7, 32, 16) shard), BN statistics alike; the momenta mirror the
    parameters after a step; the 29-label head stays whole."""
    for r, rec in enumerate(_ranks(runs, 'tp_steps')):
        for when in ('init', 'step1'):
            params = rec[when]['params']
            assert params['conv1ds.conv1d_0.conv1.weight'] == [16, 32, 7]
            assert params['conv1ds.conv1d_1.conv1.weight'] == [16, 32, 7]
            assert params['conv1ds.conv1d_0.batch_norm.weight'] == [16]
            assert params['conv1ds.conv1d_2.conv1.weight'] == [29, 32, 1]
            assert params['conv1ds.conv1d_2.conv1.bias'] == [29]
            assert rec[when]['buffers'][
                'conv1ds.conv1d_1.batch_norm.running_var'] == [16]
        assert rec['step1']['momenta'] == rec['step1']['params'], r
    # the gathered checkpoint is the model=1 layout
    state = _load(runs, 'tp_steps')['state']
    assert state['model']['conv1ds.conv1d_0.conv1.weight'].shape == \
        (32, 32, 7)


def test_tp_checkpoint_restores_bit_exact_across_topologies(runs):
    """A TP checkpoint loads strict into one process; data=4 restores it
    and TP restores data=4's and one process's, each to the bit."""
    root = runs['root']
    tp_ck = _latest(os.path.join(root, 'tp_steps'))
    tr = invariance_trainer(_tp_cfg(-1, 1), os.path.join(root,
                                                         'init_w2l.pt'),
                            os.path.join(root, 'restore_one'))
    tr.model.load_state_dict(tp_ck['model'], strict=True)
    tr.load_state_dict(tp_ck)
    _assert_same_bits(tr.state_dict(), tp_ck)
    tr.close()
    _assert_same_bits(_load(runs, 'dp4_from_tp')['state'], tp_ck)
    _assert_same_bits(_load(runs, 'tp_from_dp4')['state'],
                      _latest(os.path.join(root, 'dp4_from_tp')))
    _assert_same_bits(_load(runs, 'tp_from_one')['state'],
                      _latest(runs['one_ck']))


@pytest.mark.parametrize('m', [2, 4])
@pytest.mark.parametrize('name', ['jasper', 'norms'])
def test_jasper_and_norms_under_tp(runs, name, m):
    """Jasper's block kinds (``BLOCKS``) and norms (``NORMS``) at model m
    (data 4 / m): 3 SGD steps against one process."""
    got = _load(runs, f'{name}_m{m}')
    _, one_losses, one_state = runs['ones'][name]
    np.testing.assert_allclose(got['losses'], one_losses, rtol=LOSS_RTOL)
    _assert_params_close(got['state']['model'], one_state['model'])
    rec = _ranks(runs, f'{name}_m{m}')[0]['init']['params']
    full = one_state['model']
    shards = [k for k, s in rec.items() if list(full[k].shape) != s]
    assert shards and all(rec[k][0] * m == full[k].shape[0] for k in shards)


@pytest.mark.parametrize('name', ['w2l', 'qn'])
def test_train_main_under_tp_is_one_process(runs, name):
    """``train.main`` with data=2 x model=2 against one process: every
    logged train loss, WER, CER and learning rate, and the final weights,
    BN statistics and optimizer state. W2L: SGD, a gradient clip,
    accumulate_grad_batches=2, dither, dropout and SpecAugment, the last
    batch's masked rows all on the second replica. QN: remat, NovoGrad
    (per-tensor norms over the model group) and a gradient clip, K4-K7's
    plain versions. (W2L's conv biases sit before BatchNorm, so their
    gradients are rounding noise, which NovoGrad's normalised step would
    blow up to the step's size: NovoGrad is held on the bias-free
    Jasper.)"""
    root = runs['root']
    tp_run, one = (os.path.join(root, f'{k}_{name}') for k in ('tp', 'one'))
    got, want = _metrics(tp_run), _metrics(one)
    for metric in ('train_loss', 'train_wer', 'train_cer', 'learning_rate'):
        assert got[metric].keys() == want[metric].keys()
        for step, v in want[metric].items():
            assert got[metric][step] == pytest.approx(v, rel=RUN_RTOL,
                                                      abs=1e-12), \
                (metric, step)
    ranks = [json.load(open(os.path.join(root, f'{name}.rank{r}.json')))
             for r in range(WORLD)]
    assert all(r['rc'] == 0 and r['stopped_reason'] is None for r in ranks)
    # the ranks of one model index hold the same shards
    assert ranks[0]['checksum'] == ranks[2]['checksum']
    assert ranks[1]['checksum'] == ranks[3]['checksum']
    a, b = _latest(tp_run), _latest(one)
    assert a['step'] == b['step'] == ranks[0]['step']
    _assert_params_close(a['model'], b['model'], RUN_RTOL,
                         RUN_RTOL * max(float(v.abs().max())
                                        for v in b['model'].values()
                                        if v.is_floating_point()))
    assert a['optimizer']['state'].keys() == b['optimizer']['state'].keys()
    for i, st in b['optimizer']['state'].items():
        for k, v in st.items():
            assert a['optimizer']['state'][i][k].shape == v.shape
    assert os.listdir(os.path.join(tp_run, 'checkpoints')) == os.listdir(
        os.path.join(one, 'checkpoints'))


@pytest.mark.parametrize('name', ['w2l', 'qn'])
def test_validation_sums_under_tp(runs, name):
    """Validation with data=2 x model=2 (each replica scores its rows,
    the sums reduced over the data group only) logs one process's
    numbers."""
    root = runs['root']
    got = _metrics(os.path.join(root, f'tp_{name}'))
    want = _metrics(os.path.join(root, f'one_{name}'))
    for metric in ('val_loss', 'val_wer', 'val_cer', 'val_len_ratio'):
        assert got[metric].keys() == want[metric].keys()
        for step, v in want[metric].items():
            assert got[metric][step] == pytest.approx(v, rel=RUN_RTOL,
                                                      abs=1e-12)


def test_sigterm_to_one_tp_rank_stops_every_rank(runs):
    """Rank 3 alone gets SIGTERM after step 2; with preempt_sync_every=3
    all four ranks stop at step 3 with one checkpoint, which one process
    (trainer.mesh.model=1) resumes to the weights of an uninterrupted
    one-process run."""
    root = runs['root']
    tp_run = os.path.join(root, 'tp_sigterm')
    ranks = [json.load(open(os.path.join(root, f'sigterm.rank{r}.json')))
             for r in range(WORLD)]
    assert [(r['rc'], r['stopped_reason'], r['step']) for r in ranks] == \
        [(0, 'signal', 3)] * WORLD
    ck = Checkpointer(os.path.join(tp_run, 'checkpoints'))
    assert ck.all_steps() == [3]
    assert ck.load_extra() == {'epoch': 0, 'epoch_step': 3,
                               'preempted': True}
    argv, _ = runs['train']['sigterm']
    assert train_cli.main([a.replace('{run}', tp_run) for a in argv]
                          + ['--resume']) == 0
    a, b = _latest(tp_run), _latest(os.path.join(root, 'one_sigterm'))
    assert a['step'] == b['step'] == 5
    scale = max(float(v.abs().max()) for v in b['model'].values()
                if v.is_floating_point())
    _assert_params_close(a['model'], b['model'], RUN_RTOL, RUN_RTOL * scale)


def test_evaluate_a_tp_run_in_one_process(runs, tmp_path, capsys):
    """``evaluate.main --model-path`` on a TP run (its config.json holds
    trainer.mesh.model=2) in one process: the checkpoint is whole, so it
    gives the bits of the same run saved with model=1, and the
    one-process run's loss within EVAL_RTOL (the two runs' weights differ
    by float32 rounding)."""
    root = runs['root']
    tp_run = os.path.join(root, 'tp_w2l')
    with open(os.path.join(tp_run, 'config.json')) as f:
        assert json.load(f)['trainer']['mesh']['model'] == 2
    twin = str(tmp_path / 'twin')
    shutil.copytree(tp_run, twin)
    with open(os.path.join(twin, 'config.json')) as f:
        cfg = json.load(f)
    cfg['trainer']['mesh'].update(data=-1, model=1)
    with open(os.path.join(twin, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    manifest = runs['train']['w2l'][0][0].partition('=')[2]
    out = {}
    for name, run in (('tp', tp_run), ('twin', twin),
                      ('one', os.path.join(root, 'one_w2l'))):
        dump = str(tmp_path / f'{name}.jsonl')
        capsys.readouterr()
        assert eval_cli.main(['--model-path', run, '--test-manifest',
                              manifest, '--device', 'cpu', '--dump-jsonl',
                              dump]) == 0
        with open(dump) as f:
            out[name] = (f.read(), json.loads(
                capsys.readouterr().out.strip().splitlines()[-1]))
    assert out['tp'] == out['twin']
    assert out['tp'][1]['loss'] == pytest.approx(out['one'][1]['loss'],
                                                 rel=EVAL_RTOL)


def test_tp_without_a_process_group_stops(tmp_path, monkeypatch):
    """trainer.mesh.model=2 without torchrun names the launch; a Trainer
    asked for model=2 outside a model group raises: nothing trains
    unsharded."""
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    manifest = _corpus(str(tmp_path), 4)
    with pytest.raises(SystemExit, match='torchrun --nproc-per-node 2'):
        train_cli.main(_argv(manifest, tmp_path / 'r',
                             'trainer.mesh.model=2'))
    with pytest.raises(SystemExit, match='torchrun --nproc-per-node 4'):
        train_cli.main(_argv(manifest, tmp_path / 'r',
                             'trainer.mesh.data=2', 'trainer.mesh.model=2'))
    monkeypatch.setenv('WORLD_SIZE', '4')
    with pytest.raises(SystemExit, match='WORLD_SIZE=4'):
        train_cli.main(_argv(manifest, tmp_path / 'r',
                             'trainer.mesh.data=4', 'trainer.mesh.model=2'))
    cfg = load_config(_tp_cfg(-1, 2))
    model = build_model(cfg['model'], len(build_labels(cfg['model'])))
    with pytest.raises(ValueError, match='model groups of 1'):
        Trainer(cfg, model, build_frontend(cfg['model']), None, None, None,
                device='cpu', run_dir=str(tmp_path / 't'))


# ------------------------------------------------------------------ bf16

@pytest.mark.parametrize('grid', ['d2m2', 'd1m4'])
@pytest.mark.parametrize('name', sorted(PARALLEL_BF16))
def test_bf16_under_tp(runs, name, grid):
    """bf16 compute at model=4 and data=2 x model=2: eval-mode log-probs
    within one bf16 ulp of one process in bf16 (in fact equal), one SGD
    step's loss and update from the shared initial weights at
    ``assert_parallel_bf16``'s bars, and JAX's one-process bf16 model on
    the same weights at ``test_torch_bf16.py``'s."""
    assert_parallel_bf16(_load(runs, f'bf16_{name}_{grid}'),
                         runs['bf16'][name])


def test_train_main_bf16_under_tp(runs, tmp_path, capsys):
    """``train.main`` with model.compute_dtype=bf16 at data=2 x model=2
    against the same run in one process (``assert_train_main_bf16``: the
    losses, a float32 checkpoint that loads strict=True into one process,
    the update); ``evaluate.main --model-path`` on the TP run in one
    process gives one process's loss at the same bar."""
    root = runs['root']
    tp_run, one = (os.path.join(root, f'{k}_bf16') for k in ('tp', 'one'))
    assert_train_main_bf16(tp_run, one)
    ranks = _ranks_json(root, 'bf16')
    assert all(r['rc'] == 0 and r['stopped_reason'] is None for r in ranks)
    manifest = runs['train']['bf16'][0][0].partition('=')[2]
    losses = []
    for run in (tp_run, one):
        capsys.readouterr()
        assert eval_cli.main(['--model-path', run, '--test-manifest',
                              manifest, '--device', 'cpu']) == 0
        losses.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])['loss'])
    assert losses[0] == pytest.approx(losses[1], rel=STEP_LOSS_RTOL)


def _ranks_json(root, name):
    return [json.load(open(os.path.join(root, f'{name}.rank{r}.json')))
            for r in range(WORLD)]


def _half_ulps(t: torch.Tensor) -> torch.Tensor:
    """Half the bf16 spacing at each element of ``t``."""
    mag = t.float().abs().clamp(min=2.0 ** -126)
    return 2.0 ** (torch.floor(torch.log2(mag)) - 8)


@pytest.mark.parametrize('i', range(len(COLUMN_CASES)))
@pytest.mark.parametrize('m', [2, 4])
def test_bf16_columns_and_their_partial_sums(runs, m, i):
    """``MaskedConv._column`` in bf16 at model m (``COLUMN_CASES[i]``: one
    group, a rank inside a group, slices straddling groups, whole groups
    a rank, a bias): the ranks' columns gathered are the one-process bf16
    conv's output within one bf16 ulp (in fact equal). Its input
    gradient is the ranks' partial gradients, each rounded to bf16 by
    its conv's backward, summed in float32 (``tp.copy_to_model``), where
    one process rounds the whole sum once: it must lie within the half
    ulps of those roundings (each partial's and the one-process
    gradient's) of one process's, plus float32 slack."""
    rec = _load(runs, f'columns_m{m}')[i]
    conv, x, g = column_case(i)
    x.requires_grad_()
    y, _ = conv(x, None)
    (y.float() * g).sum().backward()
    assert rec['y'].dtype == y.dtype == torch.bfloat16
    assert int(ulps(rec['y'], y.detach()).max()) <= 1
    parts = rec['partials'].float()
    assert parts.shape[0] == m
    np.testing.assert_allclose(rec['dx'].numpy(), parts.sum(0).numpy(),
                               rtol=1e-6, atol=1e-6)
    bound = (_half_ulps(parts).sum(0) + _half_ulps(x.grad)
             + 1e-6 * parts.abs().sum(0))
    assert bool(((rec['dx'] - x.grad).abs() <= bound).all())
