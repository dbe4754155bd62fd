"""Sequence parallelism of the port (``parallel/sp.py``) on the CPU.

Four gloo ranks (``tests/torch_sp_worker.py``, started once for the module
with torchrun's environment set by hand, one thread each) are held
against one process of the port and against the JAX package's
``tests/test_seq_parallel.py`` on its 8-device CPU mesh, from the same
flax weights carried across with ``weights.state_dict_from_flax``:

* (g) ``make_mesh`` / ``data_extent`` with a ``seq`` axis: JAX's shapes,
  axis names, device order and ``visible`` error text;
* (f) one process playing S ranks: ``time_partition`` and the halo plan
  of ``sp.conv_input`` against the unsharded conv and its input gradient
  (hypothesis over T, kernel, stride, dilation, S and reflect / zeros);
* (a) Wav2Letter on JAX's ``_cfg`` / ``_batch(4)`` at data=2 x seq=2:
  the eval step at init (loss, greedy ids) and 3 SGD steps against JAX's
  (data=2, seq=4) run and one port process, at JAX's bars (loss rel
  2e-4, parameters 2e-4 abs, ids identical);
* (b) a Jasper with a stride-2 C1 (K4 / K5) and a dilated block of fused
  separable units (K6 / K7) whose halo spans more than one rank, under
  remat, at seq=2 and seq=4 on 31 frames (not divisible by S);
* (c) the data x model x seq grid, 1 x 2 x 2, against JAX's (2, 2, 2) run
  and one process;
* (d) group (straddling the channel shards), layer and instance norms and
  a heads-folded conv at seq=2 and at model=2 x seq=2;
* the whole depth of W2L-20 (1/8 width) in float64 at seq=4: loss and
  gradients one process's to rounding;
* (e) ``train.main`` with ``trainer.mesh.data=2 trainer.mesh.seq=2`` on
  JAX's ``test_sp_train_cli`` corpus, dropout and SpecAugment on, against
  one process; its checkpoint loads strict into one process and
  ``evaluate.main --model-path`` scores it;
* bf16 compute (``model.compute_dtype=bf16``): Wav2Letter (reflect and
  zeros) and QuartzNet at data=2 x seq=2 and 1 x 2 x 2 against one
  process in bf16 and JAX's bf16 model (``test_torch_bf16.py``'s
  ``assert_parallel_bf16``), with float32 halos.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings, strategies as st

import jax

from tests.test_seq_parallel import _batch as jax_batch
from tests.test_seq_parallel import _make_trainer as jax_trainer
from tests.test_torch_parallel import AUGMENT, _latest, _metrics
from tests.test_torch_tensor_parallel import NORMS, _assert_params_close
from tests.test_torch_bf16 import (PARALLEL_BF16, STEP_LOSS_RTOL,
                                   assert_parallel_bf16,
                                   assert_train_main_bf16,
                                   parallel_bf16_init, parallel_bf16_refs)
from tests.test_train_e2e import _make_corpus
from tests.torch_parallel_worker import invariance_trainer
from tests.torch_sp_worker import grad64_case
from wav2letter_pytorch_tpu.parallel import make_mesh as jax_make_mesh
from wav2letter_pytorch_tpu.parallel import shard_batch
from wav2letter_pytorch_tpu_torch import evaluate as eval_cli
from wav2letter_pytorch_tpu_torch import parallel
from wav2letter_pytorch_tpu_torch import train as train_cli
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.parallel import sp
from wav2letter_pytorch_tpu_torch.training import trainer as trainer_mod
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_labels,
                                                         build_model)
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_sp_worker.py')
WORLD = 4
# JAX's bars (tests/test_seq_parallel.py::test_sp_parity_vs_dp)
LOSS_RTOL, PARAM_ATOL = 2e-4, 2e-4
# train.main under SP vs one process (as tests/test_torch_parallel.py)
RUN_RTOL = 1e-5
# JAX's _cfg: two layers, k=13 s=2 and k=7 d=2
W2L = ['data.train_manifest=x', 'data.val_manifest=y',
       'model.input_size=32', 'model.mid_layers=2',
       'model.layers=[{output_size: 32, kernel_size: 13, stride: 2, '
       'dilation: 1, dropout: 0.0}, {output_size: 32, kernel_size: 7, '
       'stride: 1, dilation: 2, dropout: 0.0}]',
       'trainer.string_metrics_interval=0']
# a stride-2 C1 (K4 / K5, 5 frames of halo), then two fused separable
# units of k=13, d=2 (K6 / K7, 12 frames a side: more than a rank's 7-8
# of 31 at seq=4) with a residual, then a 1x1 block
JASPER = ('model.jasper_blocks=['
          '{layer_size: 32, kernel_size: 11, stride: 2, residual: false, '
          'separable: true}, '
          '{layer_size: 32, kernel_size: 13, dilation: 2, repeat: 2, '
          'residual: true, separable: true}, '
          '{layer_size: 48, kernel_size: 1, residual: false, '
          'separable: false}]')
JASPER_T = 9600          # samples: 61 frames, 31 after C1


def _mesh(data, model, seq):
    return [f'trainer.mesh.data={data}', f'trainer.mesh.model={model}',
            f'trainer.mesh.seq={seq}']


def _jasper_cfg(blocks, n, data, model, seq):
    return ['data.train_manifest=x', 'data.val_manifest=y', 'model=jasper',
            'model.input_size=32', f'model.mid_layers={n}', blocks,
            'model.remat=true', 'trainer.string_metrics_interval=0',
            *_mesh(data, model, seq)]


JASPERS = {'jasper': (JASPER, 3), 'norms': (NORMS, 4)}


def _jasper_batch(B=4, t=JASPER_T):
    rng = np.random.default_rng(1)
    lengths = np.array([t, t - 1600, t - 320, t - 3200], np.int32)[:B]
    return dict(
        audio=(rng.standard_normal((B, t)) * 0.1).astype(np.float32),
        audio_lengths=lengths,
        targets=rng.integers(1, 29, size=(B, 6)).astype(np.int32),
        target_lengths=np.full((B,), 6, np.int32),
        batch_mask=np.ones((B,), np.float32))


def _cli_argv(manifest, run):
    """JAX's test_sp_train_cli run, with SpecAugment and every step
    logged."""
    return [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', 'data.batch_size=2',
            'data.num_length_buckets=1', 'model.input_size=32',
            'model.layers=[{output_size: 24, kernel_size: 7, stride: 2, '
            'dilation: 1, dropout: 0.1}]',
            'trainer.string_metrics_interval=0', 'trainer.max_epochs=2',
            'trainer.log_every_n_steps=1', AUGMENT,
            f'trainer.default_root_dir={run}', '--device', 'cpu']


BF16_CLI = ['model.compute_dtype=bf16', 'trainer.max_epochs=1']


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


def _variables(tr):
    return state_dict_from_flax(jax.device_get(
        {'params': tr.state.params, 'batch_stats': tr.state.batch_stats}))


def _jax_runs(tmp):
    """JAX's (data=2, seq=4) run (init, eval loss and ids at init, 3
    losses, final variables) and its (2, 2, 2) run (init, losses,
    final), as port state dicts."""
    batch = jax_batch(4)
    out = {}
    for name, (data, seq, model) in (('seq', (2, 4, 1)),
                                     ('3d', (2, 2, 2))):
        tr = jax_trainer(tmp, data, seq, model)
        tr.init_state(batch)
        db = shard_batch(batch, tr.mesh)
        run = {'init': _variables(tr)}
        if name == 'seq':
            loss, ids, _ = tr._get_jitted('eval')(tr.state, db)
            run['eval'] = (float(loss), np.asarray(ids))
        step = tr._get_jitted('train')
        losses = []
        for _ in range(3):
            tr.state, loss, _, _ = step(tr.state, db)
            losses.append(float(loss))
        run['losses'], run['final'] = losses, _variables(tr)
        out[name] = run
    return batch, out


def _one_steps(overrides, init, batch, run_dir, evaluate=False):
    tr = invariance_trainer(overrides, init, run_dir)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    if evaluate:
        tr.model.eval()
        loss, ids, _ = trainer_mod.eval_step(tr.model, tr.frontend, b)
        out['eval_loss'], out['eval_ids'] = float(loss), ids
    out['losses'] = [float(tr.train_step(b)[0]) for _ in range(3)]
    out['state'] = tr.state_dict()
    tr.close()
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every 4-rank check in one launch, the one-process side computed
    while the ranks run."""
    root = str(tmp_path_factory.mktemp('sp'))
    batch, jax_runs = _jax_runs(os.path.join(root, 'jax'))
    batches = {'w2l': os.path.join(root, 'w2l.npz'),
               'jasper': os.path.join(root, 'jasper.npz')}
    np.savez(batches['w2l'], **batch)
    np.savez(batches['jasper'], **_jasper_batch())
    inits = {'w2l': os.path.join(root, 'init_w2l.pt')}
    torch.save(jax_runs['seq']['init'], inits['w2l'])
    for name, (blocks, n) in JASPERS.items():
        cfg = load_config(_jasper_cfg(blocks, n, -1, 1, 1))
        model = build_model(cfg['model'], len(build_labels(cfg['model'])))
        inits[name] = os.path.join(root, f'init_{name}.pt')
        torch.save(model.state_dict(), inits[name])
    manifest = _make_corpus(tmp_path_factory.mktemp('sp_corpus'), n=4,
                            seed=3)
    steps = [
        {'name': 'w2l_d2s2', 'model': 1, 'seq': 2, 'eval': True,
         'overrides': W2L + _mesh(2, 1, 2), 'init': inits['w2l'],
         'batch': batches['w2l']},
        {'name': 'w2l_d1m2s2', 'model': 2, 'seq': 2,
         'overrides': W2L + _mesh(1, 2, 2), 'init': inits['w2l'],
         'batch': batches['w2l']}]
    for name, (blocks, n) in JASPERS.items():
        for data, model, seq in ((2, 1, 2), (1, 1, 4), (1, 2, 2)):
            if name == 'jasper' and model > 1:
                continue
            steps.append({'name': f'{name}_d{data}m{model}s{seq}',
                          'model': model, 'seq': seq, 'init': inits[name],
                          'batch': batches['jasper'],
                          'overrides': _jasper_cfg(blocks, n, data, model,
                                                   seq)})
    bf16 = {name: parallel_bf16_init(name, root) for name in PARALLEL_BF16}
    spec = {'out': root, 'cases': [dict(c, kind='steps') for c in steps] + [
        {'kind': 'bf16', 'name': f'bf16_{name}_d{d}m{m}s2', 'model': m,
         'seq': 2, 'init': case['init'],
         'overrides': case['overrides'] + _mesh(d, m, 2)}
        for name, case in bf16.items() for d, m in ((2, 1), (1, 2))] + [
        {'kind': 'grad64', 'name': 'grad64', 'model': 1, 'seq': 4},
        {'kind': 'train', 'name': 'cli', 'model': 1, 'seq': 2,
         'argv': _cli_argv(manifest, os.path.join(root, 'sp_cli'))
         + _mesh(2, 1, 2)},
        {'kind': 'train', 'name': 'cli_bf16', 'model': 1, 'seq': 2,
         'argv': _cli_argv(manifest, os.path.join(root, 'sp_cli_bf16'))
         + BF16_CLI + _mesh(2, 1, 2)}]}
    procs = _start(spec, root)
    try:
        ones = {'w2l': _one_steps(W2L, inits['w2l'], batch,
                                  os.path.join(root, 'one_w2l'), True)}
        jb = _jasper_batch()
        for name, (blocks, n) in JASPERS.items():
            ones[name] = _one_steps(_jasper_cfg(blocks, n, -1, 1, 1),
                                    inits[name], jb,
                                    os.path.join(root, f'one_{name}'))
        assert train_cli.main(_cli_argv(manifest,
                                        os.path.join(root, 'one_cli'))) == 0
        assert train_cli.main(_cli_argv(manifest, os.path.join(
            root, 'one_cli_bf16')) + BF16_CLI) == 0
        for case in bf16.values():
            parallel_bf16_refs(case, root)
    finally:
        _wait(procs)
    return dict(root=root, ones=ones, jax=jax_runs, manifest=manifest,
                bf16=bf16)


def _load(runs, name):
    return torch.load(os.path.join(runs['root'], f'{name}.pt'))


def _assert_run(got, want_losses, want_state, rtol=LOSS_RTOL,
                atol=PARAM_ATOL):
    np.testing.assert_allclose(got['losses'], want_losses, rtol=rtol)
    params = {k: v for k, v in got['state']['model'].items()
              if k in want_state}
    assert params.keys() == want_state.keys()
    _assert_params_close(params, want_state, rtol=0.0, atol=atol)


# ---------------------------------------------------------------- meshes

def test_make_mesh_seq_is_jax_grid():
    """(g) JAX test_make_mesh_seq_axes: (2, 4) and (2, 2, 2) grids, the
    axis names, JAX's device order (rank (d*model + j)*seq + s is JAX's
    device at [d, j, s]) and the ``visible`` error text."""
    for args in ({'seq': 4}, {'model': 2, 'seq': 2}, {'model': 2}):
        ours, theirs = (parallel.make_mesh(2, device='cpu', **args),
                        jax_make_mesh(2, **args))
        assert ours.axis_names == theirs.axis_names
        assert tuple(ours.shape.values()) == theirs.devices.shape
        assert ours.size == theirs.devices.size
        model, seq = args.get('model', 1), args.get('seq', 1)
        ids = np.vectorize(lambda d: d.id)(theirs.devices)
        ids = (ids - ids.min()).reshape(2, model, seq)
        groups = parallel.grid_ranks(8, model, seq)
        for d in range(2):
            for j in range(model):
                assert groups['seq'][d * model + j] == list(ids[d, j])
    with pytest.raises(ValueError, match='visible') as e:
        jax_make_mesh(4, seq=4)
    with pytest.raises(ValueError, match='visible') as f:
        parallel.data_extent(4, 1, 4, visible=8)
    assert str(e.value) == str(f.value)
    assert parallel.data_extent(-1, 2, 2, visible=8) == \
        jax_make_mesh(-1, model=2, seq=2).devices.shape[0] == 2
    assert parallel.make_mesh(device='cpu', seq=2).shape == \
        {'data': 1, 'seq': 2}


def test_grid_groups_cover_the_world():
    """Every rank of a 2 x 2 x 2 grid is in one group of each kind; the
    data group holds one rank a data index, the replica group every data
    and seq index of one model index; with seq=1 the layout is the data x
    model one of tensor parallelism."""
    g = parallel.grid_ranks(8, 2, 2)
    for kind, size in (('model', 2), ('seq', 2), ('data', 2),
                       ('replica', 4)):
        flat = sorted(r for grp in g[kind] for r in grp)
        assert flat == list(range(8)) and all(len(x) == size
                                              for x in g[kind])
    assert g['replica'] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert g['data'] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    tp = parallel.grid_ranks(8, 2, 1)
    assert tp['model'] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert tp['data'] == tp['replica'] == [[0, 2, 4, 6], [1, 3, 5, 7]]


# ---------------------------------------------------------- halo plans

def test_time_partition():
    """(f) contiguous ranges covering [0, T) in rank order, sizes at most
    one apart, for T below, at and above S."""
    for T in range(0, 40):
        for S in (1, 2, 3, 4, 7):
            parts = sp.time_partition(T, S)
            assert parts[0][0] == 0 and parts[-1][1] == T
            assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
            sizes = [hi - lo for lo, hi in parts]
            assert max(sizes) - min(sizes) <= 1


def _simulate(T, S, kernel, stride, dilation, mode, seed=0):
    """One process playing S ranks of ``sp.conv_input``: the sharded conv
    and its input gradient against the unsharded ones (float64)."""
    gen = torch.Generator().manual_seed(seed)
    span = dilation * (kernel - 1) + 1
    out = -(-T // stride)
    pad = max(0, (out - 1) * stride + span - T)
    left, right = pad // 2, pad - pad // 2
    x = torch.randn(2, 3, T, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(4, 3, kernel, generator=gen, dtype=torch.float64)
    fill = 'reflect' if mode == 'reflect' else 'constant'
    y = F.conv1d(F.pad(x, (left, right), mode=fill), w, stride=stride,
                 dilation=dilation)
    g = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    dx_want, = torch.autograd.grad(y, x, g)
    wants, t_out = sp.conv_wants(T, S, kernel, stride, dilation, left,
                                 right)
    assert t_out == y.shape[-1]
    plan = sp.halo_plan(T, S, wants, mode)
    shards = [x.detach()[..., lo:hi].movedim(2, 0) for lo, hi in plan.parts]
    sent = torch.cat([sp.halo_pack(s, plan, r) for r, s in enumerate(shards)])
    dxs, remotes = [], []
    for r, (lo, hi) in enumerate(sp.time_partition(t_out, S)):
        h = sp.halo_unpack(shards[r], sent if plan.width else None, plan, r)
        h = h.movedim(0, 2).requires_grad_()
        y_r = F.conv1d(h, w, stride=stride, dilation=dilation)
        torch.testing.assert_close(y_r, y[..., lo:hi], rtol=1e-12,
                                   atol=1e-12)
        gh, = torch.autograd.grad(y_r, h, g[..., lo:hi])
        dx, remote = sp.halo_grad(gh.movedim(2, 0), plan, r)
        dxs.append(dx)
        remotes.append(remote)
    summed = sum(remotes) if plan.width else None
    dx = torch.cat([sp.halo_grad_finish(d, summed, plan, r)
                    for r, d in enumerate(dxs)]).movedim(0, 2)
    torch.testing.assert_close(dx, dx_want, rtol=1e-12, atol=1e-12)
    return plan


def test_halo_spans_several_ranks():
    """QuartzNet's last block (k=87, d=2: 86 frames a side) on 38 frames
    over 4 ranks, and W2L-20's k=29, d=2 layers with reflect: halos reach
    past the next rank; reflect at the global edge reads frames held by
    another rank."""
    plan = _simulate(38, 4, 87, 1, 2, 'zeros')
    assert plan.width > 38 // 4
    _simulate(38, 4, 29, 1, 2, 'reflect')
    plan = _simulate(9, 3, 9, 1, 1, 'reflect')   # rank 0 mirrors 1..4
    assert plan.pieces[1][0][1] - plan.pieces[1][0][0] >= 1


@settings(max_examples=60, deadline=None, database=None)
@given(T=st.integers(4, 70), S=st.integers(1, 5),
       kernel=st.integers(1, 31), stride=st.integers(1, 3),
       dilation=st.integers(1, 3), mode=st.sampled_from(['reflect',
                                                        'zeros']))
def test_halo_plan_is_the_unsharded_conv(T, S, kernel, stride, dilation,
                                         mode):
    """(f) any T, kernel, stride, dilation and S with at least one output
    frame a rank; reflect where the padding is below T (F.pad's
    limit)."""
    span = dilation * (kernel - 1) + 1
    out = -(-T // stride)
    pad = max(0, (out - 1) * stride + span - T)
    if out < S or (mode == 'reflect' and pad - pad // 2 >= T):
        return
    _simulate(T, S, kernel, stride, dilation, mode)


def test_conv_wants_refuses_an_empty_rank():
    with pytest.raises(ValueError, match='at least 4 output frames'):
        sp.conv_wants(6, 4, 3, 2, 1, 1, 1)


# -------------------------------------------------------------- training

def test_sp_w2l_parity_vs_jax_and_one_process(runs):
    """(a) data=2 x seq=2, 3 SGD steps: the losses and parameters of JAX's
    (data=2, seq=4) run and of one port process."""
    got = _load(runs, 'w2l_d2s2')
    jax_run = runs['jax']['seq']
    _assert_run(got, jax_run['losses'], jax_run['final'])
    one = runs['ones']['w2l']
    _assert_run(got, one['losses'], one['state']['model'])


def test_sp_eval_parity(runs):
    """(a) the eval step at init: loss within rel 2e-4 of JAX's seq run
    and of one process, greedy ids identical."""
    got = _load(runs, 'w2l_d2s2')
    jax_loss, jax_ids = runs['jax']['seq']['eval']
    one = runs['ones']['w2l']
    assert got['eval_loss'] == pytest.approx(jax_loss, rel=LOSS_RTOL)
    assert got['eval_loss'] == pytest.approx(one['eval_loss'], rel=LOSS_RTOL)
    np.testing.assert_array_equal(got['eval_ids'].numpy(), jax_ids)
    np.testing.assert_array_equal(got['eval_ids'].numpy(),
                                  one['eval_ids'].numpy())


def test_sp_3d_grid(runs):
    """(c) data=1 x model=2 x seq=2 on 4 ranks: JAX's (2, 2, 2) run (from
    the same initial weights) and one process."""
    jax_run = runs['jax']['3d']
    init = runs['jax']['seq']['init']
    assert all(torch.equal(jax_run['init'][k], v) for k, v in init.items())
    got = _load(runs, 'w2l_d1m2s2')
    _assert_run(got, jax_run['losses'], jax_run['final'])
    one = runs['ones']['w2l']
    _assert_run(got, one['losses'], one['state']['model'])


@pytest.mark.parametrize('grid', ['d2m1s2', 'd1m1s4'])
def test_sp_jasper(runs, grid):
    """(b) K4 on the haloed C1, K6 / K7 on the haloed dilated units
    (halos past the next rank at seq=4), under remat, on 31 frames: 3
    SGD steps against one process."""
    got = _load(runs, f'jasper_{grid}')
    one = runs['ones']['jasper']
    _assert_run(got, one['losses'], one['state']['model'])


@pytest.mark.parametrize('grid', ['d2m1s2', 'd1m1s4', 'd1m2s2'])
def test_sp_norms(runs, grid):
    """(d) group (3 groups of 48: straddling the channel shards at
    model=2), layer and instance norms and a heads-folded conv, their
    time statistics combined over the seq group: 3 SGD steps against one
    process."""
    got = _load(runs, f'norms_{grid}')
    one = runs['ones']['norms']
    _assert_run(got, one['losses'], one['state']['model'])


def test_sp_gradient_is_exact_in_float64(runs):
    """The whole depth and geometry of W2L-20 (1/8 of its widths) in
    float64 at seq=4: the SP loss and gradients (halos past the next rank,
    reflect at the edges, BatchNorm's statistics and closed-form backward
    over the frames of four ranks) equal one process's to rounding. In
    float32 the two differ ~1 % at this depth, through clamp branches a
    rounding flips (``chip_smoke.py`` phase 24 holds the card to one
    process on the SP run's branches)."""
    got = _load(runs, 'grad64')
    loss, grads = grad64_case(trainer_mod.seq_forward)
    assert float(got['loss']) == pytest.approx(float(loss), rel=1e-12)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got['grads'],
                                                            grads))
    den = sum(float((b ** 2).sum()) for b in grads)
    assert (num / den) ** 0.5 < 1e-10


def test_train_main_under_sp_is_one_process(runs):
    """(e) ``train.main`` with data=2 x seq=2 on JAX's test_sp_train_cli
    corpus (dropout 0.1, SpecAugment, dither): every logged loss and
    validation metric of one process, the checkpoint at JAX's step 4,
    the same weights."""
    root = runs['root']
    sp_run, one = (os.path.join(root, k) for k in ('sp_cli', 'one_cli'))
    got, want = _metrics(sp_run), _metrics(one)
    for metric in ('train_loss', 'learning_rate', 'val_loss', 'val_wer',
                   'val_cer', 'val_len_ratio'):
        assert got[metric].keys() == want[metric].keys(), metric
        for step, v in want[metric].items():
            assert got[metric][step] == pytest.approx(v, rel=RUN_RTOL,
                                                      abs=1e-12), \
                (metric, step)
    ranks = [json.load(open(os.path.join(root, f'cli.rank{r}.json')))
             for r in range(WORLD)]
    assert all(r['rc'] == 0 and r['step'] == 4 for r in ranks)
    # the seq ranks of a replica, and the replicas, hold the same weights
    assert len({r['checksum'] for r in ranks}) == 1
    a, b = _latest(sp_run), _latest(one)
    assert a['step'] == b['step'] == 4   # tests/test_seq_parallel.py's
    scale = max(float(v.abs().max()) for v in b['model'].values()
                if v.is_floating_point())
    _assert_params_close(a['model'], b['model'], RUN_RTOL, RUN_RTOL * scale)


def test_evaluate_a_seq_run_in_one_process(runs, capsys):
    """(e) the seq run's checkpoint loads strict into one process, and
    ``evaluate.main --model-path`` on it (trainer.mesh.seq=2 in its
    config) gives the loss the run validated last."""
    run = os.path.join(runs['root'], 'sp_cli')
    with open(os.path.join(run, 'config.json')) as f:
        cfg = json.load(f)
    assert cfg['trainer']['mesh']['seq'] == 2
    model = build_model(cfg['model'], len(build_labels(cfg['model'])))
    model.load_state_dict(_latest(run)['model'], strict=True)
    capsys.readouterr()
    assert eval_cli.main(['--model-path', run, '--test-manifest',
                          runs['manifest'], '--device', 'cpu']) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    val = _metrics(run)['val_loss']
    assert result['loss'] == pytest.approx(val[max(val)], rel=RUN_RTOL)


def test_seq_without_a_process_group_stops(tmp_path, monkeypatch):
    """trainer.mesh.seq=2 without torchrun names the launch; a Trainer
    asked for seq=2 outside a seq group raises: nothing trains
    unsharded."""
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    manifest = _make_corpus(tmp_path, n=2)
    with pytest.raises(SystemExit, match='torchrun --nproc-per-node 2'):
        train_cli.main(_cli_argv(manifest, tmp_path / 'r')
                       + ['trainer.mesh.seq=2'])
    monkeypatch.setenv('WORLD_SIZE', '6')
    with pytest.raises(SystemExit, match='WORLD_SIZE=6'):
        train_cli.main(_cli_argv(manifest, tmp_path / 'r')
                       + _mesh(2, 1, 2))
    cfg = load_config(W2L + _mesh(-1, 1, 2))
    model = build_model(cfg['model'], len(build_labels(cfg['model'])))
    with pytest.raises(ValueError, match='seq groups of 1'):
        trainer_mod.Trainer(cfg, model, build_frontend(cfg['model']), None,
                            None, None, device='cpu',
                            run_dir=str(tmp_path / 't'))


# ------------------------------------------------------------------ bf16

def test_train_main_bf16_under_sp(runs, capsys):
    """``train.main`` with model.compute_dtype=bf16 at data=2 x seq=2
    (dropout, SpecAugment, dither) against the same run in one process
    (``assert_train_main_bf16``: the losses, a float32 checkpoint that
    loads strict=True into one process, the update); ``evaluate.main
    --model-path`` on the seq run in one process gives one process's
    loss at the same bar."""
    root = runs['root']
    sp_run, one = (os.path.join(root, k)
                   for k in ('sp_cli_bf16', 'one_cli_bf16'))
    assert_train_main_bf16(sp_run, one)
    ranks = [json.load(open(os.path.join(root, f'cli_bf16.rank{r}.json')))
             for r in range(WORLD)]
    assert all(r['rc'] == 0 and r['step'] == 2 for r in ranks)
    losses = []
    for run in (sp_run, one):
        capsys.readouterr()
        assert eval_cli.main(['--model-path', run, '--test-manifest',
                              runs['manifest'], '--device', 'cpu']) == 0
        losses.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])['loss'])
    assert losses[0] == pytest.approx(losses[1], rel=STEP_LOSS_RTOL)


@pytest.mark.parametrize('grid', ['d2m1s2', 'd1m2s2'])
@pytest.mark.parametrize('name', sorted(PARALLEL_BF16))
def test_bf16_under_sp(runs, name, grid):
    """bf16 compute at data=2 x seq=2 and on the 3-D grid data=1 x
    model=2 x seq=2: eval-mode log-probs within one bf16 ulp of one
    process in bf16, one SGD step's loss and update from the shared
    initial weights, and JAX's one-process bf16 model on the same
    weights (``assert_parallel_bf16``). Every halo exchanged carries
    float32: the bf16 cast comes after it, on the haloed input, as one
    process casts the padded input."""
    got = _load(runs, f'bf16_{name}_{grid}')
    assert got['halo_dtypes'] == ['torch.float32']
    assert_parallel_bf16(got, runs['bf16'][name])
