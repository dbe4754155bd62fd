"""Data parallelism of the port (``parallel/mesh.py``) on the CPU.

Training: two ranks over gloo (``tests/torch_parallel_worker.py``, started
once for the module with torchrun's environment set by hand) against one
process of the port on the same global batches, and against the JAX
package's 8-device mesh step on the same flax weights:

* ``FlaxBatchNorm1d`` with cross-replica statistics (Chan's combine over
  an all-gather) against one process on the concatenated batch, for
  Wav2Letter's momentum and Jasper's;
* ``tests/test_multidevice.py::test_device_count_invariance``: three SGD
  steps of a one-layer Wav2Letter, 2 ranks vs 1 process vs JAX's mesh;
* ``train.main`` end to end with dither, dropout, SpecAugment and
  ``accumulate_grad_batches=2``, whose short last batch puts its masked
  rows all on rank 1; a small QuartzNet-style Jasper under remat and
  NovoGrad; validation reduced over the ranks;
* SIGTERM to rank 1 alone: both ranks stop at the same step with
  ``stopped_reason == 'signal'`` and one checkpoint, which one process
  resumes to the uninterrupted run's weights;
* bf16 compute (``model.compute_dtype=bf16``) of Wav2Letter and QuartzNet
  at data=2 against one process in bf16 and JAX's bf16 model
  (``test_torch_bf16.py``'s ``assert_parallel_bf16``).

Serving: ``MeshInference``, long-form windows, ``StreamMultiplexer``
(both streamers) and ``StreamingServer`` over a CPU mesh of 2 and 4
entries, against ``mesh=None`` and the JAX package's mesh versions.
Also ``make_mesh`` / ``shard_rows`` and the loader's shards.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tests.test_multidevice import _make_trainer as jax_invariance_trainer
from tests.test_torch_bf16 import (assert_parallel_bf16, parallel_bf16_init,
                                   parallel_bf16_refs)
from tests.test_torch_longform import EXACT_TOL, _one_shot
from tests.test_torch_longform import _audio as lf_audio
from tests.test_torch_longform import _fe as lf_frontend
from tests.test_torch_serving import (LOGP_TOL, N_MELS, SMALL_LAYERS,
                                      _audio, _close_q8)
from tests.test_torch_serving import small  # noqa: F401
from tests.test_torch_stream_server import LABELS, STATS, _dedicated, _serve
from tests.test_torch_stream_server import pair  # noqa: F401
from tests.test_torch_streaming_jasper import _pair as jasper_pair
from tests.test_torch_streaming_jasper import _streamers as jasper_streamers
from tests.test_streaming_jasper import JASPER_SMALL
from tests.torch_parallel_worker import (bn_inputs, invariance_batch,
                                         invariance_trainer, make_bn)
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu.data.dataset import \
    BucketBatchLoader as JaxLoader
from wav2letter_pytorch_tpu.data.dataset import \
    ManifestDataset as JaxDataset
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu.parallel import make_mesh as jax_make_mesh
from wav2letter_pytorch_tpu.parallel import shard_batch
from wav2letter_pytorch_tpu_torch import parallel, serving
from wav2letter_pytorch_tpu_torch import train as train_cli
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.data.dataset import (BucketBatchLoader,
                                                       ManifestDataset)
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.serving.net import (StreamClient,
                                                      StreamingServer)
from wav2letter_pytorch_tpu_torch.training.checkpoint import Checkpointer
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_parallel_worker.py')
WORLD = 2
SR = 16000
# Cross-replica BatchNorm vs one process: the same float32 statistics,
# combined in another order.
BN_RTOL = 1e-6
# 2 ranks vs 1 process of the port: gradients summed over ranks, BN
# statistics combined, so float32 sums in another order.
DP_RTOL = 1e-5
# JAX's own bars for its 1- vs 8-device runs (tests/test_multidevice.py).
JAX_LOSS_RTOL, JAX_PARAM_RTOL, JAX_PARAM_ATOL = 2e-4, 2e-3, 2e-5
TEXTS = ['abba', 'cab', 'dad at bat', 'a cat sat', 'bad cab', 'tact',
         'a dab', 'cat', 'bat tab', 'acab']
W2L_LAYERS = ('model.layers=[{output_size: 16, kernel_size: 7, stride: 2, '
              'dilation: 1, dropout: 0.2}, {output_size: 16, kernel_size: 5, '
              'stride: 1, dilation: 2, dropout: 0.2}]')
JASPER_BLOCKS = (
    'model.jasper_blocks=[{layer_size: 16, kernel_size: 11, stride: 2, '
    'residual: false, separable: true, dropout: 0.1}, {layer_size: 16, '
    'kernel_size: 7, repeat: 2, residual: true, separable: true, '
    'dropout: 0.1}, {layer_size: 24, kernel_size: 1, residual: false, '
    'separable: false}]')
AUGMENT = ('data.augment={spec_augment: {freq_masks: 1, time_masks: 1, '
           'freq_width: 4, time_width: 5}}')
INVARIANCE = ['data.train_manifest=x', 'data.val_manifest=y',
              'model.input_size=32',
              'model.layers=[{output_size: 32, kernel_size: 7, stride: 2, '
              'dilation: 1, dropout: -1.0}]',
              'trainer.string_metrics_interval=0']


def _corpus(root, n):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        t = np.arange(int((0.3 + 0.05 * (i % 3)) * SR)) / SR
        audio = (0.3 * np.sin(2 * np.pi * (250 + 60 * i) * t)
                 + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
        path = os.path.join(root, f'utt{i}.wav')
        write_wav(path, audio, SR)
        rows.append({'audio_filepath': path, 'text': TEXTS[i % len(TEXTS)]})
    manifest = os.path.join(root, f'manifest{n}.jsonl')
    with open(manifest, 'w') as f:
        f.write('\n'.join(json.dumps(r) for r in rows) + '\n')
    return manifest


def _argv(manifest, run_dir, *extra):
    return [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', 'data.num_length_buckets=1',
            'model.input_size=32', 'trainer.log_every_n_steps=1',
            f'trainer.default_root_dir={run_dir}', '--device', 'cpu', *extra]


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _launch(spec: dict, root) -> None:
    """WORLD ranks of the worker over gloo, torchrun's environment set by
    hand; each must exit 0."""
    path = os.path.join(root, 'spec.json')
    with open(path, 'w') as f:
        json.dump(spec, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != 'WORLD_SIZE'}
    procs = []
    for r in range(WORLD):
        env_r = dict(env, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE=str(WORLD), MASTER_ADDR='127.0.0.1',
                     MASTER_PORT=str(port), OMP_NUM_THREADS='1')
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, path], cwd=REPO, env=env_r,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} exited {p.returncode}:\n{out}'


def _cases(root):
    """The worker's scenarios and what the one-process side needs."""
    m6 = _corpus(root, 6)
    m10 = _corpus(root, 10)
    jasper = ['model=quartznet', 'optimizer=novograd', 'model.mid_layers=3',
              JASPER_BLOCKS, 'model.remat=true', 'data.batch_size=4',
              'trainer.max_epochs=1', AUGMENT]
    return {
        'w2l': _argv(m6, '{run}', W2L_LAYERS, 'model.mid_layers=2',
                     'data.batch_size=4', 'trainer.max_epochs=2',
                     'trainer.accumulate_grad_batches=2',
                     'model.optimizer.lr=0.05', AUGMENT),
        'jasper': _argv(m6, '{run}', *jasper),
        'sigterm': _argv(m10, '{run}', W2L_LAYERS, 'model.mid_layers=2',
                         'data.batch_size=2', 'trainer.max_epochs=1',
                         'trainer.preempt_sync_every=3',
                         'model.optimizer.lr=0.05', AUGMENT),
    }


@pytest.fixture(scope='module')
def dp_runs(tmp_path_factory):
    """The 2-rank side of every training check, in one launch."""
    root = str(tmp_path_factory.mktemp('dp'))
    init = os.path.join(root, 'init.pt')
    torch.save(_jax_invariance()[0], init)
    cases = _cases(root)
    bf16 = {name: parallel_bf16_init(name, root) for name in DP_BF16}
    spec = {'out': root, 'cases': [
        {'kind': 'bf16', 'name': f'bf16_{name}', 'init': case['init'],
         'overrides': case['overrides'] + ['trainer.mesh.data=2']}
        for name, case in bf16.items()] + [
        {'kind': 'bn', 'name': 'bn_0.9', 'momentum': 0.9},
        {'kind': 'bn', 'name': 'bn_0.1', 'momentum': 0.1},
        {'kind': 'steps', 'name': 'steps', 'overrides': INVARIANCE,
         'init': init}]
        + [{'kind': 'train', 'name': name,
            'argv': [a.replace('{run}', os.path.join(root, f'dp_{name}'))
                     for a in argv],
            **({'kill_rank': 1, 'kill_at': 2} if name == 'sigterm' else {})}
           for name, argv in cases.items()]}
    _launch(spec, root)
    for case in bf16.values():
        parallel_bf16_refs(case, root)
    return root, cases, init, bf16


_JAX_INVARIANCE = {}
DP_BF16 = ('w2l_reflect', 'qn')


def _jax_invariance():
    """JAX's 8-device run of test_device_count_invariance: (its initial
    weights as a port state dict, its last loss, its params as a port
    state dict)."""
    if not _JAX_INVARIANCE:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            batch = invariance_batch()
            trainer = jax_invariance_trainer(tmp, 8)
            trainer.init_state(batch)
            init = state_dict_from_flax(jax.device_get(
                {'params': trainer.state.params,
                 'batch_stats': trainer.state.batch_stats}))
            step = trainer._get_jitted('train')
            db = shard_batch(batch, trainer.mesh)
            for _ in range(3):
                trainer.state, loss, _, _ = step(trainer.state, db)
            final = state_dict_from_flax(jax.device_get(
                {'params': trainer.state.params,
                 'batch_stats': trainer.state.batch_stats}))
        _JAX_INVARIANCE.update(init=init, loss=float(loss), final=final)
    j = _JAX_INVARIANCE
    return j['init'], j['loss'], j['final']


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def _params(sd):
    return {k: v for k, v in sd.items() if v.is_floating_point()}


def _assert_states_close(got, want, rtol):
    """Every floating tensor within ``rtol`` of the largest entry of any
    (a parameter whose gradient is rounding noise, such as a conv bias
    under BatchNorm, has no scale of its own)."""
    got, want = _params(got), _params(want)
    assert got.keys() == want.keys()
    scale = max(float(v.abs().max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=rtol * scale, err_msg=k)


def _metrics(run_dir) -> dict:
    out = {}
    with open(os.path.join(run_dir, 'metrics.csv')) as f:
        for line in f.read().splitlines()[1:]:
            _, step, metric, value = line.split(',')
            out.setdefault(metric, {})[int(step)] = float(value)
    return out


def _one_process(root, name, cases, *extra):
    run = os.path.join(root, f'one_{name}')
    assert train_cli.main([a.replace('{run}', run) for a in cases[name]]
                          + list(extra)) == 0
    return run


def _latest(run_dir):
    return Checkpointer(os.path.join(run_dir, 'checkpoints')).restore()


# ---------------------------------------------------------------- meshes

def test_make_mesh_and_shard_rows():
    mesh = parallel.make_mesh(4, device='cpu')
    assert mesh.size == 4 and mesh.shape == {'data': 4}
    assert parallel.make_mesh(device='cpu').size == 1
    parts = parallel.shard_rows(torch.arange(8).reshape(8, 1), mesh)
    assert [p.flatten().tolist() for p in parts] == [[0, 1], [2, 3],
                                                     [4, 5], [6, 7]]
    with pytest.raises(ValueError, match='divisible') as ours:
        parallel.shard_rows(torch.zeros(6, 3), mesh)
    with pytest.raises(ValueError, match='divisible') as theirs:
        shard_batch({'audio': np.zeros((6, 3), np.float32)},
                    jax_make_mesh(4))
    assert "must be divisible by the 'data' mesh size (4)" in \
        str(ours.value) and "must be divisible by the 'data' mesh size " \
        "(4)" in str(theirs.value)
    with pytest.raises(ValueError, match='Requested 16 devices, only 8 '
                       'visible'):
        jax_make_mesh(16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            parallel.make_mesh()
        return
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f'Requested {n + 1} devices, only '
                       f'{n} visible'):
        parallel.make_mesh(n + 1)


def test_sequence_parallelism_taken():
    """``trainer.mesh.seq=2`` loads, and ``make_mesh(2, seq=2)`` is JAX's
    2 x 2 data x seq grid (tests/test_torch_seq_parallel.py trains on
    it)."""
    cfg = load_config(['data.train_manifest=x', 'data.val_manifest=y',
                       'trainer.mesh.seq=2'])
    assert cfg['trainer']['mesh']['seq'] == 2
    mesh = parallel.make_mesh(2, seq=2, device='cpu')
    theirs = jax_make_mesh(2, seq=2)
    assert mesh.axis_names == theirs.axis_names == ('data', 'seq')
    assert tuple(mesh.shape.values()) == theirs.devices.shape == (2, 2)


def test_tensor_parallelism_taken():
    """``trainer.mesh.model=2`` loads, and ``make_mesh(2, model=2)`` is
    JAX's 2 x 2 grid."""
    cfg = load_config(['data.train_manifest=x', 'data.val_manifest=y',
                       'trainer.mesh.model=2'])
    assert cfg['trainer']['mesh']['model'] == 2
    mesh = parallel.make_mesh(2, model=2, device='cpu')
    theirs = jax_make_mesh(2, model=2)
    assert mesh.shape == dict(zip(theirs.axis_names,
                                  theirs.devices.shape)) == \
        {'data': 2, 'model': 2}


def test_config_takes_mesh_data_and_preempt_sync():
    cfg = load_config(['data.train_manifest=x', 'data.val_manifest=y',
                       'trainer.mesh.data=4', 'trainer.preempt_sync_every=5'])
    assert cfg['trainer']['mesh']['data'] == 4
    assert cfg['trainer']['preempt_sync_every'] == 5


def test_mesh_data_without_a_launcher_names_torchrun(tmp_path, monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    manifest = _corpus(str(tmp_path), 4)
    with pytest.raises(SystemExit, match='torchrun --nproc-per-node 2'):
        train_cli.main(_argv(manifest, tmp_path / 'r',
                             'trainer.mesh.data=2'))
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(SystemExit, match='WORLD_SIZE=2'):
        train_cli.main(_argv(manifest, tmp_path / 'r',
                             'trainer.mesh.data=4'))


# ---------------------------------------------------------------- loader

@pytest.mark.parametrize('seed', [0, 7])
def test_loader_shards_match_jax_disjoint_and_complete(tmp_path, seed):
    """``shard_id`` / ``num_shards``: index for index the JAX loader's
    shards (tests/test_data.py's multi-host sharding), disjoint, and
    together every sample."""
    manifest = _corpus(str(tmp_path), 7)
    seen = []
    for shard in range(2):
        ours = BucketBatchLoader(
            ManifestDataset(manifest, SR, 'english_lowercase'), 2, 160,
            num_buckets=1, shuffle=True, seed=seed, prefetch=0,
            shard_id=shard, num_shards=2)
        ref = JaxLoader(JaxDataset(manifest, {'sample_rate': SR},
                                   'english_lowercase'), 2, num_buckets=1,
                        frame_hop=160, shuffle=True, seed=seed, prefetch=0,
                        shard_id=shard, num_shards=2)
        for _ in range(2):   # two epochs, two orders
            got, want = list(ours), list(ref)
            assert [b['paths'] for b in got] == [b['paths'] for b in want]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a['audio'], b['audio'])
                np.testing.assert_array_equal(a['batch_mask'],
                                              b['batch_mask'])
        seen.append([p for b in got for j, p in enumerate(b['paths'])
                     if b['batch_mask'][j]])
    assert not set(seen[0]) & set(seen[1])
    assert sorted(seen[0] + seen[1]) == sorted(
        r['audio_filepath'] for r in map(json.loads, open(manifest)))


@pytest.mark.parametrize('world', [2, 4])
def test_row_shards_are_the_rows_of_one_process(tmp_path, world):
    """``row_shard=(r, W)``: rank r's batch is rows [r B/W, (r+1) B/W) of
    the one-process batch, padding rows (the last real sample, masked)
    included; every rank has the same batches."""
    manifest = _corpus(str(tmp_path), 7)
    ds = ManifestDataset(manifest, SR, 'english_lowercase')
    kw = dict(num_buckets=1, shuffle=True, seed=3, prefetch=0)
    full = list(BucketBatchLoader(ds, 4, 160, **kw))
    assert [int(b['batch_mask'].sum()) for b in full] == [4, 3]
    k = 4 // world
    for r in range(world):
        part = list(BucketBatchLoader(ds, 4, 160, row_shard=(r, world),
                                      **kw))
        assert len(part) == len(full)
        for a, b in zip(part, full):
            for key in ('audio', 'audio_lengths', 'targets',
                        'target_lengths', 'batch_mask'):
                np.testing.assert_array_equal(a[key],
                                              b[key][r * k:(r + 1) * k])
            real = [j for j in range(r * k, (r + 1) * k)
                    if b['batch_mask'][j]]
            assert a['texts'] == [b['texts'][j] for j in real]
    with pytest.raises(ValueError, match='divisible'):
        BucketBatchLoader(ds, 4, 160, row_shard=(0, 3))


# -------------------------------------------------------------- training

@pytest.mark.parametrize('momentum', [0.9, 0.1])
def test_cross_replica_batchnorm_is_one_process(dp_runs, momentum):
    """2 ranks x 2 rows against one process on the 4 rows: outputs,
    running statistics (the biased variance, flax's), and the input and
    weight gradients, within BN_RTOL."""
    root, _, _, _ = dp_runs
    got = torch.load(os.path.join(root, f'bn_{momentum}.pt'))
    x, g, _, _, _, _ = bn_inputs()
    bn = make_bn(momentum)
    xt = torch.tensor(x, requires_grad=True)
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    want = {'y': y.detach(), 'x_grad': xt.grad, 'w_grad': bn.weight.grad,
            'b_grad': bn.bias.grad, 'running_mean': bn.running_mean,
            'running_var': bn.running_var}
    for k, v in want.items():
        assert _rel(got[k], v) < BN_RTOL, (k, _rel(got[k], v))
    # the running variance is the biased one (unbiased would be ~1 % off)
    var = torch.from_numpy(x).double().var(dim=(0, 2), unbiased=False)
    _, _, _, _, _, rv = bn_inputs()
    assert _rel(got['running_var'],
                (1 - momentum) * torch.from_numpy(rv).double()
                + momentum * var) < BN_RTOL


def test_device_count_invariance(dp_runs, tmp_path):
    """tests/test_multidevice.py::test_device_count_invariance for the
    port: 2 ranks, 1 process and JAX's 8-device mesh take 3 SGD steps on
    the same batch from the same flax weights."""
    root, _, init, _ = dp_runs
    got = torch.load(os.path.join(root, 'steps.pt'))
    tr = invariance_trainer(INVARIANCE, init, str(tmp_path / 'one'))
    batch = {k: torch.from_numpy(v) for k, v in invariance_batch().items()}
    losses = [float(tr.train_step(batch)[0]) for _ in range(3)]
    tr.close()
    np.testing.assert_allclose(got['losses'], losses, rtol=DP_RTOL)
    _assert_states_close(got['model'], tr.model.state_dict(), DP_RTOL)
    _, jax_loss, jax_final = _jax_invariance()
    assert got['losses'][-1] == pytest.approx(jax_loss, rel=JAX_LOSS_RTOL)
    ours = got['model']
    for k, v in _params(jax_final).items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(),
                                   rtol=JAX_PARAM_RTOL, atol=JAX_PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize('name', ['w2l', 'jasper'])
def test_two_ranks_train_as_one_process(dp_runs, name):
    """``train.main`` on 2 ranks vs 1 process: every logged train loss,
    train WER/CER and utterance count, and the final weights and BN
    statistics. W2L: the short last batch's 2 masked rows are rank 1's
    whole share, with accumulate_grad_batches=2, dither, dropout and
    SpecAugment on. Jasper: remat, NovoGrad, K4-K7's plain versions."""
    root, cases, _, _ = dp_runs
    dp = os.path.join(root, f'dp_{name}')
    one = _one_process(root, name, cases)
    got, want = _metrics(dp), _metrics(one)
    for metric in ('train_loss', 'train_wer', 'train_cer', 'learning_rate'):
        assert got[metric].keys() == want[metric].keys()
        for step, v in want[metric].items():
            assert got[metric][step] == pytest.approx(v, rel=DP_RTOL,
                                                      abs=1e-12), \
                (metric, step)
    ranks = [json.load(open(os.path.join(root, f'{name}.rank{r}.json')))
             for r in range(WORLD)]
    assert all(r['rc'] == 0 and r['stopped_reason'] is None for r in ranks)
    assert ranks[0]['checksum'] == ranks[1]['checksum']
    a, b = _latest(dp), _latest(one)
    assert a['step'] == b['step'] == ranks[0]['step']
    _assert_states_close(a['model'], b['model'], DP_RTOL)
    assert os.listdir(os.path.join(dp, 'checkpoints')) == os.listdir(
        os.path.join(one, 'checkpoints'))


@pytest.mark.parametrize('name', ['w2l', 'jasper'])
def test_validate_on_two_ranks_is_one_process(dp_runs, name):
    """Validation on 2 ranks (each scores its rows; loss sums, WER and CER
    numerators and denominators reduced) logs one process's numbers."""
    root, cases, _, _ = dp_runs
    got = _metrics(os.path.join(root, f'dp_{name}'))
    want = _metrics(os.path.join(root, f'one_{name}'))
    for metric in ('val_loss', 'val_wer', 'val_cer', 'val_len_ratio'):
        assert got[metric].keys() == want[metric].keys()
        for step, v in want[metric].items():
            assert got[metric][step] == pytest.approx(v, rel=DP_RTOL,
                                                      abs=1e-12)


@pytest.mark.parametrize('name', DP_BF16)
def test_bf16_on_two_ranks_is_one_process(dp_runs, name):
    """bf16 compute at data=2 (each rank's weight gradients rounded to
    bf16 before the all-reduce adds them): eval-mode log-probs within one
    bf16 ulp of one process in bf16, one SGD step's loss and update from
    the shared initial weights, and JAX's one-process bf16 model on the
    same weights (``assert_parallel_bf16``)."""
    root, _, _, bf16 = dp_runs
    assert_parallel_bf16(torch.load(os.path.join(root, f'bf16_{name}.pt')),
                         bf16[name])


def test_sigterm_to_one_rank_stops_every_rank(dp_runs):
    """Rank 1 alone gets SIGTERM after step 2; with preempt_sync_every=3
    both ranks stop at step 3 with stopped_reason 'signal' and one
    checkpoint (written by rank 0), which one process resumes to the
    weights of an uninterrupted one-process run."""
    root, cases, _, _ = dp_runs
    dp = os.path.join(root, 'dp_sigterm')
    ranks = [json.load(open(os.path.join(root, f'sigterm.rank{r}.json')))
             for r in range(WORLD)]
    assert [(r['rc'], r['stopped_reason'], r['step']) for r in ranks] == \
        [(0, 'signal', 3)] * WORLD
    assert ranks[0]['checksum'] == ranks[1]['checksum']
    ck = Checkpointer(os.path.join(dp, 'checkpoints'))
    assert ck.all_steps() == [3]
    assert ck.load_extra() == {'epoch': 0, 'epoch_step': 3,
                               'preempted': True}
    assert train_cli.main([a.replace('{run}', dp) for a in cases['sigterm']]
                          + ['--resume']) == 0
    one = _one_process(root, 'sigterm', cases)
    a, b = _latest(dp), _latest(one)
    assert a['step'] == b['step'] == 5
    _assert_states_close(a['model'], b['model'], DP_RTOL)
    got, want = _metrics(dp)['train_loss'], _metrics(one)['train_loss']
    assert got.keys() == want.keys() == set(range(1, 6))
    for step in want:
        assert got[step] == pytest.approx(want[step], rel=DP_RTOL)


# --------------------------------------------------------------- serving

@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('mode', ['f32', 'int8_full'])
def test_mesh_inference_over_a_cpu_mesh(small, n, mode):  # noqa: F811
    """B=8 split over n CPU entries: equal to mesh=None and within the
    serving tests' tolerance of JAX's MeshInference on its 8 devices."""
    variables, _, _ = small
    folded = jserve.fold_batchnorm(variables, len(SMALL_LAYERS))
    if mode != 'f32':
        folded = jserve.quantize_folded(folded)
    T = 24000
    audio, lens = _audio([T, T - 1000, T - 2000, T - 3000] * 2)

    def port(mesh):
        return serving.MeshInference(
            SMALL_LAYERS, folded,
            SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0),
            mesh=mesh, mode=mode, device='cpu')
    mi = port(parallel.make_mesh(n, device='cpu'))
    assert mi.mesh.shape['data'] == n
    # every other entry serves from its own copy of the frontend
    assert len({id(fe) for fe, _ in mi._parts}) == n
    got, got_lens = mi.logprobs(audio, lens)
    one, one_lens = port(None).logprobs(audio, lens)
    np.testing.assert_array_equal(got_lens, one_lens)
    np.testing.assert_allclose(got, one, atol=LOGP_TOL * 1e-2, rtol=0)
    jmi = jserve.MeshInference(SMALL_LAYERS, folded,
                               JaxFrontend(JaxAudio(), n_mels=N_MELS,
                                           dither=0.0), mode=mode)
    assert jmi.mesh.shape['data'] == 8
    want, want_lens = jmi.logprobs(audio, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    if mode == 'f32':
        np.testing.assert_allclose(got, want, atol=LOGP_TOL, rtol=0)
    else:
        _close_q8(got, want)
    assert mi.transcribe(audio, lens, GreedyDecoder(list('_abcde '))) == \
        port(None).transcribe(audio, lens, GreedyDecoder(list('_abcde ')))
    with pytest.raises(ValueError, match='divisible'):
        mi.logprobs(audio[:n + 1], lens[:n + 1])


@pytest.mark.parametrize('n', [2, 4])
def test_longform_windows_over_a_cpu_mesh(small, n):  # noqa: F811
    """Long-form windows spread over n CPU entries (max_batch 3 rounded to
    a multiple of n): equal to mesh=None and to the one-shot stack, as
    the JAX package's mesh long form."""
    lf_small = jserve.fold_batchnorm(small[0], len(SMALL_LAYERS))
    audio = lf_audio(60000, seed=9)
    mesh = parallel.make_mesh(n, device='cpu')
    kw = dict(chunk_frames=40, max_batch=3)
    got, valid = serving.longform_logprobs(SMALL_LAYERS, lf_small,
                                           lf_frontend(), audio, mesh=mesh,
                                           **kw)
    one, one_valid = serving.longform_logprobs(SMALL_LAYERS, lf_small,
                                               lf_frontend(), audio, **kw)
    assert valid == one_valid
    np.testing.assert_allclose(got, one, atol=EXACT_TOL, rtol=0)
    np.testing.assert_allclose(got, _one_shot(SMALL_LAYERS, lf_small, audio),
                               atol=EXACT_TOL, rtol=0)
    want, want_valid = jserve.longform_logprobs(
        SMALL_LAYERS, lf_small,
        JaxFrontend(JaxAudio(), n_mels=N_MELS, dither=0.0),
        audio, mesh=jax_make_mesh(n), **kw)
    assert valid == want_valid
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    decoder = GreedyDecoder(list('_abcde '))
    lf = serving.LongFormTranscriber(SMALL_LAYERS, lf_small, lf_frontend(),
                                     decoder, mesh=mesh, **kw)
    assert lf.transcribe(audio) == serving.LongFormTranscriber(
        SMALL_LAYERS, lf_small, lf_frontend(), decoder, device='cpu',
        **kw).transcribe(audio)


def _mesh_schedule(mux, sw, streams):
    """The JAX mesh multiplexer test's schedule (staggered attach, one
    chunk a stream a tick, ``tick_ready``)."""
    cs, ps = sw.chunk_samples, sw.prime_samples
    lengths = [len(a) for a in streams]
    pos, slot, finals = [0] * 3, [None] * 3, [None] * 3
    for t in range(40):
        if all(f is not None for f in finals):
            break
        for i in range(3):
            if i == t:
                slot[i] = mux.attach()
                mux.feed(slot[i], streams[i][:ps + cs])
                pos[i] = ps + cs
        for i in range(3):
            if slot[i] is None or finals[i] is not None:
                continue
            if pos[i] < lengths[i]:
                mux.feed(slot[i], streams[i][pos[i]:pos[i] + cs])
                pos[i] += cs
            if pos[i] >= lengths[i] and mux.pending(slot[i]) < cs:
                finals[i] = mux.detach(slot[i])
        mux.tick_ready()
    for i in range(3):
        if finals[i] is None:
            finals[i] = mux.detach(slot[i])
    return finals


def _streams(sw, seed):
    rng = np.random.default_rng(seed)
    cs = sw.chunk_samples
    return [(rng.standard_normal(sw.prime_samples + n) * 0.3)
            .astype(np.float32) for n in (4 * cs + 500, 3 * cs + 90, 2 * cs)]


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('family', ['wav2letter', 'jasper'])
def test_multiplexer_over_a_cpu_mesh(pair, n, family):  # noqa: F811
    """The slot axis split over n CPU entries: the finals of mesh=None, of
    dedicated sessions and of the JAX multiplexer over its mesh; a slot
    count the mesh does not divide is refused with JAX's text."""
    if family == 'wav2letter':
        jsw, sw, _ = pair
    else:
        jsw, sw = jasper_streamers(JASPER_SMALL, *jasper_pair(JASPER_SMALL),
                                   chunk_frames=16)
    streams = _streams(sw, 77)
    mesh = parallel.make_mesh(n, device='cpu')
    mux = serving.StreamMultiplexer(sw, slots=4, labels=LABELS, mesh=mesh)
    assert len(mux._parts) == n
    got = _mesh_schedule(mux, sw, streams)
    assert got == _mesh_schedule(
        serving.StreamMultiplexer(sw, slots=4, labels=LABELS), sw, streams)
    assert got == [_dedicated(sw, a) for a in streams]
    want = _mesh_schedule(jserve.StreamMultiplexer(
        jsw, slots=4, labels=LABELS, mesh=jax_make_mesh(n)), jsw, streams)
    assert got == want
    with pytest.raises(ValueError, match=r'slots \(6\) must be divisible by '
                       r'the mesh size \(4\)'):
        serving.StreamMultiplexer(sw, slots=6, labels=LABELS,
                                  mesh=parallel.make_mesh(4, device='cpu'))
    with pytest.raises(ValueError, match=r'slots \(6\) must be divisible by '
                       r'the mesh size \(4\)'):
        jserve.StreamMultiplexer(jsw, slots=6, labels=LABELS,
                                 mesh=jax_make_mesh(4))


def test_multiplexer_takes_one_streamer_a_device(pair):  # noqa: F811
    """A mesh's multiplexer over one streamer built on each device (two
    distinct streamers on the two CPU entries): the finals of one shared
    streamer. A list that does not match the mesh, or several streamers
    without one, is refused."""
    jsw, sw, model = pair
    other = serving.StreamingWav2Letter(
        SMALL_LAYERS, len(LABELS), model.eval(),
        SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0),
        device='cpu', chunk_frames=16, norm='precomputed',
        norm_stats=STATS)
    streams = _streams(sw, 78)
    mesh = parallel.make_mesh(2, device='cpu')
    mux = serving.StreamMultiplexer([sw, other], slots=4, labels=LABELS,
                                    mesh=mesh)
    assert [p[0] for p in mux._parts] == [sw, other]
    assert _mesh_schedule(mux, sw, streams) == _mesh_schedule(
        serving.StreamMultiplexer(sw, slots=4, labels=LABELS, mesh=mesh),
        sw, streams)
    with pytest.raises(ValueError, match='build one streamer on each'):
        serving.StreamMultiplexer([sw, other, sw], slots=6, labels=LABELS,
                                  mesh=parallel.make_mesh(2, device='cpu'))
    with pytest.raises(ValueError, match='several streamers need a mesh'):
        serving.StreamMultiplexer([sw, other], slots=4, labels=LABELS)


def test_flat_grads_hold_the_gradients_as_views():
    """``FlatGrads``: every ``p.grad`` a view of the one buffer; backward
    accumulates into the views in place, a zeroing keeps them, and a
    gradient set from outside (a resume) or dropped is copied in or
    zeroed by ``bind``."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    params = list(net.parameters())
    flat = parallel.FlatGrads(params)
    x = torch.randn(5, 3)
    net(x).square().sum().backward()
    want = [p.grad.clone() for p in params]
    net(x).square().sum().backward()
    sizes = [p.numel() for p in params]
    for p, g, part in zip(params, want, flat.flat.split(sizes)):
        assert p.grad.data_ptr() == part.data_ptr()
        torch.testing.assert_close(p.grad, 2 * g, rtol=0, atol=0)
    opt = torch.optim.SGD(params, lr=0.1)
    opt.zero_grad(set_to_none=False)
    assert not flat.flat.any()
    params[0].grad = torch.ones_like(params[0])
    params[1].grad = None
    flat.bind()
    assert torch.equal(flat.flat[:sizes[0]], torch.ones(sizes[0]))
    assert params[0].grad.data_ptr() == flat.flat.data_ptr()
    assert params[1].grad is not None and not params[1].grad.any()


def test_canonical_device_names():
    """``canonical``: the CPU as it is, a bare ``cuda`` only with a card
    (the current device's index)."""
    assert parallel.canonical('cpu') == torch.device('cpu')
    assert parallel.canonical(torch.device('cuda', 1)) == \
        torch.device('cuda', 1)


def test_streaming_server_over_a_cpu_mesh(pair):  # noqa: F811
    """StreamingServer(mesh=): a client's final over the mesh (2 slots a
    CPU entry) is the dedicated session's and JAX's."""
    jsw, sw, _ = pair
    srv = StreamingServer(sw, LABELS, slots=4, poll=0.002,
                          mesh=parallel.make_mesh(2, device='cpu'))
    stop = _serve(srv)
    try:
        rng = np.random.default_rng(40)
        audio = (rng.standard_normal(sw.prime_samples + 3 * sw.chunk_samples
                                     + 777) * 0.3).astype(np.float32)
        c = StreamClient('127.0.0.1', srv.port, sample_rate=SR)
        for i in range(0, len(audio), 5000):
            c.send(audio[i:i + 5000])
        final = c.finish()
    finally:
        stop()
    assert final == _dedicated(sw, audio) == _dedicated(jsw, audio, jserve)
    assert final
