"""One rank of the port's data-parallel checks on the CPU (gloo).

    RANK=r WORLD_SIZE=W LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=P \
        python tests/torch_parallel_worker.py spec.json

``tests/test_torch_parallel.py`` starts W of these (torchrun's
environment, set by hand) and holds what they write under the spec's
``out`` directory against one process. The spec lists scenarios, run in
order in one process group:

* ``bn``: one ``FlaxBatchNorm1d`` forward and backward on this rank's
  rows of a seeded batch; rank 0 writes the gathered outputs, input
  gradients, summed weight gradients and running statistics;
* ``steps``: ``Trainer.train_step`` three times on this rank's rows of a
  seeded batch, from the weights in ``init``; rank 0 writes the losses
  and the parameters;
* ``train``: ``train.main(argv)`` (which joins the group itself); with
  ``kill_rank``/``kill_at``, that rank sends itself SIGTERM after step
  ``kill_at``. Every rank writes its ``stopped_reason``, its last step
  and a checksum of its parameters;
* ``bf16``: ``bf16_record`` of ``model.compute_dtype=bf16`` on the grid
  the case names (``model``, ``seq``); rank 0 writes it.

``bf16_record`` and ``bf16_batch`` serve the tensor- and sequence-
parallel workers too.
"""

import json
import os
import signal
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from wav2letter_pytorch_tpu_torch import parallel  # noqa: E402
from wav2letter_pytorch_tpu_torch import train as train_cli  # noqa: E402
from wav2letter_pytorch_tpu_torch.training import \
    trainer as trainer_mod  # noqa: E402

torch.set_num_threads(1)

BN_SHAPE = (4, 6, 50)


def bn_inputs():
    """(x, upstream gradient, weight, bias, running mean, running var) of
    the BatchNorm check: a channel mean far from 0 (Chan's combine)."""
    rng = np.random.default_rng(0)
    B, C, T = BN_SHAPE
    x = (rng.standard_normal((B, C, T)) * 3 + 50).astype(np.float32)
    g = rng.standard_normal((B, C, T)).astype(np.float32)
    w, b, rm, rv = (rng.standard_normal(C).astype(np.float32)
                    for _ in range(4))
    return x, g, w, b, rm, np.abs(rv) + 0.5


def make_bn(momentum):
    from wav2letter_pytorch_tpu_torch.models.base import FlaxBatchNorm1d
    _, _, w, b, rm, rv = bn_inputs()
    bn = FlaxBatchNorm1d(BN_SHAPE[1], momentum=momentum, eps=1e-3)
    bn.load_state_dict({'weight': torch.from_numpy(w),
                        'bias': torch.from_numpy(b),
                        'running_mean': torch.from_numpy(rm),
                        'running_var': torch.from_numpy(rv),
                        'num_batches_tracked': torch.tensor(0)})
    return bn.train()


def run_bn(case, rank, world, out):
    x, g, _, _, _, _ = bn_inputs()
    k = x.shape[0] // world
    rows = slice(rank * k, (rank + 1) * k)
    bn = make_bn(case['momentum'])
    xr = torch.tensor(x[rows], requires_grad=True)
    y = bn(xr)
    (y * torch.from_numpy(g[rows])).sum().backward()
    gathered = {}
    for name, t in (('y', y.detach()), ('x_grad', xr.grad)):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        gathered[name] = torch.cat(parts)
    for name, p in (('w_grad', bn.weight.grad), ('b_grad', bn.bias.grad)):
        gathered[name] = parallel.all_reduce_sum(p.clone())
    gathered['running_mean'] = bn.running_mean
    gathered['running_var'] = bn.running_var
    if rank == 0:
        torch.save(gathered, os.path.join(out, f'{case["name"]}.pt'))


def invariance_batch(B=8, t=4800):
    """The JAX package's ``tests/test_multidevice.py::_batch``."""
    rng = np.random.default_rng(0)
    targets = rng.integers(1, 29, size=(B, 8)).astype(np.int32)
    return dict(
        audio=(rng.standard_normal((B, t)) * 0.1).astype(np.float32),
        audio_lengths=np.full((B,), t, np.int32),
        targets=targets,
        target_lengths=np.full((B,), 8, np.int32),
        batch_mask=np.ones((B,), np.float32))


def bf16_batch():
    """The bf16 cases' batch: ``invariance_batch`` at 9 600 samples (61
    feature frames, 31 after a stride of 2)."""
    return invariance_batch(t=9600)


def bf16_record(overrides, init, run_dir, track_halos=False) -> dict:
    """One bf16 scenario on this process's grid (none: one process), on
    its replica's rows of ``bf16_batch()``, with the trainer of
    ``invariance_trainer``: the eval-mode log-probabilities of the whole
    batch (Jasper's probabilities as log p, as ``eval_step`` scores them),
    then one train step; returns them with the step's loss and the
    gathered ``Trainer.state_dict()``. ``track_halos``: also the dtypes
    of the inputs ``sp.conv_input`` exchanged halos of."""
    from wav2letter_pytorch_tpu_torch.parallel import sp
    batch = bf16_batch()
    k = batch['audio'].shape[0] // parallel.data_world()
    r = parallel.data_rank()
    mine = {key: torch.from_numpy(v[r * k:(r + 1) * k])
            for key, v in batch.items()}
    tr = invariance_trainer(overrides, init, run_dir)
    dtypes = set()
    conv_input = sp.conv_input

    def tracked(x, *args, **kw):
        dtypes.add(str(x.dtype))
        return conv_input(x, *args, **kw)
    if track_halos:
        sp.conv_input = tracked
    try:
        tr.model.eval()
        with torch.no_grad():
            feats, flens = tr.frontend(mine['audio'], mine['audio_lengths'])
            out, _ = trainer_mod.seq_forward(tr.model, feats, flens)
        if getattr(tr.model, 'eval_emits_probs', False):
            out = torch.log(torch.clamp(out, min=1e-30))
        if parallel.distributed():
            out = parallel.all_gather(out.contiguous(),
                                      parallel.data_group()).flatten(0, 1)
        loss = float(tr.train_step(mine)[0])
    finally:
        sp.conv_input = conv_input
    state = tr.state_dict()
    tr.close()
    return {'logp': out, 'loss': loss, 'state': state,
            'halo_dtypes': sorted(dtypes)}


def invariance_trainer(overrides, init, run_dir):
    """The port's counterpart of the JAX test's ``_make_trainer``: SGD
    with momentum 0.9 at a constant 1e-3, from the weights in ``init``."""
    from wav2letter_pytorch_tpu_torch.config import load_config
    from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
    from wav2letter_pytorch_tpu_torch.optim import constant_lr
    from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                             build_labels,
                                                             build_model)
    cfg = load_config(overrides)
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(torch.load(init, weights_only=True), strict=True)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    return trainer_mod.Trainer(
        cfg, model, build_frontend(cfg['model'], dither=0.0), opt,
        constant_lr(1e-3), GreedyDecoder(labels), device='cpu',
        run_dir=run_dir)


def run_steps(case, rank, world, out):
    batch = invariance_batch()
    k = batch['audio'].shape[0] // world
    mine = {key: torch.from_numpy(v[rank * k:(rank + 1) * k])
            for key, v in batch.items()}
    tr = invariance_trainer(case['overrides'], case['init'],
                            os.path.join(out, f'{case["name"]}_rank{rank}'))
    losses = [float(tr.train_step(mine)[0]) for _ in range(3)]
    tr.close()
    if rank == 0:
        torch.save({'losses': losses, 'model': tr.model.state_dict()},
                   os.path.join(out, f'{case["name"]}.pt'))


def run_train(case, rank, world, out):
    record = {}
    fit = trainer_mod.Trainer.fit
    after_step = trainer_mod.Trainer._after_step

    def kill_after_step(self, *args):
        after_step(self, *args)
        if rank == case.get('kill_rank') and self.step == case['kill_at']:
            os.kill(os.getpid(), signal.SIGTERM)

    def recorded_fit(self, *args, **kw):
        try:
            return fit(self, *args, **kw)
        finally:
            record.update(
                stopped_reason=self.stopped_reason, step=self.step,
                checksum=float(sum(p.double().sum()
                                   for p in self.model.state_dict().values()
                                   if p.is_floating_point())))

    trainer_mod.Trainer.fit = recorded_fit
    trainer_mod.Trainer._after_step = kill_after_step
    try:
        record['rc'] = train_cli.main(list(case['argv']))
    finally:
        trainer_mod.Trainer.fit = fit
        trainer_mod.Trainer._after_step = after_step
    with open(os.path.join(out, f'{case["name"]}.rank{rank}.json'),
              'w') as f:
        json.dump(record, f)


def run_bf16(case, rank, world, out):
    parallel.set_grid(int(case.get('model', 1)), int(case.get('seq', 1)))
    try:
        record = bf16_record(case['overrides'], case['init'],
                             os.path.join(out, case['name']))
    finally:
        parallel.set_grid(1)
    if rank == 0:
        torch.save(record, os.path.join(out, f'{case["name"]}.pt'))


RUNNERS = {'bn': run_bn, 'steps': run_steps, 'train': run_train,
           'bf16': run_bf16}


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    parallel.init_distributed('cpu')
    rank, world = parallel.rank(), parallel.world()
    for case in spec['cases']:
        RUNNERS[case['kind']](case, rank, world, spec['out'])
    parallel.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1])
