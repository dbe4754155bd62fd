"""One rank of the port's tensor-parallel checks on the CPU (gloo).

    RANK=r WORLD_SIZE=4 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=P \
        python tests/torch_tp_worker.py spec.json

``tests/test_torch_tensor_parallel.py`` starts four of these (torchrun's
environment, set by hand) and holds what they write under the spec's
``out`` directory against one process and the JAX package. The spec
lists scenarios, run in order in one process group; each names its
``model`` extent, and the world is laid out anew as ``4 // model`` data
rows of ``model`` ranks (``parallel.set_grid``) before it:

* ``steps``: ``Trainer.train_step`` ``steps`` times (SGD, momentum 0.9,
  lr 1e-3, from the weights in ``init``) on this replica's rows of the
  JAX tests' seeded batch; every rank writes its shards' shapes after
  init and after the first step (parameters and momenta), rank 0 the
  losses and the gathered ``Trainer.state_dict()``; with ``save``, a
  checkpoint of the last step under the case's run directory;
* ``restore``: a trainer of the case's topology restores the newest
  checkpoint under ``from`` and rank 0 writes its ``state_dict()``
  again; with ``save``, it checkpoints that state under its own run
  directory;
* ``train``: ``train.main(argv)`` as ``tests/torch_parallel_worker.py``
  runs it (a rank may send itself SIGTERM);
* ``bf16``: ``bf16_record`` of ``model.compute_dtype=bf16``; rank 0
  writes it;
* ``columns``: each of ``column_case``'s bf16 convs sharded over the
  model group: rank 0 writes its output (the ranks' columns gathered),
  its input gradient (the ranks' partial gradients all-reduced) and
  each rank's partial input gradient.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tests.torch_parallel_worker import (bf16_record,  # noqa: E402
                                         invariance_batch,
                                         invariance_trainer, run_train)
from wav2letter_pytorch_tpu_torch import parallel  # noqa: E402
from wav2letter_pytorch_tpu_torch.parallel import tp  # noqa: E402
from wav2letter_pytorch_tpu_torch.training.checkpoint import \
    Checkpointer  # noqa: E402

torch.set_num_threads(1)
# checkpoints gather in buckets: small ones here, so that a state spans
# several of them
tp.GATHER_BUCKET = 4096


def _shapes(tr) -> dict:
    """This rank's parameter and momentum shapes, by state-dict key."""
    names = {id(p): k for k, p in tr.model.named_parameters()}
    out = {'params': {k: list(p.shape)
                      for k, p in tr.model.named_parameters()},
           'buffers': {k: list(b.shape)
                       for k, b in tr.model.named_buffers()},
           'momenta': {}}
    for p, st in tr.optimizer.state.items():
        if 'momentum_buffer' in st:
            out['momenta'][names[id(p)]] = list(st['momentum_buffer'].shape)
    return out


def _rows(batch: dict) -> dict:
    k = batch['audio'].shape[0] // parallel.data_world()
    r = parallel.data_rank()
    return {key: torch.from_numpy(v[r * k:(r + 1) * k])
            for key, v in batch.items()}


def run_steps(case, rank, out):
    run = os.path.join(out, case['name'])
    tr = invariance_trainer(case['overrides'], case['init'], run)
    record = {'init': _shapes(tr)}
    mine = _rows(invariance_batch())
    losses = []
    for i in range(int(case.get('steps', 3))):
        losses.append(float(tr.train_step(mine)[0]))
        if i == 0:
            record['step1'] = _shapes(tr)
    with open(os.path.join(out, f'{case["name"]}.rank{rank}.json'),
              'w') as f:
        json.dump(record, f)
    state = tr.state_dict()
    if case.get('save'):
        tr._save(tr.step)
    tr.close()
    if rank == 0:
        torch.save({'losses': losses, 'state': state},
                   os.path.join(out, f'{case["name"]}.pt'))


def run_restore(case, rank, out):
    run = os.path.join(out, case['name'])
    tr = invariance_trainer(case['overrides'], case['init'], run)
    tr.load_state_dict(Checkpointer(os.path.join(
        case['from'], 'checkpoints')).restore())
    state = tr.state_dict()
    if case.get('save'):
        tr._save(tr.step)
    tr.close()
    if rank == 0:
        torch.save({'state': state}, os.path.join(out, f'{case["name"]}.pt'))


def run_train_case(case, rank, out):
    run_train(case, rank, parallel.world(), out)


def run_bf16(case, rank, out):
    record = bf16_record(case['overrides'], case['init'],
                         os.path.join(out, case['name']))
    if rank == 0:
        torch.save(record, os.path.join(out, f'{case["name"]}.pt'))


# (Cin, Cout, kernel, groups, bias) of the ``columns`` convs: one group
# (one conv), two groups (a rank's slice in one group at model 2, half of
# one at model 4), three groups of 16 (slices straddling groups at model
# 2 and 4), four groups (two whole groups a rank at model 2: one conv
# over them) with a bias
COLUMN_CASES = [(16, 32, 5, 1, False), (32, 32, 1, 2, False),
                (48, 48, 3, 3, False), (32, 64, 1, 4, True)]


def column_case(i):
    """(MaskedConv in bf16, x [2, 20, Cin], upstream gradient) of
    ``COLUMN_CASES[i]``, drawn from a seed."""
    from wav2letter_pytorch_tpu_torch.models.jasper import MaskedConv
    cin, cout, k, groups, bias = COLUMN_CASES[i]
    gen = torch.Generator().manual_seed(i)
    conv = MaskedConv(cin, cout, k, groups=groups, padding=k // 2,
                      use_bias=bias, use_mask=False,
                      compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x = torch.randn(2, 20, cin, generator=gen)
    g = torch.randn(2, 20, cout, generator=gen)
    return conv, x, g


def run_columns(case, rank, out):
    """Each ``column_case`` conv sharded (``tp.shard_module``): its
    column-parallel forward gathered, its input gradient through
    ``copy_to_model``, and each rank's partial input gradient (the
    columns' backward alone)."""
    records = []
    for i in range(len(COLUMN_CASES)):
        conv, x, g = column_case(i)
        tp.shard_module(conv)
        assert conv.out_sharded
        sl = tp.shard_slice(conv.conv.weight)
        x = x.requires_grad_()
        y, _ = conv(x, None)
        assert y.dtype == torch.bfloat16
        (y.float() * g[:, :, sl]).sum().backward()
        part = x.detach().clone().requires_grad_()
        (conv._column(part, conv.padding).float()
         * g[:, :, sl]).sum().backward()
        group = parallel.model_group()
        records.append({
            'y': parallel.all_gather(y.detach().contiguous(),
                                     group).movedim(0, 2).flatten(2, 3),
            'dx': x.grad,
            'partials': parallel.all_gather(part.grad, group)})
    if rank == 0:
        torch.save(records, os.path.join(out, f'{case["name"]}.pt'))


RUNNERS = {'steps': run_steps, 'restore': run_restore,
           'train': run_train_case, 'bf16': run_bf16,
           'columns': run_columns}


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    parallel.init_distributed('cpu')
    rank = parallel.rank()
    for case in spec['cases']:
        parallel.set_grid(int(case.get('model', 1)))
        RUNNERS[case['kind']](case, rank, spec['out'])
        parallel.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1])
