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
  runs it (a rank may send itself SIGTERM).
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tests.torch_parallel_worker import (invariance_batch,  # noqa: E402
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


RUNNERS = {'steps': run_steps, 'restore': run_restore,
           'train': run_train_case}


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
