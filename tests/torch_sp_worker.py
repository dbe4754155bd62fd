"""One rank of the port's sequence-parallel checks on the CPU (gloo).

    RANK=r WORLD_SIZE=4 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=P \
        python tests/torch_sp_worker.py spec.json

``tests/test_torch_seq_parallel.py`` starts four of these (torchrun's
environment, set by hand) and holds what they write under the spec's
``out`` directory against one process and the JAX package. The spec
lists scenarios, run in order in one process group; each names its
``model`` and ``seq`` extents, and the world is laid out anew as a
data x model x seq grid (``parallel.set_grid``) before it:

* ``steps``: with ``eval``, first ``trainer.eval_step`` on this
  replica's rows of the batch in ``batch`` (an ``.npz``); then
  ``Trainer.train_step`` ``steps`` times (SGD, momentum 0.9, lr 1e-3,
  from the weights in ``init``) on them. Rank 0 writes the losses, the
  gathered ``Trainer.state_dict()`` and the eval loss and greedy ids of
  the whole batch;
* ``train``: ``train.main(argv)`` as ``tests/torch_parallel_worker.py``
  runs it;
* ``grad64``: one forward and backward of ``grad64_case``'s float64
  Wav2Letter (every rank holds the same rows, the seq group their
  frames); rank 0 writes the loss and the gradients summed over the
  replica group;
* ``bf16``: ``bf16_record`` of ``model.compute_dtype=bf16``, with the
  dtypes of the halo exchanges' inputs; rank 0 writes it.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from tests.torch_parallel_worker import (bf16_record,  # noqa: E402
                                         invariance_trainer, run_train)
from wav2letter_pytorch_tpu_torch import parallel  # noqa: E402
from wav2letter_pytorch_tpu_torch.training import \
    trainer as trainer_mod  # noqa: E402

torch.set_num_threads(1)


def rows(path: str) -> dict:
    """This replica's rows of the batch saved at ``path``."""
    batch = dict(np.load(path))
    k = batch['audio'].shape[0] // parallel.data_world()
    r = parallel.data_rank()
    return {key: torch.from_numpy(v[r * k:(r + 1) * k])
            for key, v in batch.items()}


def run_steps(case, rank, out):
    tr = invariance_trainer(case['overrides'], case['init'],
                            os.path.join(out, case['name']))
    mine = rows(case['batch'])
    record = {}
    if case.get('eval'):
        tr.model.eval()
        loss, ids, _ = trainer_mod.eval_step(
            tr.model, tr.frontend, mine,
            mask_sum=trainer_mod.global_mask_sum(mine['batch_mask']))
        group = parallel.data_group()
        record['eval_loss'] = float(parallel.all_reduce_sum(
            loss.reshape(1), group)[0])
        record['eval_ids'] = parallel.all_gather(ids, group).flatten(0, 1)
    record['losses'] = [float(tr.train_step(mine)[0])
                        for _ in range(int(case.get('steps', 3)))]
    record['state'] = tr.state_dict()
    tr.close()
    if rank == 0:
        torch.save(record, os.path.join(out, f'{case["name"]}.pt'))


def grad64_case(seq_forward):
    """(loss, gradients) of one float64 forward and backward of a
    Wav2Letter with all 20 of W2L-20's kernel sizes, strides and
    dilations at 1/8 of its widths, through ``seq_forward``, on seeded
    features (B=2, 300 frames, ragged) and a CTC loss."""
    from wav2letter_pytorch_tpu_torch.models.wav2letter import (
        WAV2LETTER_LAYERS, Wav2Letter)
    layers = [dict(spec, output_size=spec['output_size'] // 8,
                   dropout=-1.0) for spec in WAV2LETTER_LAYERS]
    model = Wav2Letter(29, 32, layers, 20,
                       generator=torch.Generator().manual_seed(0))
    model = model.double().train()
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(2, 300, 32, generator=gen, dtype=torch.float64)
    lens = torch.tensor([300, 260])
    targets = torch.randint(1, 29, (2, 20), generator=gen)
    out, out_lens = seq_forward(model, feats, lens)
    loss = F.ctc_loss(out.transpose(0, 1), targets, out_lens,
                      torch.tensor([20, 15]), zero_infinity=True)
    loss.backward()
    return loss.detach(), [p.grad for p in model.parameters()]


def run_grad64(case, rank, out):
    loss, grads = grad64_case(trainer_mod.seq_forward)
    parallel.all_reduce_flat(grads, parallel.replica_group())
    if rank == 0:
        torch.save({'loss': loss, 'grads': grads},
                   os.path.join(out, f'{case["name"]}.pt'))


def run_train_case(case, rank, out):
    run_train(case, rank, parallel.world(), out)


def run_bf16(case, rank, out):
    record = bf16_record(case['overrides'], case['init'],
                         os.path.join(out, case['name']), track_halos=True)
    if rank == 0:
        torch.save(record, os.path.join(out, f'{case["name"]}.pt'))


RUNNERS = {'steps': run_steps, 'train': run_train_case, 'grad64': run_grad64,
           'bf16': run_bf16}


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    parallel.init_distributed('cpu')
    rank = parallel.rank()
    for case in spec['cases']:
        parallel.set_grid(int(case.get('model', 1)), int(case.get('seq', 1)))
        RUNNERS[case['kind']](case, rank, spec['out'])
        parallel.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1])
