"""Convert a reference (torch / pytorch-lightning) checkpoint into a run dir.

    python -m wav2letter_pytorch_tpu_torch.import_torch_checkpoint \
        --ckpt epoch=4.ckpt --out imported_run model.mid_layers=20

The counterpart of the JAX package's ``scripts/import_torch_checkpoint.py``,
with its flags. The positional arguments are the dotted config overrides
the checkpoint was trained with (a Lightning ``.ckpt`` stores no
hyperparameters, so the model geometry must be restated). The port's
models use the reference's ``state_dict`` layout, so the weights load as
they are (``strict=True``). The output is a run directory of the port's
trainer: ``config.json`` and ``checkpoints/ckpt_0.pt`` in
``Trainer.state_dict()``'s layout (step 0, the model, a fresh optimizer
state) with meta ``{'epoch': 0}``. Evaluate it with ``evaluate
--model-path``, export it with ``export_serving``, finetune it with
``qat_finetune`` or train on from it with ``train --resume``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def load_torch_checkpoint(path: str) -> dict:
    """A Lightning ``.ckpt``'s ``state_dict`` (or a raw state dict), on the
    CPU, as ``training/torch_import.py::load_torch_checkpoint`` reads it."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    sd = obj.get('state_dict', obj) if isinstance(obj, dict) else obj
    if not isinstance(sd, dict) or not sd:
        raise ValueError(f'{path}: no state_dict found')
    return sd


def build_optimizer_safe(params, cfg):
    """The config's optimizer; plain SGD at a constant 1e-4 when it cannot
    be built (a reference optimizer block may name a torch target the
    port does not map): the imported run only needs an optimizer state,
    not the original training schedule."""
    from . import optim
    from .training.build import build_optimizer
    params = list(params)
    try:
        return build_optimizer(params, cfg['model'], 1, 1)
    except Exception:
        return (torch.optim.SGD(params, lr=1e-4), optim.constant_lr(1e-4))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='import a reference torch checkpoint as a run dir')
    parser.add_argument('--ckpt', required=True,
                        help='Lightning .ckpt or raw torch state_dict file')
    parser.add_argument('--out', required=True, help='run dir to create')
    parser.add_argument('overrides', nargs='*',
                        help='config overrides the reference run used '
                             '(model=..., model.mid_layers=..., ...)')
    args = parser.parse_args(argv)

    from .config import load_config
    from .training.build import build_labels, build_model
    from .training.checkpoint import Checkpointer

    cfg = load_config(['data.train_manifest=unused',
                       'data.val_manifest=unused'] + list(args.overrides))
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(load_torch_checkpoint(args.ckpt), strict=True)
    optimizer, _ = build_optimizer_safe(model.parameters(), cfg)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'config.json'), 'w') as f:
        json.dump(cfg, f, indent=2)
    Checkpointer(os.path.join(args.out, 'checkpoints')).save(
        0, {'step': 0, 'model': model.state_dict(),
            'optimizer': optimizer.state_dict(), 'grad_accum': None},
        extra={'epoch': 0})
    n_params = sum(p.numel() for p in model.parameters())
    print(f'imported {args.ckpt} -> {args.out} '
          f'({type(model).__name__}, {n_params:,} parameters)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
