"""Export a run dir's weights as a reference-format torch checkpoint.

    python -m wav2letter_pytorch_tpu_torch.export_torch_checkpoint \
        --model-path RUN --out model.ckpt [--average-last K]

The counterpart of the JAX package's ``scripts/export_torch_checkpoint.py``
and the inverse of ``import_torch_checkpoint``: the newest checkpoint of a
port run (or, with ``--average-last``, the average of the newest K,
``checkpoint.average_checkpoints``) as ``{'state_dict', 'global_step',
'exported_by'}``. The port's models use the reference's key layout, so the
state dict is the model's own: the reference models, the JAX package's
import script and ``evaluate --weights`` load it ``strict=True``.
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='export run weights as a reference torch checkpoint')
    parser.add_argument('--model-path', required=True)
    parser.add_argument('--out', required=True, help='output .ckpt path')
    parser.add_argument('--average-last', type=int, default=None,
                        help='average the newest K checkpoints first')
    args = parser.parse_args(argv)

    from .training.build import load_run

    _, model, _, step = load_run(args.model_path,
                                 average_last=args.average_last)
    if step is None:
        raise SystemExit(f'{args.model_path}: no checkpoint to export')
    sd = model.state_dict()
    torch.save({'state_dict': sd, 'global_step': step,
                'exported_by': 'wav2letter_pytorch_tpu_torch'}, args.out)
    print(f'wrote {args.out} ({len(sd)} tensors, step {step})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
