"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = 'cuda') -> torch.device:
    """Return ``torch.device(device)``; raise if a CUDA device is asked for
    and none is present (never fall back to the CPU quietly).

    Also turns TF32 off for float32 matmuls and convolutions. cuDNN runs
    float32 convolutions in TF32 by default, which keeps about three decimal
    digits: the conv stack would then drift from the float32 reference
    (the JAX package, run at full precision) by far more than the port's
    tolerances allow. And bfloat16 matmuls reduce in float32
    (``model.compute_dtype=bf16``: bf16 products accumulated in float32,
    as XLA's are), not in bfloat16 where cuBLAS may.
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {str(dev)!r} requested but no CUDA '
                           'device is available')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
