"""PyTorch/CUDA port of wav2letter_pytorch_tpu for NVIDIA Hopper (H100).

The JAX package ``wav2letter_pytorch_tpu`` is the reference; this package
imports none of it (nor JAX). Plain tensor code is PyTorch; every Pallas
TPU kernel on a ported path is a CUDA C++ kernel under ``csrc/``, built
with nvcc for ``sm_90a`` at first use (``_build.py``).

Ported so far: offline batched greedy evaluation of Wav2Letter
(``python -m wav2letter_pytorch_tpu_torch.evaluate``) and its training
(``python -m wav2letter_pytorch_tpu_torch.train``).
"""

from .runtime import resolve_device

__all__ = ['resolve_device']
