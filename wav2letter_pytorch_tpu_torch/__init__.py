"""PyTorch/CUDA port of wav2letter_pytorch_tpu for NVIDIA Hopper (H100).

The JAX package ``wav2letter_pytorch_tpu`` is the reference; this package
imports none of it (nor JAX). Plain tensor code is PyTorch; every Pallas
TPU kernel on a ported path is a CUDA C++ kernel under ``csrc/``, built
with nvcc for ``sm_90a`` at first use (``_build.py``).

Ported so far: offline batched evaluation of Wav2Letter and the Jasper
family, of a trained run or given weights, with greedy decoding or prefix
beam search and an ARPA LM on the host (``csrc/host/``, C++ built by g++
at first use) or on the card (``python -m
wav2letter_pytorch_tpu_torch.evaluate``), and their training (``python -m
wav2letter_pytorch_tpu_torch.train``).
"""

from .runtime import resolve_device

__all__ = ['resolve_device']
