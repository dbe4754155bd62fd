"""Offline serving of a trained Wav2Letter (PyTorch): the offline half of
the JAX package's ``serving/``.

* ``fold`` — BatchNorm folded into the convs (``fold_batchnorm``);
* ``quantize`` — per-channel int8 weights and static activation scales;
* ``infer`` — the folded forward, f32 or int8 weights
  (``offline_forward``) and int8 weights and activations
  (``offline_forward_q8``, int8 tensor cores on the card);
* ``export`` — serving artifacts in the JAX package's format
  (``export_serving``, ``load_serving``) and corpus CMVN;
* ``parallel_infer`` — batched inference, frontend and stack in one call
  (``MeshInference``, one device);
* ``longform`` — exact overlap-chunked inference over one long recording
  (``LongFormTranscriber``).

Streaming, endpointing and the servers are ROADMAP A.8; quantization-aware
finetuning (``qat``) is left for a later slice of A.7.
"""

from .export import (artifact_frontend, compute_cmvn, export_serving,
                     load_serving)
from .fold import fold_batchnorm
from .infer import offline_forward, offline_forward_q8
from .longform import LongFormTranscriber, longform_logprobs
from .parallel_infer import MeshInference
from .quantize import (calibrate_activation_scales, quantize_folded,
                       quantized_bytes)

__all__ = ['fold_batchnorm', 'offline_forward', 'offline_forward_q8',
           'quantize_folded', 'quantized_bytes',
           'calibrate_activation_scales', 'export_serving', 'load_serving',
           'compute_cmvn', 'artifact_frontend', 'MeshInference',
           'LongFormTranscriber', 'longform_logprobs']
