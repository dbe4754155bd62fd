"""Serving of a trained Wav2Letter, Jasper or QuartzNet (PyTorch), offline
and streaming: the JAX package's ``serving/``.

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
  (``LongFormTranscriber``);
* ``streaming`` — chunked stateful Wav2Letter inference, exact against
  the offline forward (``StreamingWav2Letter``, ``StreamingSession``),
  with greedy and beam transcribers; ``streaming_from_artifact``;
* ``streaming_jasper`` — the same for Jasper and QuartzNet
  (``fold_jasper``, ``StreamingJasper``: K1 a phase, K4 a depthwise
  conv), and its artifacts (``export_serving_jasper``);
* ``lookahead`` — bounded-lookahead streaming over the eval-mode models
  (``BoundedLookaheadStreamer``, Wav2Letter and Jasper);
* ``endpoint`` — live endpointing into segments
  (``SegmentingTranscriber``);
* ``server`` / ``net`` — many streams batched into one session
  (``StreamMultiplexer``) and its TCP server and client
  (``StreamingServer``, ``StreamClient``), on one device;
* ``qat`` — quantization-aware finetuning of the fold against its int8
  graph (``qat_forward``, ``qat_finetune``).
"""

from .endpoint import Segment, SegmentingTranscriber
from .export import (artifact_frontend, compute_cmvn, export_serving,
                     export_serving_jasper, load_serving,
                     streaming_from_artifact)
from .fold import fold_batchnorm
from .infer import offline_forward, offline_forward_q8
from .longform import LongFormTranscriber, longform_logprobs
from .lookahead import BoundedLookaheadStreamer, bounded_stream_logprobs
from .net import StreamClient, StreamingServer
from .parallel_infer import MeshInference
from .qat import qat_finetune, qat_forward
from .quantize import (calibrate_activation_scales, quantize_folded,
                       quantized_bytes)
from .server import StreamMultiplexer
from .streaming import (StreamingBeamTranscriber, StreamingSession,
                        StreamingTranscriber, StreamingWav2Letter,
                        stream_logprobs)
from .streaming_jasper import (JasperStreamState, StreamingJasper,
                               fold_jasper)

__all__ = ['fold_batchnorm', 'offline_forward', 'offline_forward_q8',
           'quantize_folded', 'quantized_bytes',
           'calibrate_activation_scales', 'export_serving', 'load_serving',
           'compute_cmvn', 'artifact_frontend', 'MeshInference',
           'LongFormTranscriber', 'longform_logprobs', 'StreamingWav2Letter',
           'StreamingSession', 'StreamingTranscriber',
           'StreamingBeamTranscriber', 'stream_logprobs',
           'streaming_from_artifact', 'BoundedLookaheadStreamer',
           'bounded_stream_logprobs', 'Segment', 'SegmentingTranscriber',
           'StreamMultiplexer', 'StreamingServer', 'StreamClient',
           'export_serving_jasper', 'fold_jasper', 'StreamingJasper',
           'JasperStreamState', 'qat_forward', 'qat_finetune']
