#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (wav2letter_pytorch_tpu_torch).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which fails the run (non-zero exit) when a check fails:

1. Environment: torch/CUDA/nvcc versions, the card's name and power limit.
2. Build every kernel under ``wav2letter_pytorch_tpu_torch/csrc/`` with
   nvcc (one process per source, in parallel) and print each kernel's
   registers, shared memory and spills from ptxas; K4 and K5 must spill
   nothing.
3. K1 (stft_mel_log: real FFT, banded mel) against its plain PyTorch
   version (the dense DFT) and a float64 oracle on the card, at 16 kHz,
   8 kHz and a 15 ms hop (B=4, 2 s, ragged lengths), at every n_fft from
   64 to 4096 (through the window length) and at the main path's shape
   (B=32, ~8 s); the wrapper must raise on a CUDA tensor without its
   tables or with an n_fft it does not take.
4. K2 (ctc_alpha) against its plain version over (B, T, L, S) in
   {(8,120,31,40), (8,100,31,40), (16,800,31,70)}, the main path's shape
   and a long shape (32,1000,29,320: ~20 s utterances); plus a float64
   oracle and an impossible alignment; and K2 with stored alphas against
   the plain recursion's alphas on the same shapes. K2 and K3 must raise
   ValueError for a lattice wider than their registers hold (S = 2048).
5. K3 (ctc_beta) through the autograd Function ``CTCLoss`` against its
   plain version on the same shapes: mean loss and d loss / d log_probs
   within 1e-4, and the gradient within 1e-5 of its own largest entry;
   against a float64 oracle (autograd through the float64 plain
   recursion); a batch with an impossible alignment, whose row must get an
   exact-zero, finite gradient; and the same bits from two calls.
6. Eval path: 64 synthetic ~8 s utterances written as WAV files, evaluated
   by ``wav2letter_pytorch_tpu_torch.evaluate.main`` on cuda with the full
   20-layer Wav2Letter (seeded random weights) at B=32; K1 and K2 must
   have launched. The eval step on the card is also held against the same
   step on the CPU (plain versions) on a small input. Then per-batch time,
   utterances per second, peak memory and a profiler breakdown.
7. Training path: ``wav2letter_pytorch_tpu_torch.train.main`` on cuda over
   the same WAVs (train and val manifest), Wav2Letter-20 at full width,
   B=32, the default SGD + ExponentialLR, 4 steps over 2 epochs with
   validation and a checkpoint per epoch, then ``--resume`` for 2 more;
   K1, K2 and K3 must have launched, every logged train loss must be
   finite, and the resumed run must continue from step 4.
8. One full-width train step (B=2 x 1 s; dither, dropout, augment off) on
   the card against the same step on the CPU: loss, the update of every
   parameter and the new BatchNorm statistics.
9. It trains: full width, one repeated batch (B=8, ~2 s), AdamW; the loss
   must fall below 0.7x its first value within a stated number of steps.
10. Train-step time and utterances per second at B=32 of ~8 s, peak
   memory, and a profiler breakdown with the device-busy share.
11. K4/K5 (depthwise forward, input and weight gradient) against their
   plain versions and a float64 oracle on the TPU check grid, the
   QuartzNet main path's C1 shape and shapes at the edges of their tiles
   (``DW_EDGE``), and K5's same bits from two calls; K6/K7 (fused
   separable unit, forward and the three gradients) likewise, with ragged
   lengths, masks on and off, on the TPU grid, the QuartzNet main path's
   unit shapes and shapes at the edges of K6's tiles.
12. QuartzNet-15x5 eval: ``evaluate.main model=quartznet`` at full width on
   the same 64 WAVs, B=32, seeded weights; per forward K4 must launch once
   and K6 76 times; the card's eval step against the CPU's.
13. QuartzNet-15x5 training: ``train.main model=quartznet
   optimizer=novograd``, 4 steps over 2 epochs, then ``--resume`` for 2
   more; K1-K7 must launch. One full-width train step on the card against
   a CPU float64 step on the card's ReLU branches; the loss falls on a
   repeated batch.
14. QuartzNet eval-step and train-step time, utterances per second, peak
   memory and profiler breakdown.
15. Decoding, on the runs of phases 7 and 13 (the host library of
   ``csrc/host/`` is built by g++ in phase 2, its time printed): a 3-gram
   ARPA trained by ``ngram_train`` on the corpus transcripts; sharpened
   random log-probs of 8 rows and half the frames of the main shape (B=8,
   T=202, V=29, ragged lengths, k=8) searched by the device beam search on
   the card and on the CPU, the C++ host search and (1 utterance) the
   Python DP: equal strings
   LM-free, LM-fused, with hotwords and with both, and the card's n-best
   scores within 1e-5 of the CPU's; ``evaluate.main --model-path
   <Wav2Letter-20 run> --average-last 2 --lm-path ... --word-timings
   --dump-jsonl`` over the corpus's first utterance on the device
   and on the host beam backend: equal
   hypotheses (a difference only where the host DP ranks both within
   1e-5), K1 and K2 launched, the loss of the same state restored by hand;
   QuartzNet's run through the host beam on its probabilities over the
   same 2 (K4 and K6 launched); decode ms a B=32 batch under each
   decoder, evaluate() utt/s under each, and the device search's ops a
   frame (profiled over an eighth of the batch's frames).
16. Serving, on phase 7's Wav2Letter-20 run: ``export_serving.main``
   three times (f32 with corpus CMVN; int8 with CMVN and static
   activation scales; f32 with the 3-gram LM bundled); the BN fold on the
   card (``MeshInference('f32')`` on the artifact vs the unfolded model's
   eval forward, within 1e-4 of max |logp|, every greedy string equal but
   at near-ties); ``evaluate.main --artifact --offline`` at B=32 in five
   modes (f32, f32 with CMVN, int8, int8 ``--int8-full``, the LM artifact
   beam-decoding), the f32 one with the WER and CER of ``--model-path``;
   ``transcribe_long.main`` over 2.5 minutes of the corpus, f32 and
   int8_full, each within 1e-3 of the one-shot forward with every argmax
   equal; K1 must have launched. Then int8 card vs CPU (the first layer's
   int32 accumulators equal; int8_full log-probs within 1e-5 of max
   |logp|, dynamic and static scales), int8 weight-only against f32, and
   the serving times: ms a batch and at B=1, utt/s and peak memory a mode,
   the int8_full stack against cuDNN's FP32 stack and its im2col share,
   the widest layer's ``torch._int_mm`` against its cuDNN conv, weight
   bytes, K1's share.
17. Streaming, on phase 7's Wav2Letter-20 run, phase 16's artifacts and
   phase 13's QuartzNet-15x5 run: K1 against its plain version at the
   prime, step and finish buffers (B=1 and B=16, chunk 64); the 64
   utterances streamed through ``streaming_from_artifact`` (f32 + CMVN)
   against ``MeshInference('f32')`` under the same CMVN, within 1e-4 of
   max |logp|, every greedy string equal but at near-ties; int8 weights
   (1e-4) and int8_full with dynamic and static scales (1e-5, argmax
   equal) streamed on the card against the CPU; ``evaluate.main``
   streaming on the card (``--artifact`` over the first 4 utterances,
   its records those of ``--artifact --offline --offline-norm cmvn``
   where the strings are equal; over the first utterance ``--model-path
   --streaming`` with
   cumulative and CMVN
   normalisation and ``--int8``; ``--lookahead-frames`` 96 and the full
   one-sided context), K1 counted and gated around each (one a prime,
   step and finish; one a frontend chunk and a finish for the lookahead
   streamer); the full-context lookahead streamer's interior rows within
   1e-4 of the offline forward; QuartzNet's bounded lookahead (K4 once and
   K6 76 times a window) on the card against the CPU on one utterance; ``serve_tcp``'s
   server with 16 slots and 16 concurrent clients (one s16, one at 8 kHz),
   every FINAL a dedicated session's, the 17th refused BUSY; the times:
   prime, step and finish at B=1, ``StreamMultiplexer.tick`` at 16 and
   64 slots per weights mode with the real-time factor, launches, busy
   share, K1's share and peak memory.
18. Exact QuartzNet-15x5 streaming (``StreamingJasper``: K1 once a
   prime, step and finish, K4 on each of the 77 depthwise convs a phase),
   on phase 13's run and its f32 artifact with CMVN, over 2 clips of 6
   corpus utterances (~48.2 s each, past the 40.30 s prime window): K4
   against its plain version at every shape the streamer gives it (a
   prime, step and finish at B=1, a step at B=16) and K1 at the phases'
   buffers; the streamed probabilities against the eval forward (K4 +
   K6) on the clips zero-padded past the lookahead, within 1e-4 of max
   |log p|, greedy strings equal but at near-ties; the streamer on the
   card against the CPU (f32, int8 weights, int8_full; one clip);
   ``evaluate
   --streaming --streaming-norm cmvn`` on the run and ``evaluate
   --artifact`` on the artifact, no offline fallback, the dumps the
   exactness check's strings, K1 and K4 counted and gated around each;
   ``StreamMultiplexer`` over 8 streams against dedicated sessions; the
   times: prime, step and finish at B=1, a tick at 16 slots (f32 and
   int8_full) with launches, busy share and peak memory, and the host's
   time by function.
19. The data layer: ``make_offline_corpus`` writes a FLAC corpus (64 /
   16 / 1 utterances, seeds 0 / 1 / 2, the test split past W2L-20's
   prime window) and 2 utterances each at 8 and 22.05 kHz; (a) every
   file decodes through the C++ decoder to round(audio * 32767) of its
   rendered utterance, the Python decoder gives the same samples on 2
   files, the two STREAMINFO parsers agree; (b) an int16 loader batch /
   32768 equals the f32 batch bit for bit and so do K1's features on the
   card, without and with dither (one launch a forward, 4 in all); (c)
   two epochs with ``cache_audio``: the second reads no file, the batches
   are equal; (d) the 8 and 22.05 kHz manifests resampled in the loader:
   lengths ceil(n * up / down), raw features card vs CPU within 1e-5 of
   max |ref|, K1 once a batch; (e) a W2L-20 MFCC eval
   step card vs CPU, and an MFCC artifact streamed (1 utterance) against
   its offline
   forward (1e-4 of max |logp|, K1 once a phase); (f)
   ``full_depth_run.main`` at full width for 2 epochs with the recipe's
   cache_audio, int16 and augment-map overrides: the loss falls, every
   evaluate mode of the chain runs (WER printed, not gated), K1/K2/K3
   pinned in each stage (training, each evaluate call, the export); (g)
   host decode rates (C++ and Python); the loader alone in each epoch,
   the recipe's train step alone over an epoch's batches at B=16, and
   the two together as in training (epoch 1 decoding, epoch 2 from the
   cache), in utt/s and s of audio a second; bytes a batch on the int16
   and f32 wires.
20. Quantization-aware finetuning (``serving/qat.py``) of phase 7's
   Wav2Letter-20 fold against phase 16's int8 + CMVN + static-scales
   artifact, B=16 of the corpus: ``qat_forward`` on the card against
   ``offline_forward_q8`` on the card (static and dynamic scales, within
   atol 5e-3 + rtol 1e-3) and, every layer exempted, against
   ``offline_forward`` on the int8 weights (1e-5); one QAT step
   (``qat_finetune``) with K1, K2 and K3 counted (one launch each; K3's
   wrapper makes two) and its loss on the card against the CPU's (1e-3
   relative, 2 rows); 40 LAMB steps at 3e-3 on one batch lower the int8
   graph's CTC loss; the step's ms, utt/s, peak memory and busy share;
   ``qat_finetune.main`` (10 steps, int8_full WER before and after on the
   corpus, launches pinned), whose artifact loads with int8 weights equal
   to ``quantize_folded`` of the trained fold bit for bit, and
   ``evaluate --artifact --offline --int8-full`` on it.
21. The serving tools on a model that trains: ``validate_serving`` (it
   trains ``train_synthetic_demo``'s 3-layer model on 400 tone-language
   utterances for 30 epochs, exports f32 and int8 artifacts, holds the
   live model, the fold, the f32 artifact and the CMVN stream to each
   other and the seven WER rows to their same-tag checks) must exit 0;
   ``qat_finetune`` on the demo model (int8_full WER before and after,
   printed); ``build_arpa`` on its train split; ``align`` on its val
   split through the f32 artifact, no failure; ``error_analysis`` of an
   ``evaluate --dump-jsonl`` of the val split, its WER the eval's. Phase
   22's (c) ranks run beside it.
22. Data parallelism (``parallel/mesh.py``): (a) ``train.main`` under
   ``python -m torch.distributed.run --nproc-per-node 1`` (NCCL, world
   1) on Wav2Letter-20 at full width, B=32, 2 steps, dropout off, against
   the ungrouped ``train.main``, each a fresh process (``chip_smoke.py
   --train-worker``) with cuDNN's deterministic algorithms: losses and
   weights within 1e-6 relative, K1-K3's launches equal, the step's ms in
   both and the gap (the collectives' cost at world 1; nothing else runs
   on the card); (b) the same for
   QuartzNet-15x5 (NovoGrad, 2 steps, K1-K7); (c) two ranks on the one
   card over gloo (``init_distributed(backend='gloo')``, then
   ``train.main``), Wav2Letter with 4 layers at full width, a global B=8
   as 4 + 4 with rank 1's last row masked, 3 steps (started beside phase
   21, done before (a) starts), against one process
   on the card (losses 1e-5, weights rtol 2e-4 atol 2e-6), and which
   collectives gloo takes on CUDA tensors; (d) serving over
   ``make_mesh()`` and over a mesh of two entries of the one card (the
   row split, a launch a part, the concatenation and the per-device
   frontends and streamers run): ``MeshInference`` f32 and int8_full and
   the long-form windows over both, ``transcribe_long --mesh`` and a
   ``serve_tcp --mesh`` round trip, a ``StreamingServer`` over the pair
   with a streamer built on each entry, each the bits of its
   ``mesh=None`` path, K1 counted.
23. Tensor parallelism (``parallel/tp.py``), ranks sharing the one card
   over gloo, each run with cuDNN's deterministic algorithms and dropout
   off against one process (``train_worker`` in this process) on the
   same global batch: (a) Wav2Letter-20 at full width,
   ``trainer.mesh.model=2``, B=8 of ~8 s, 3 steps; (b) QuartzNet-15x2
   (QuartzNet-15x5 at full width with 2 repeats a block), NovoGrad,
   model=2, 2 steps; (c) Wav2Letter-4 at full width
   on four ranks, data=2 x model=2, B=8 as 4 + 4 with the second
   replica's last row masked, a gradient clip, 3 steps. Gates: every
   step's loss within 1e-5 relative; the weights and BN statistics after
   the first update ((c): after every update) within rtol 2e-4 atol
   2e-6; the first update of each optimizer moment, and the TP run's
   last update of the weights, the BN statistics and each optimizer
   moment against one process's resumed from the TP checkpoint before
   it, within 1e-3 relative distance beyond float32 rounding, while the
   TP run without its last update (the control) lies outside it; each
   rank's K1-K3 (K1-K7 for QuartzNet) launches equal to the one
   process's; each rank's conv weights and their optimizer state at
   most 0.55 of the one process's; (c)'s checkpoint loads strict=True
   into one process and
   ``evaluate.main --model-path`` on the TP run gives that model's loss
   evaluated by hand to the bit, within 1e-5 of the one-process
   checkpoint's, log p within 1e-4. Printed: each rank's bytes of
   parameters, buffers and optimizer state and its peak memory in a
   train step and in a checkpoint save beside the one process's, the
   step's ms of both ((c)'s ranks run beside (a)'s and (b)'s), K6 and
   K7 a launch with the whole and a model=2 rank's pointwise weight.
24. Sequence parallelism (``parallel/sp.py``): (a) and (b) of phase 23
   at ``trainer.mesh.seq=2`` on two ranks sharing the card over gloo
   (activations sharded over time, every conv fed by a halo exchange;
   started beside phase 23's ranks, so both
   phases' step times share the card and the host), against phase 23's
   one-process runs
   (the first step's loss, each rank's launches, peak memory and step
   ms, printed beside the one process's) and against one process forced
   onto the clamp / ReLU branches the SP ranks recorded (its first
   update, at phase 23's bars; its last update and loss, resumed from
   the SP checkpoint before it, within 1e-3 relative distance, the
   control outside it); K1-K7 against their plain versions (K4-K7 also
   the float64 oracle) at the SP path's shapes.
   Phases 23's and 24's bf16 cases, more cases of the same
   ``train.main`` runs (``full_width_cases``, ``bf16_par_compare``): (a)
   and (b) in ``model.compute_dtype=bf16`` at model=2 and at seq=2, 2
   steps, and at the CPU tests' depth (3 layers / 2 blocks) 1 step,
   against one process's ``train.main`` in bf16 from the same weights on
   the same B=8 batch: the trained model's eval log-probs on its grid
   within one bf16 ulp of its checkpoint's loaded strict=True (float32
   only) into one process; each loss from a shared state (step 1 from
   the init, step 2 from the parallel run's step-1 checkpoint) within
   1e-3; the BN statistics within 2e-2 relative distance; the update
   within 2e-2 at the CPU tests' depth (``tests/test_torch_bf16.py``'s
   bars) and at full depth within twice a witness's (one process resumed
   from the same state with its weights one float32 ulp apart) and
   nearer one process's than the control; at full depth the eval
   log-probs' mean distance below half of bf16's own from float32 on the
   same checkpoint (W2L-20's cuDNN convs over a rank's half sum in other
   orders); each rank's launches equal
   to the one process's; K4-K7 on bf16 x at a model=2 rank's shapes (C1
   over half its channels, each unit with half its pointwise columns)
   and a seq=2 rank's; the steps' ms (contended) and each rank's peak
   memory.
25. bf16 compute (``model.compute_dtype=bf16``): K4-K7 on bf16 x against
   their plain versions and a float64 oracle on the same bf16 values
   (phase 11's shapes and phase 24's SP shapes; a bf16 output within one
   ulp of the reference rounded to bf16, or within the float32 gate where
   its float32 sum cancels; float32 outputs at phase 11's gates; the
   same bits twice); Wav2Letter-20 and QuartzNet-15x5 at full width in
   bf16: ``train.main`` (2 steps) and ``evaluate.main --model-path`` on
   the run, 6 AdamW steps on one repeated B=32 batch with the loss
   falling (K4-K7's bf16 launches pinned over these), the bf16 and f32
   train and eval steps' ms, peak memory and conv TFLOP/s, bf16 vs f32
   log-probs (at full depth and at 2 layers / blocks), and the card's
   bf16 eval and train steps against the CPU's.
26. The kernel-selection knobs and the validation decoders: an eval and
   a train step of Wav2Letter-20 (B=32) built with
   ``model.stft_method=conv trainer.ctc_impl=scan`` launch no K1-K3,
   their features within 1e-3 and losses within 1e-4 of the default
   path's; with ``pallas`` for both they launch K1-K3 and give the
   default's bits. ``Trainer.validate`` of a seeded Wav2Letter-20 made
   peaky (BatchNorm statistics of a corpus batch, its head scaled to a
   12-nat spread of log-probs across the labels) with the greedy decoder,
   the host ``PrefixBeamSearchLMDecoder`` and the ``DeviceBeamDecoder``
   (k=16, built by ``build_decoder`` from ``model.decoder``): over the
   corpus's first B=32 batch on the card, finite metrics, one val_loss,
   the two searches' metrics equal, K1 and K2 launched, the ms of each;
   over its first utterance on the card and on the CPU, each
   decoder's metrics equal (the device search's to the CPU's host
   search), the loss within 1e-3.
27. One ``{"kernels": [...]}`` line: per kernel its launches on the
   training path (K1-K3 Wav2Letter's, K1 also the serving, streaming
   and data paths', K1-K3 the QAT paths' of phases 20-21, K4-K7
   QuartzNet's, K4 also its lookahead and exact streams', K6 its
   lookahead stream's, each kernel's ``mesh_launches`` on phase 22's
   paths, ``tp_launches`` on phase 23's and ``sp_launches`` on phase
   24's, ``tp_bf16_launches`` / ``sp_bf16_launches`` on their bf16
   cases'; K4-K7's ``bf16_launches`` on phase 25's; K1-K3's
   ``knob_launches`` and K1-K2's ``beam_validation_launches`` on phase
   26's), max error against the
   plain version, time, plain time, roofline bound and the time of the
   nearest PyTorch library call (timed here only); then a row for each of
   K4-K7 on bf16 x (``<name>_bf16``). K2 and K3 are also timed at the long
   shape, and each prints its ns a dependent step.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits 1 before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import ctypes
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from wav2letter_pytorch_tpu_torch import _build
from wav2letter_pytorch_tpu_torch import align as port_align
from wav2letter_pytorch_tpu_torch import build_arpa as port_arpa
from wav2letter_pytorch_tpu_torch import error_analysis as port_errors
from wav2letter_pytorch_tpu_torch import evaluate as port_eval
from wav2letter_pytorch_tpu_torch import export_serving as port_export
from wav2letter_pytorch_tpu_torch import full_depth_run as port_fdr
from wav2letter_pytorch_tpu_torch import make_offline_corpus as port_corpus
from wav2letter_pytorch_tpu_torch import qat_finetune as port_qat
from wav2letter_pytorch_tpu_torch import serve_tcp as port_serve
from wav2letter_pytorch_tpu_torch import train as port_train
from wav2letter_pytorch_tpu_torch import transcribe_long as port_long
from wav2letter_pytorch_tpu_torch import validate_serving as port_validate
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.data import dataset as port_dataset
from wav2letter_pytorch_tpu_torch.data import flac as port_flac
from wav2letter_pytorch_tpu_torch.data import flac_native
from wav2letter_pytorch_tpu_torch.data.audio_io import (audio_info, read_wav,
                                                        write_wav)
from wav2letter_pytorch_tpu_torch.data.dataset import (BucketBatchLoader,
                                                       ManifestDataset)
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.data.label_sets import resolve_labels
from wav2letter_pytorch_tpu_torch.data.resample import (resample,
                                                        resample_ratio)
from wav2letter_pytorch_tpu_torch.decoding.arpa_lm import ArpaLM
from wav2letter_pytorch_tpu_torch.decoding.beam_device import (
    DeviceBeamDecoder, beam_search_device, beam_search_device_lm)
from wav2letter_pytorch_tpu_torch.decoding.beam_native import \
    prefix_beam_search_native
from wav2letter_pytorch_tpu_torch.decoding.decoder import (
    DEFAULT_BEAM_ALPHA, DEFAULT_BEAM_BETA, DEFAULT_BEAM_K, DEFAULT_BEAM_PRUNE,
    PrefixBeamSearchLMDecoder, prefix_beam_search)
from wav2letter_pytorch_tpu_torch.decoding.ngram_train import train_arpa
from wav2letter_pytorch_tpu_torch.models.base import (frozen_statistics,
                                                      get_same_padding)
from wav2letter_pytorch_tpu_torch.models.jasper import Activation
from wav2letter_pytorch_tpu_torch.ops.ctc import (ctc_beta_reference,
                                                  ctc_loss, reduce_ctc)
from wav2letter_pytorch_tpu_torch.ops.ctc_kernel import (ctc_alpha,
                                                         ctc_alpha_reference,
                                                         ctc_beta,
                                                         ctc_loss_kernel)
from wav2letter_pytorch_tpu_torch.ops.depthwise import (
    depthwise_dgrad, depthwise_fwd, depthwise_fwd_reference, depthwise_wgrad,
    depthwise_wgrad_reference, fwd_plan, wgrad_plan)
from wav2letter_pytorch_tpu_torch.ops.depthwise import \
    out_length as dw_out_length
from wav2letter_pytorch_tpu_torch.ops.sep_conv import (mask_lengths, sep_bwd,
                                                       sep_bwd_reference,
                                                       sep_fwd,
                                                       sep_fwd_reference,
                                                       shifted_lengths)
from wav2letter_pytorch_tpu_torch.ops.sep_conv import \
    out_length as sep_out_length
from wav2letter_pytorch_tpu_torch.optim import constant_lr
from wav2letter_pytorch_tpu_torch.parallel import sp
from wav2letter_pytorch_tpu_torch.serving import (
    BoundedLookaheadStreamer, MeshInference, StreamClient, StreamingJasper,
    StreamMultiplexer, StreamingTranscriber, StreamingWav2Letter,
    artifact_frontend, bounded_stream_logprobs, fold_batchnorm, load_serving,
    offline_forward, offline_forward_q8, quantize_folded, quantized_bytes,
    stream_logprobs, streaming_from_artifact)
from wav2letter_pytorch_tpu_torch.serving import infer as serving_infer
from wav2letter_pytorch_tpu_torch.serving import qat as serving_qat
from wav2letter_pytorch_tpu_torch.serving import streaming_jasper
from wav2letter_pytorch_tpu_torch.serving.server import \
    _map_state as map_state
from wav2letter_pytorch_tpu_torch.serving.lookahead import (
    _conv_specs_jasper, _conv_specs_w2l, one_sided_context)
from wav2letter_pytorch_tpu_torch.training.build import (build_decoder,
                                                         build_frontend,
                                                         build_labels,
                                                         build_model,
                                                         build_optimizer,
                                                         load_run,
                                                         run_config)
from wav2letter_pytorch_tpu_torch.training.checkpoint import (
    Checkpointer, average_checkpoints)
from wav2letter_pytorch_tpu_torch.training.trainer import (Trainer,
                                                           masked_ctc_mean,
                                                           seq_forward)
from wav2letter_pytorch_tpu_torch.ops.stft_mel import (K1Tables,
                                                       stft_mel_log,
                                                       stft_mel_log_reference)

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # FP32 outside the tensor cores
# Gates: the TPU kernel checks' tolerances (scripts/run_tpu_checks.py).
K1_TOL = 5e-3               # max abs on normalised features
K2_TOL = 1e-4               # |d loss| per sample, loss = nll / max(tl, 1)
K1_ORACLE_TOL = 1e-3        # raw log-mel vs float64 (f32 rounding only)
# n_fft of phase_k1's sweep: every size the kernel takes.
K1_FFT_SWEEP = (64, 128, 256, 512, 1024, 2048, 4096)
K2_ORACLE_RTOL = 1e-5       # nll vs float64, relative
# Stored alphas vs the plain recursion's, relative to max(1, |alpha|): the
# same float32 arithmetic, so only rounding differences.
K2_ALPHA_RTOL = 1e-5
# K3: run_tpu_checks.py's gate, |d mean loss| and max |d grad| (the kernel
# sums gamma with atomics, in an order that varies from run to run).
K3_TOL = 1e-4
# The same comparison without a scale: max |d grad| / max |grad|. Under the
# mean reduction the gradient is ~1e-4 at the main path, where K3_TOL alone
# would pass a kernel 20 % off; the atomics' order moves it by ~1e-7.
K3_RTOL = 1e-5
# Grad vs autograd through the float64 recursion, max |d grad| / max |grad|:
# the float32 recursion itself is 1.0e-3 off at the main path and 2.5e-3 at
# T=800 (H100; on the grid the plain version on the CPU reads the same).
K3_ORACLE_RTOL = 5e-3
# K4-K7 against their plain versions, max |d| / max |plain| of each output
# (y, dx, dw; dwdw, dwpw): the same float32 arithmetic in other orders
# (FMA chains and fixed-order partial sums in the kernels).
SEP_DW_RTOL = 1e-5
# ... and against a float64 oracle (the plain version in float64, its
# gradients by autograd): the float32 plain version's own error there, on
# the CPU (tools/plain_oracle_errors.py), is at most 4.09e-7 (K4/K5) and
# 8.45e-7 (K6/K7) over these grids; the gates leave 10x for the kernels'
# summation orders.
DW_PLAIN_ORACLE, SEP_PLAIN_ORACLE = 4.1e-7, 8.5e-7
DW_ORACLE_RTOL = 10 * DW_PLAIN_ORACLE
SEP_ORACLE_RTOL = 10 * SEP_PLAIN_ORACLE
# (B, T, C, K, stride, dilation): scripts/run_tpu_checks.py's depthwise
# grid, then QuartzNet's C1 at the main path (64 mels, 808 frames).
DW_GRID = [(4, 400, 256, 33, 1, 1), (4, 400, 512, 74, 1, 1),
           (4, 801, 64, 33, 2, 1), (2, 400, 512, 87, 1, 2)]
DW_MAIN = (32, 808, 64, 33, 2, 1)
# Shapes at the edges of K4's and K5's tiles (ops/depthwise.py's plans: K4
# tiles and K5 chunks of ~128 frames, K4's in whole groups of 16 d', 32
# channels a block, 16-byte copies when C % 4 == 0): T_out one short of a
# tile, one tile, one over (C = 40, not a multiple of 32); the same at two
# tiles (C = 48); C = 8 and C = 50 (4-byte copies) at stride 2 with even
# and odd T; K = 1; an even K at stride 2; C2's K = 87 at d = 2; B = 521,
# where K5's second launch sums 521 partials.
DW_EDGE = [(2, 127, 40, 33, 1, 1), (2, 128, 40, 33, 1, 1),
           (2, 129, 40, 33, 1, 1), (3, 255, 48, 33, 1, 1),
           (3, 256, 48, 33, 1, 1), (3, 257, 48, 33, 1, 1),
           (2, 100, 8, 33, 2, 1), (2, 101, 50, 33, 2, 1),
           (3, 50, 32, 1, 1, 1), (2, 100, 50, 32, 2, 1),
           (2, 150, 40, 87, 1, 2), (521, 40, 8, 5, 1, 1)]
# (B, T, Cin, Cout, K, dilation): run_tpu_checks.py's separable grid, then
# QuartzNet's unit shapes at the main path (B1/B2, B3's first, B5, C2).
SEP_GRID = [(4, 400, 256, 256, 33, 1), (4, 400, 512, 512, 74, 1),
            (2, 400, 512, 512, 87, 2)]
SEP_MAIN = [(32, 404, 256, 256, 33, 1), (32, 404, 256, 512, 51, 1),
            (32, 404, 512, 512, 75, 1), (32, 404, 512, 512, 87, 2)]
# Shapes at the edges of K6's tiles (64 frames, 256 or 512 output channels,
# chunks of 16 input channels, 16-byte copies when Cin and Cout are
# multiples of 4): Cout not a multiple of the tile (200, 640; 198 also not
# of 4), Cin not a multiple of the chunk (100; 50 also not of 4), T_out
# shorter than one tile, K = 1 with p = 0, d = 2 with an even K.
SEP_EDGE = [(2, 100, 64, 200, 33, 1), (2, 100, 64, 640, 33, 1),
            (2, 100, 100, 256, 33, 1), (2, 70, 50, 198, 9, 1),
            (3, 40, 256, 512, 33, 1), (2, 100, 128, 256, 1, 1),
            (2, 100, 64, 96, 4, 2)]
# Shapes at the edges of K7's tiles (time tiles of 64 frames, 32 input
# channels a block, 128 x 128 dwpw tiles): T_out one short of a tile, one
# tile, one over (with Cin 48, 96, 160 not multiples of 32 and Cout 200,
# 136, 264 not of 128); 5 tiles of 301 frames, 2 a block, with Cin 500 and
# Cout 130 (not a multiple of 4: 4-byte copies in the dwpw product); C2's
# K = 87, d = 2 with Cin 42 (4-byte copies in the depthwise pass).
SEP_BWD_EDGE = [(2, 63, 48, 200, 33, 1), (2, 64, 96, 136, 33, 1),
                (2, 65, 160, 264, 33, 1), (16, 301, 500, 130, 33, 1),
                (3, 65, 42, 128, 87, 2)]
# QuartzNet-15x5's K6 units per forward at B=32, T=404: (Cin, Cout, K,
# dilation) -> count; 76 in all.
SEP_PATH_UNITS = {(256, 256, 33, 1): 15, (256, 256, 39, 1): 15,
                  (256, 512, 51, 1): 1, (512, 512, 51, 1): 14,
                  (512, 512, 63, 1): 15, (512, 512, 75, 1): 15,
                  (512, 512, 87, 2): 1}
QN = ['model=quartznet']    # QuartzNet-15x5, all 18 blocks, full width
QN_UNITS = 76               # K6 launches per QuartzNet forward
# Card vs CPU train step (full width, B=2 x 1 s): float32 convolutions
# summed in another order through 20 layers and their backward.
STEP_LOSS_RTOL = 1e-3
STEP_UPDATE_RTOL = 1e-3     # relative global norm of the update difference
MAX_BRANCH_FLIPS = 32       # clamp branches taken differently (of ~1.2 M);
                            # 6 and 11 seen on the H100, ~3x the larger
STEP_BN_RTOL = 1e-3         # relative global norm of the BN stats difference
# QuartzNet's update against the float64 step on the card's branches: the
# float32 floor at this depth is ~1e-3 (9.76e-4 measured on the H100 with
# NovoGrad, whose per-tensor normalisation gives every tensor's error the
# same weight), so the gate is relative to the CPU float32 step's own error
# against float64 on the CPU's branches, measured in the same run.
JASPER_UPDATE_FLOOR_RATIO = 3.0
JASPER_UPDATE_RTOL = 1e-2   # and an absolute cap
# QuartzNet: ReLU branches taken differently on the card and the CPU, as a
# share of all ReLU inputs (3.3 M at B=2 x 1 s): 105 of them (3.2e-5) on an
# H100, ~3x Wav2Letter-20's share (6-11 of 1.2 M); the gate leaves ~30x.
RELU_FLIP_SHARE = 1e-3
# It trains: AdamW at this lr on one repeated batch, dropout off, a fixed
# number of steps; the last loss must be below this share of the first.
OVERFIT_LR, OVERFIT_STEPS, OVERFIT_RATIO = 3e-4, 40, 0.7
# Main path: full-width Wav2Letter-20, B=32, ~8 s utterances. Lengths in
# (127840, 129120] samples share the loader's bucket edge 129120 (808
# frames), so every batch has the main path's shape.
N_UTTS, BATCH, LEN_LO, LEN_HI = 64, 32, 127841, 129120
MID_LAYERS = 20  # Wav2Letter-20: every layer of configs/model/wav2letter.yaml
DEVICE = torch.device('cuda')
# Operations per lattice update in K2: two logaddexp (max, sub, abs, exp,
# log1p, add) and the emission add. K3: the same per beta update (its
# emission add forms u); per gamma, an add, a subtract, an exp and the sum.
K2_OPS_PER_UPDATE = 13
K3_OPS_PER_UPDATE = 13
K3_OPS_PER_GAMMA = 4
# K2/K3's long shape (B, T, L, S): ~20 s utterances at Wav2Letter's stride
# 2 with a transcript of up to 320 characters.
CTC_LONG = (32, 1000, 29, 320)
WORDS = ('the of and to a in that is was he for it with as his on be at by '
         'had not are but from or have an they which one you were her all '
         'she there would their we him been has when who will more no if '
         "out so said what up its about into than them can only other new "
         "some could time these two may then do first any my now such like "
         "our over man me even most made after also did many before must "
         "through back years where much your way well down should because "
         "each just those people mr how too little state good very make "
         "world still own see men work long get here between both life "
         "being under never day same another know while last might us great "
         "old year off come since against go came right used take three "
         "don't it's").split()


def fail(msg: str):
    raise SystemExit(f'chip_smoke: FAIL: {msg}')


def check(ok: bool, msg: str):
    print(f'[{"OK" if ok else "FAIL"}] {msg}', flush=True)
    if not ok:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            queued: bool = True) -> float:
    """Mean time of ``fn`` in ms, by CUDA events around ``iters`` calls
    (inputs stay in L2 as they do on the main path, where each kernel's
    input was written just before). ``queued``: the calls wait behind a
    ~0.1 s spin of the card (``torch.cuda._sleep``), so every launch is on
    the stream before the first one runs and the events time the device
    alone. Back to back (``queued=False``) they also time the host's launch
    cost wherever a call's host side takes longer than its kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_rows(prof) -> list:
    """Kernel and memcpy rows of a profile: operator rows repeat their
    kernels' time, and a user annotation's device row (the optimizer's
    ``Optimizer.step#...`` and ``Optimizer.zero_grad#...``) spans its
    kernels and the gaps between them."""
    return [e for e in prof.key_averages()
            if str(getattr(e, 'device_type', '')).endswith('CUDA')
            and getattr(e, 'self_device_time_total', 0) > 0
            and not getattr(e, 'is_user_annotation', False)
            and not e.key.startswith(('Optimizer.', 'ProfilerStep'))]


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        'nvidia-smi: no output'


# ------------------------------------------------------------------ phases

def phase_environment():
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}')
    nvcc = subprocess.run([_build.find_nvcc(), '--version'],
                          capture_output=True, text=True, timeout=60)
    print('nvcc: ' + nvcc.stdout.strip().splitlines()[-1])
    print(card_line(), flush=True)


def phase_build():
    t0 = time.time()
    paths = _build.build(_build.kernel_sources())
    print(f'built {sorted(paths)} in {time.time() - t0:.1f} s')
    for name, path in sorted(paths.items()):
        with open(path + '.log') as f:
            lines = f.read().splitlines()
        # ptxas -v: "Function properties for <mangled>", its stack and spill
        # line, then "Used N registers, ... smem"; name each kernel.
        ptxas = []
        for line in lines:
            m = re.search(r'Function properties for '
                          r'\S*?([a-z][a-z0-9_]*_kernel)', line)
            if m:
                ptxas.append(m.group(1) + ':')
            elif 'Used' in line or 'spill' in line:
                ptxas.append(line.replace('ptxas info    :', '').strip())
        print(f'  {name}: ' + ' '.join(ptxas))
        if name == 'depthwise':
            spills = [line for line in lines if re.search(
                r'[1-9]\d* bytes spill (stores|loads)', line)]
            check(not spills, 'ptxas: K4 and K5 spill nothing'
                  + ''.join(f'; {line.strip()}' for line in spills))
    for name in paths:
        _build.load(name)
    t0 = time.time()
    host = _build.build_host()
    _build.load_host()
    print(f'host library {os.path.relpath(host)} (g++ '
          f'{" ".join(_build.GXX_FLAGS)}) built and loaded in '
          f'{time.time() - t0:.1f} s', flush=True)


def k1_inputs(conf: AudioConfig, B: int, T: int, lens, seed: int, device):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / conf.sample_rate
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)[None]
             + 0.1 * rng.standard_normal((B, T))).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    audio[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    fe = SpectrogramFrontend(conf, n_mels=64, dither=0.0, device=device)
    a = torch.from_numpy(audio).to(device)
    l = torch.from_numpy(lens).to(device)
    return fe, fe.prepare(a, l), l, 1 + T // fe.hop


def k1_args(fe, padded, nf):
    """The plain version's arguments (dense bases) for a frontend."""
    return (padded, nf, fe.hop, fe.dft_re, fe.dft_im, fe.fb_t)


def k1_compare(name, fe, padded, lens, nf):
    """K1 (real FFT, banded mel) against the plain dense DFT, normalised
    features, and the raw log-mel against the float64 oracle."""
    args = k1_args(fe, padded, nf)
    raw_k = stft_mel_log(*args, fe.k1_tables())
    raw_p = stft_mel_log_reference(*args)
    norm_k, _ = fe.normalize(raw_k, lens)
    norm_p, _ = fe.normalize(raw_p, lens)
    oracle = stft_mel_log_reference(*(a.double() if torch.is_tensor(a)
                                      else a for a in args))
    torch.cuda.synchronize()
    raw_err = (raw_k - raw_p).abs().max().item()
    norm_err = (norm_k - norm_p).abs().max().item()
    o_err = (raw_k.double() - oracle).abs().max().item()
    p_err = (raw_p.double() - oracle).abs().max().item()
    check(norm_err <= K1_TOL and o_err <= K1_ORACLE_TOL
          and bool(torch.isfinite(raw_k).all()),
          f'K1 {name} n_fft {fe.n_fft} {tuple(padded.shape)} -> '
          f'{tuple(raw_k.shape)}: normalised max err {norm_err:.3e} (gate '
          f'{K1_TOL}), raw log-mel max err {raw_err:.3e}; vs float64 oracle '
          f'{o_err:.3e} (gate {K1_ORACLE_TOL}; plain version {p_err:.3e})')
    return norm_err


def phase_k1():
    dev = DEVICE
    errs = []
    for name, kw in (('16k', {}), ('8k', dict(sample_rate=8000)),
                     ('16k-hop15ms', dict(window_stride=0.015))):
        conf = AudioConfig(**kw)
        n = 2 * conf.sample_rate
        fe, padded, lens, nf = k1_inputs(
            conf, 4, n, [n, 3 * n // 4, n // 2, n // 3 - 1], 0, dev)
        errs.append(k1_compare(name, fe, padded, lens, nf))
    # Every n_fft the kernel takes, through the window length at 16 kHz.
    for n_fft in K1_FFT_SWEEP:
        conf = AudioConfig(window_size=n_fft / 16000)
        n = 16000
        fe, padded, lens, nf = k1_inputs(conf, 2, n, [n, n // 2 + 7], 2, dev)
        assert fe.n_fft == n_fft, (fe.n_fft, n_fft)
        errs.append(k1_compare('sweep', fe, padded, lens, nf))
    # A CUDA tensor without the kernel's tables, or with an n_fft the kernel
    # does not take, raises before any launch.
    before = stft_mel_log.launches
    for what, tables in (('no tables', None),
                         ('n_fft 8192', K1Tables(
                             torch.zeros(8192, device=dev),
                             torch.zeros(8192, 2, device=dev),
                             fe.k1_bands, fe.k1_weights))):
        try:
            stft_mel_log(*k1_args(fe, padded, nf), tables)
            raised = ''
        except ValueError as e:
            raised = str(e)
        check(bool(raised) and stft_mel_log.launches == before,
              f'K1 wrapper raises ValueError on a CUDA tensor with {what}: '
              f'{raised!r}')
    rng = np.random.default_rng(1)
    lens = rng.integers(LEN_LO, LEN_HI + 1, size=BATCH)
    fe, padded, lens_t, nf = k1_inputs(AudioConfig(), BATCH, LEN_HI, lens,
                                       1, dev)
    errs.append(k1_compare('main path', fe, padded, lens_t, nf))
    return max(errs), (fe, padded, nf)


def k2_inputs(B, T, L, S, seed, device, tl_lo=10, ll_lo=None):
    g = torch.Generator(device='cpu').manual_seed(seed)
    lp = torch.randn(B, T, L, generator=g).log_softmax(-1)
    ll = torch.randint(T - 40 if ll_lo is None else ll_lo, T + 1, (B,),
                       generator=g)
    tl = torch.randint(tl_lo, S + 1, (B,), generator=g)
    tg = torch.randint(1, L, (B, S), generator=g)
    tg = torch.where(torch.arange(S)[None] < tl[:, None], tg, 0)
    return (lp.to(device), ll.int().to(device), tg.int().to(device),
            tl.int().to(device))


def k2_compare(name, args):
    nll_k = ctc_alpha(*args)
    nll_p = ctc_alpha_reference(*args)
    denom = torch.clamp(args[3], min=1).float()
    loss_k = reduce_ctc(nll_k, args[3], 'none') / denom
    loss_p = reduce_ctc(nll_p, args[3], 'none') / denom
    torch.cuda.synchronize()
    err = (loss_k - loss_p).abs().max().item()
    raw = (nll_k - nll_p).abs().max().item()
    check(err < K2_TOL, f'K2 {name} log_probs {tuple(args[0].shape)} S='
          f'{args[2].shape[1]}: per-sample |d loss| {err:.3e} (gate '
          f'{K2_TOL}), |d nll| {raw:.3e}')
    return err


def k2_alphas_compare(name, args):
    """K2 storing alphas against the plain recursion's alphas, on the
    entries K3 reads (t < logit_length, s < 2*S_b + 1)."""
    lp, ll, tg, tl = args
    nll_k, al_k = ctc_alpha(*args, store_alphas=True)
    nll_p, al_p = ctc_alpha_reference(*args, store_alphas=True)
    nll_eval = ctc_alpha(*args)
    torch.cuda.synchronize()
    B, T, N = al_k.shape
    valid = ((torch.arange(T, device=lp.device)[None, :, None]
              < torch.clamp(ll.long(), 1, T)[:, None, None])
             & (torch.arange(N, device=lp.device)[None, None, :]
                < (2 * tl.long() + 1)[:, None, None]))
    rel = ((al_k - al_p).abs() / al_p.abs().clamp(min=1.0))[valid]
    err = rel.max().item()
    same = bool(torch.equal(nll_k, nll_eval))
    nll_err = (nll_k - nll_p).abs().max().item()
    check(err < K2_ALPHA_RTOL and same and nll_err < K2_TOL,
          f'K2 stored alphas {name} {tuple(al_k.shape)}: max relative err '
          f'{err:.3e} over {int(valid.sum())} entries (gate '
          f'{K2_ALPHA_RTOL}); nll equal to the eval variant: {same}; |d nll| '
          f'vs plain {nll_err:.3e}')


def k2_oracle(name, args):
    oracle = ctc_alpha_reference(args[0].double(), *args[1:])
    rel = ((ctc_alpha(*args).double() - oracle).abs()
           / oracle.abs()).max().item()
    check(rel < K2_ORACLE_RTOL, f'K2 {name} vs float64 oracle: max '
          f'relative nll err {rel:.3e} (gate {K2_ORACLE_RTOL})')


CTC_GRID = ((8, 120, 31, 40), (8, 100, 31, 40), (16, 800, 31, 70))


def ctc_long_inputs(dev):
    B, T, L, S = CTC_LONG
    return k2_inputs(B, T, L, S, 11, dev, tl_lo=S // 2, ll_lo=T - 10)


def phase_ctc_limits():
    """K2 and K3 hold a row's 2S+1 lattice positions in one block's
    registers: a wider lattice raises ValueError before any launch."""
    lp, ll, tg, tl = k2_inputs(2, 8, 29, 2048, 12, DEVICE, tl_lo=1, ll_lo=1)
    B, T, _ = lp.shape
    alphas = torch.zeros(B, T, 2 * tg.shape[1] + 1, device=DEVICE)
    vec = torch.ones(B, device=DEVICE)
    before = (ctc_alpha.launches, ctc_beta.launches)
    raised, msg = [], ''
    for fn in (lambda: ctc_alpha(lp, ll, tg, tl, store_alphas=True),
               lambda: ctc_alpha(lp, ll, tg, tl),
               lambda: ctc_beta(lp, alphas, vec, ll, tg, tl, vec)):
        try:
            fn()
            raised.append(False)
        except ValueError as e:
            raised.append(True)
            msg = str(e)
    check(all(raised) and (ctc_alpha.launches, ctc_beta.launches) == before,
          f'K2/K3 at S=2048 (4097 lattice positions) raise ValueError '
          f'before launching: {raised} ({msg})')


def phase_log1p():
    """The CTC kernels' branch-free log1p (csrc/ctc_lattice.cuh) against
    the CUDA math library's log1pf, which the plain versions call through
    torch.logaddexp, on every float in [0, 1]: the kernels round every
    lattice update as the plain version does only if they agree bit for
    bit."""
    fn = _build.load('ctc_alpha').ctc_log1p_mismatches
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p]
    n = fn(torch.cuda.current_stream().cuda_stream)
    check(n == 0, f'K2/K3 log1p vs log1pf on all 1065353217 floats in [0, 1]: '
          f'{n} differ (0 wanted; negative: a CUDA error)')


def phase_k2(main_s: int):
    dev = DEVICE
    errs = []
    phase_log1p()
    for i, (B, T, L, S) in enumerate(CTC_GRID):
        args = k2_inputs(B, T, L, S, i, dev)
        errs.append(k2_compare(f'grid{i}', args))
        k2_alphas_compare(f'grid{i}', args)
        if T == 800:
            k2_oracle('T=800', args)
    # No possible alignment: 20 labels in 10 frames -> loss zeroed.
    args = k2_inputs(4, 10, 29, 20, 9, dev, tl_lo=20, ll_lo=10)
    loss_k = reduce_ctc(ctc_alpha(*args), args[3], 'none')
    loss_p = reduce_ctc(ctc_alpha_reference(*args), args[3], 'none')
    check(bool((loss_k == 0).all() and (loss_p == 0).all()),
          'K2 impossible alignment: zero_infinity zeroes kernel and plain '
          'losses')
    main = k2_inputs(BATCH, 404, 29, main_s, 7, dev, tl_lo=main_s // 2,
                     ll_lo=395)
    errs.append(k2_compare('main path', main))
    k2_alphas_compare('main path', main)
    long = ctc_long_inputs(dev)
    errs.append(k2_compare('long', long))
    k2_alphas_compare('long', long)
    k2_oracle(f'long (T={CTC_LONG[1]})', long)
    phase_ctc_limits()
    return max(errs), main, long


class PlainCTC(torch.autograd.Function):
    """The plain versions of K2 and K3 behind the same autograd seam as
    ``CTCLoss``."""

    @staticmethod
    def forward(ctx, log_probs, logit_lengths, targets, target_lengths):
        nll, alphas = ctc_alpha_reference(log_probs, logit_lengths, targets,
                                          target_lengths, store_alphas=True)
        ctx.save_for_backward(log_probs, alphas, nll, logit_lengths, targets,
                              target_lengths)
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        lp, alphas, nll, ll, tg, tl = ctx.saved_tensors
        return (ctc_beta_reference(lp, alphas, nll, ll, tg, tl,
                                   grad_nll.contiguous()),
                None, None, None)


def ctc_value_and_grad(fn, args, dtype=torch.float32):
    x = args[0].to(dtype).detach().requires_grad_()
    loss = fn(x, *args[1:])
    loss.backward()
    return loss.detach(), x.grad


def kernel_ctc(x, ll, tg, tl):
    return ctc_loss_kernel(x, ll, tg, tl)


def plain_ctc(x, ll, tg, tl):
    return reduce_ctc(PlainCTC.apply(x, ll, tg, tl), tl, 'mean')


def oracle_ctc(x, ll, tg, tl):
    return ctc_loss(x, ll, tg, tl)  # autograd through the plain recursion


def k3_compare(name, args):
    v_k, g_k = ctc_value_and_grad(kernel_ctc, args)
    v_p, g_p = ctc_value_and_grad(plain_ctc, args)
    torch.cuda.synchronize()
    dv = abs(v_k.item() - v_p.item())
    dg = (g_k - g_p).abs().max().item()
    scale = g_p.abs().max().item()
    check(dv < K3_TOL and dg < K3_TOL and dg < K3_RTOL * scale
          and bool(torch.isfinite(g_k).all()),
          f'K3 {name} log_probs {tuple(args[0].shape)} S={args[2].shape[1]}: '
          f'|d mean loss| {dv:.3e}, max |d grad| {dg:.3e} (gate {K3_TOL}); '
          f'max |grad| {scale:.3e}, ratio {dg / scale:.3e} (gate {K3_RTOL})')
    _, g_o = ctc_value_and_grad(oracle_ctc, args, torch.float64)
    rel = (g_k.double() - g_o).abs().max().item() / g_o.abs().max().item()
    check(rel < K3_ORACLE_RTOL, f'K3 {name} vs float64 oracle (autograd '
          f'through the plain recursion): max |d grad| / max |grad| '
          f'{rel:.3e} (gate {K3_ORACLE_RTOL})')
    return dg


def k3_same_bits(name, args):
    """No atomics in K3: two calls on the same inputs give the same
    bits."""
    lp, ll, tg, tl = args
    nll, alphas = ctc_alpha(*args, store_alphas=True)
    g = (1.0 / (lp.shape[0] * torch.clamp(tl, min=1).float())).contiguous()
    first = ctc_beta(lp, alphas, nll, ll, tg, tl, g)
    again = ctc_beta(lp, alphas, nll, ll, tg, tl, g)
    check(bool(torch.equal(first, again)),
          f'K3 {name} {tuple(lp.shape)} S={tg.shape[1]}: two calls give the '
          'same bits')


def phase_k3(k2_main, k2_long):
    dev = DEVICE
    errs = []
    for i, (B, T, L, S) in enumerate(CTC_GRID):
        args = k2_inputs(B, T, L, S, i, dev)
        errs.append(k3_compare(f'grid{i}', args))
        k3_same_bits(f'grid{i}', args)
    # Row 0 cannot align (at least 10 labels in 2 frames): zero_infinity
    # zeroes its loss, so its gradient must be exactly zero and finite.
    lp, ll, tg, tl = k2_inputs(8, 120, 31, 40, 0, dev)
    ll = ll.clone()
    ll[0] = 2
    args = (lp, ll, tg, tl)
    _, g_k = ctc_value_and_grad(kernel_ctc, args)
    _, g_p = ctc_value_and_grad(plain_ctc, args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(g_k).all() and (g_k[0] == 0).all()
               and (g_k[1:] != 0).any())
          and (g_k - g_p).abs().max().item() < K3_TOL,
          'K3 impossible alignment in row 0: its gradient is exactly zero, '
          'the whole gradient finite, the other rows match the plain version')
    errs.append(k3_compare('main path', k2_main))
    k3_same_bits('main path', k2_main)
    errs.append(k3_compare('long', k2_long))
    k3_same_bits('long', k2_long)
    return max(errs)


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| / max |ref| (scale-free)."""
    return ((a.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def dw_inputs(B, T, C, K, s, d, seed, device):
    """x [B, T, C], w [K, C], cotangent g [B, T_out, C] (seeded numpy) and
    the padding."""
    rng = np.random.default_rng(seed)
    p = get_same_padding(K, s, d)
    t_out = dw_out_length(T, K, s, d, p)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((K, C))).astype(np.float32)
    g = rng.standard_normal((B, t_out, C)).astype(np.float32)
    return ([torch.from_numpy(a).to(device) for a in (x, w, g)], p)


def dw_plain(x, w, g, s, d, p):
    """(y, dx, dw) of the plain K4 in x's dtype, gradients by autograd."""
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    y = depthwise_fwd_reference(x, w, s, d, p)
    dx, dw = torch.autograd.grad(y, (x, w), g.to(y.dtype))
    return y.detach(), dx, dw


def dw_kernel(x, w, g, s, d, p):
    """(y, dx, dw) of the wrappers: K4, K4 on the stuffed cotangent, K5."""
    return (depthwise_fwd(x, w, s, d, p),
            depthwise_dgrad(g, w, x.shape[1], s, d, p),
            depthwise_wgrad(x, g, w.shape[0], s, d, p))


def phase_k4_k5():
    errs = {'K4': [], 'K5': []}
    for i, shape in enumerate(DW_GRID + [DW_MAIN] + DW_EDGE):
        B, T, C, K, s, d = shape
        (x, w, g), p = dw_inputs(*shape, 20 + i, DEVICE)
        got = dw_kernel(x, w, g, s, d, p)
        plain = dw_plain(x, w, g, s, d, p)
        oracle = dw_plain(x.double(), w.double(), g.double(), s, d, p)
        torch.cuda.synchronize()
        r = [rel_err(a, b) for a, b in zip(got, plain)]
        o = [rel_err(a, b) for a, b in zip(got, oracle)]
        ab = [(a - b).abs().max().item() for a, b in zip(got, plain)]
        errs['K4'] += ab[:2]
        errs['K5'].append(ab[2])
        name = ('main path' if shape == DW_MAIN else
                'edge' if shape in DW_EDGE else f'grid{i}')
        check(max(r) < SEP_DW_RTOL and max(o) < DW_ORACLE_RTOL
              and all(bool(torch.isfinite(t).all()) for t in got),
              f'K4/K5 {name} (B,T,C,K,s,d)={shape}: y, dx, dw vs plain '
              f'{r[0]:.2e} {r[1]:.2e} {r[2]:.2e} (gate {SEP_DW_RTOL}); vs '
              f'float64 oracle {o[0]:.2e} {o[1]:.2e} {o[2]:.2e} (gate '
              f'{DW_ORACLE_RTOL})')
    # No float atomics: two calls give the same bits.
    B, T, C, K, s, d = DW_MAIN
    (x, w, g), p = dw_inputs(*DW_MAIN, 98, DEVICE)
    first = depthwise_wgrad(x, g, K, s, d, p)
    check(torch.equal(first, depthwise_wgrad(x, g, K, s, d, p)),
          f'K5 at {DW_MAIN}: two calls give the same bits')
    return max(errs['K4']), max(errs['K5'])


def sep_inputs(B, T, Cin, Cout, K, d, seed, device, masked=True):
    """x, float lens (ragged, with a .5), wdw, wpw, cotangent g, and the
    padding (seeded numpy)."""
    rng = np.random.default_rng(seed)
    p = get_same_padding(K, 1, d)
    t_out = sep_out_length(T, K, d, p)
    x = rng.standard_normal((B, T, Cin)).astype(np.float32)
    wdw = (0.1 * rng.standard_normal((K, Cin))).astype(np.float32)
    wpw = (rng.standard_normal((Cin, Cout)) / np.sqrt(Cin)).astype(
        np.float32)
    g = rng.standard_normal((B, t_out, Cout)).astype(np.float32)
    lens = (rng.integers(T // 2, T + 1, size=B) + 0.5).astype(np.float32)
    lens[0] = T
    t = [torch.from_numpy(a).to(device) for a in (x, wdw, wpw, g)]
    l1, l2 = (mask_lengths(torch.from_numpy(lens).to(device), K, d, p)
              if masked else (None, None))
    return t, l1, l2, p


def sep_plain(x, l1, l2, wdw, wpw, g, d, p):
    """(y, dx, dwdw, dwpw) of the plain K6 in x's dtype, autograd."""
    ins = [t.detach().requires_grad_() for t in (x, wdw, wpw)]
    y = sep_fwd_reference(ins[0], l1, l2, ins[1], ins[2], d, p)
    grads = torch.autograd.grad(y, ins, g.to(y.dtype))
    return (y.detach(), *grads)


def phase_k6_k7():
    errs = {'K6': [], 'K7': []}
    cases = ([(sh, m) for sh in SEP_GRID for m in (True, False)]
             + [(sh, True) for sh in SEP_MAIN]
             + [(sh, True) for sh in SEP_EDGE + SEP_BWD_EDGE]
             + [(SEP_EDGE[0], False), (SEP_BWD_EDGE[3], False)])
    for i, (shape, masked) in enumerate(cases):
        B, T, Cin, Cout, K, d = shape
        (x, wdw, wpw, g), l1, l2, p = sep_inputs(*shape, 40 + i, DEVICE,
                                                 masked)
        got = (sep_fwd(x, l1, l2, wdw, wpw, d, p),
               *sep_bwd(x, l1, l2, wdw, wpw, g, d, p))
        plain = (sep_fwd_reference(x, l1, l2, wdw, wpw, d, p),
                 *sep_bwd_reference(x, l1, l2, wdw, wpw, g, d, p))
        oracle = sep_plain(x.double(), l1, l2, wdw.double(), wpw.double(),
                           g.double(), d, p)
        torch.cuda.synchronize()
        r = [rel_err(a, b) for a, b in zip(got, plain)]
        o = [rel_err(a, b) for a, b in zip(got, oracle)]
        ab = [(a - b).abs().max().item() for a, b in zip(got, plain)]
        errs['K6'].append(ab[0])
        errs['K7'] += ab[1:]
        name = ('main path' if shape in SEP_MAIN else
                'edge' if shape in SEP_EDGE else
                'K7 edge' if shape in SEP_BWD_EDGE else f'grid{i // 2}')
        check(max(r) < SEP_DW_RTOL and max(o) < SEP_ORACLE_RTOL
              and all(bool(torch.isfinite(t).all()) for t in got),
              f'K6/K7 {name} (B,T,Cin,Cout,K,d)={shape} masks '
              f'{"on" if masked else "off"}: y, dx, dwdw, dwpw vs plain '
              + ' '.join(f'{v:.2e}' for v in r) + f' (gate {SEP_DW_RTOL}); '
              'vs float64 oracle ' + ' '.join(f'{v:.2e}' for v in o)
              + f' (gate {SEP_ORACLE_RTOL})')
    # No float atomics: two calls give the same bits.
    shape = SEP_MAIN[2]
    (x, wdw, wpw, g), l1, l2, p = sep_inputs(*shape, 99, DEVICE)
    first = sep_bwd(x, l1, l2, wdw, wpw, g, shape[5], p)
    again = sep_bwd(x, l1, l2, wdw, wpw, g, shape[5], p)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f'K7 at {shape}: two calls give the same bits')
    return max(errs['K6']), max(errs['K7'])


def write_corpus(root: str) -> tuple[str, int]:
    """N_UTTS seeded ~8 s WAVs (tones + noise) with random transcripts;
    returns (manifest path, longest transcript in labels)."""
    rng = np.random.default_rng(0)
    rows, longest = [], 0
    for i in range(N_UTTS):
        n = int(rng.integers(LEN_LO, LEN_HI + 1))
        t = np.arange(n) / 16000
        audio = sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
                    for _ in range(3)) + 0.05 * rng.standard_normal(n)
        path = os.path.join(root, f'utt{i:03d}.wav')
        write_wav(path, audio.astype(np.float32), 16000)
        text = ' '.join(rng.choice(WORDS, size=int(rng.integers(18, 26))))
        longest = max(longest, len(text))
        rows.append({'audio_filepath': path, 'text': text})
    manifest = os.path.join(root, 'manifest.jsonl')
    with open(manifest, 'w') as f:
        f.write('\n'.join(json.dumps(r) for r in rows) + '\n')
    return manifest, longest


def phase_main_path(manifest: str, overrides=(), what='Wav2Letter-20'):
    """evaluate.main over the corpus; returns the kernels' launches."""
    argv = ['--test-manifest', manifest, '--device', str(DEVICE),
            '--seed', '0', '--batch-size', str(BATCH), *overrides]
    out = io.StringIO()
    counters = (stft_mel_log, ctc_alpha, depthwise_fwd, sep_fwd)
    for fn in counters:
        fn.launches = 0
    with contextlib.redirect_stdout(out):
        rc = port_eval.main(argv)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    line = out.getvalue().strip().splitlines()[-1]
    print(f'evaluate.main ({what}): ' + line)
    result = json.loads(line)
    print(f'main-path launches ({what}): {launches}')
    check(rc == 0, 'evaluate.main returned 0')
    check(launches['stft_mel_log'] > 0 and launches['ctc_alpha'] > 0,
          f'K1 and K2 launched on the {what} eval path: {launches}')
    check(result['num_utterances'] == N_UTTS
          and set(result) == {'loss', 'num_utterances', 'cer', 'wer'}
          and all(math.isfinite(result[k]) for k in ('loss', 'cer', 'wer'))
          and result['loss'] > 0,
          f'result has the test.py keys, {N_UTTS} utterances, finite '
          'loss/WER/CER (random weights: WER is not checked)')
    return launches


def phase_cpu_reference(overrides=(), what='Wav2Letter-20'):
    """The eval step on the card vs the same step on the CPU (plain
    kernels, ATen convs) with the same full-width weights, on a small
    input."""
    model, fe, _ = port_eval.build(DEVICE, seed=0, overrides=overrides)
    rng = np.random.default_rng(5)
    T = 16000
    audio = (0.1 * rng.standard_normal((2, T))).astype(np.float32)
    batch = dict(audio=audio, audio_lengths=np.array([T, 12000], np.int32),
                 targets=rng.integers(1, 29, (2, 16)).astype(np.int32),
                 target_lengths=np.array([16, 9], np.int32),
                 batch_mask=np.ones(2, np.float32))
    outs = {}
    for dev in (DEVICE, torch.device('cpu')):
        m = model.to(dev)
        f = fe.to(dev)
        b = port_eval.to_device(batch, dev)
        loss, ids, _ = port_eval.eval_step(m, f, b)
        with torch.no_grad():
            out, _ = m(*f(b['audio'], b['audio_lengths']))
        outs[dev.type] = (float(loss), out.cpu(), ids.cpu())
    (lc, pc, ic), (lr, pr, ir) = outs[DEVICE.type], outs['cpu']
    err = (pc - pr).abs().max().item()
    rel = abs(lc - lr) / abs(lr)
    kind = 'probability' if getattr(model, 'eval_emits_probs', False) \
        else 'log-prob'
    check(math.isfinite(lc) and rel < 1e-3 and err < 1e-2,
          f'eval step, {what} full width, B=2 x 1 s: card vs CPU '
          f'loss {lc:.6f} vs {lr:.6f} (rel {rel:.2e}, gate 1e-3), {kind} '
          f'max err {err:.2e} (gate 1e-2), argmax agreement '
          f'{(ic == ir).float().mean().item():.4f}')


def phase_timing(manifest: str, card: str, overrides=(),
                 what='Wav2Letter-20'):
    model, fe, labels = port_eval.build(DEVICE, seed=0, overrides=overrides)
    print(f'{what}: {sum(p.numel() for p in model.parameters())} parameters')
    loader = port_eval.make_loader(manifest, BATCH, fe)
    batches = [port_eval.to_device(b, DEVICE) for b in loader]
    for b in batches:  # warm-up (cuDNN plans, allocator)
        port_eval.eval_step(model, fe, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        for b in batches:
            loss, ids, lens = port_eval.eval_step(model, fe, b)
    ids.cpu()
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t0) / (reps * len(batches))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'{what} eval step (frontend + model + CTC + argmax), B={BATCH}, '
          f'{tuple(batches[0]["audio"].shape)} audio: {per_batch * 1e3:.3f} '
          f'ms/batch, {BATCH / per_batch:.1f} utt/s, peak memory '
          f'{peak:.3f} GiB [{card}]')
    t0 = time.perf_counter()
    result = port_eval.evaluate(model, fe, loader,
                                port_eval.GreedyDecoder(labels), DEVICE)
    wall = time.perf_counter() - t0
    print(f'{what} evaluate() end to end (WAV read, H2D, eval step, '
          f'decode, WER): '
          f'{wall:.3f} s for {result["num_utterances"]} utterances, '
          f'{result["num_utterances"] / wall:.1f} utt/s [{card}]')

    profile_top(lambda: [port_eval.eval_step(model, fe, b)
                         for b in batches],
                f'{what}, {len(batches)} eval steps')
    return per_batch


def depth_overrides(overrides) -> list:
    """Wav2Letter-20 unless another model group is named."""
    if any(o.startswith('model=') for o in overrides):
        return []
    return [f'model.mid_layers={MID_LAYERS}']


def train_config(*overrides, no_dropout: bool = False) -> dict:
    cfg = load_config(['data.train_manifest=unused',
                       'data.val_manifest=unused',
                       *depth_overrides(overrides), *overrides])
    if no_dropout:
        for layer in cfg['model'].get('layers', []):
            layer['dropout'] = -1.0
        for block in cfg['model'].get('jasper_blocks', []):
            block['dropout'] = 0.0
    return cfg


def make_trainer(cfg, run_dir, device, seed=0, dither=None, optimizer=None):
    """A Trainer over a full-width model drawn from ``seed`` (optionally
    with another optimizer and a constant schedule at its lr)."""
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels), seed=seed).to(device)
    fe = build_frontend(cfg['model'], dither=dither, device=device)
    if optimizer is None:
        opt, sched = build_optimizer(model.parameters(), cfg['model'], 1, 1)
    else:
        opt = optimizer(model.parameters())
        sched = constant_lr(opt.param_groups[0]['lr'])
    return Trainer(cfg, model, fe, opt, sched, port_eval.GreedyDecoder(labels),
                   device=device, run_dir=run_dir)


def read_losses(run_dir: str) -> dict:
    losses = {}
    with open(os.path.join(run_dir, 'metrics.csv')) as f:
        for line in f.read().splitlines()[1:]:
            _, step, metric, value = line.split(',')
            if metric == 'train_loss':
                losses[int(step)] = float(value)
    return losses


TRAIN_COUNTERS = (stft_mel_log, ctc_alpha, ctc_beta, depthwise_fwd,
                  depthwise_wgrad, sep_fwd, sep_bwd)


def phase_train_main(manifest: str, root: str, overrides=(),
                     what='Wav2Letter-20',
                     kernels=('stft_mel_log', 'ctc_alpha', 'ctc_beta')):
    """train.main on cuda: 2 epochs x 2 steps, then --resume for 2 more;
    ``kernels`` must have launched in the first run. Returns the first
    run's launches and the run directory (its newest two checkpoints, at
    steps 4 and 6, are kept for the decoding phase)."""
    run_dir = os.path.join(root, f'train_run_{len(os.listdir(root))}')
    base = [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', f'data.batch_size={BATCH}',
            *depth_overrides(overrides), *overrides,
            'trainer.log_every_n_steps=1', 'trainer.checkpoint.keep_last=2',
            f'trainer.default_root_dir={run_dir}', '--device', str(DEVICE)]
    for fn in TRAIN_COUNTERS:
        fn.launches = 0
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = port_train.main(base + ['trainer.max_epochs=2',
                                     'trainer.max_steps=4'])
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in TRAIN_COUNTERS}
    wall = time.time() - t0
    print(f'train.main ({what}): ' + ' | '.join(
        out.getvalue().strip().splitlines()))
    print(f'{what} training-path launches (4 steps, 2 validations): '
          f'{launches}; {wall:.1f} s wall')
    check(rc == 0, 'train.main returned 0')
    check(all(launches[k] > 0 for k in kernels),
          f'{", ".join(kernels)} launched on the {what} training path')
    ck = Checkpointer(os.path.join(run_dir, 'checkpoints'))
    losses = read_losses(run_dir)
    check(ck.latest_step() == 4 and ck.load_extra() == {'epoch': 2}
          and sorted(losses) == [1, 2, 3, 4]
          and all(math.isfinite(v) for v in losses.values()),
          f'checkpoint at step {ck.latest_step()} with {ck.load_extra()}, '
          f'finite train losses {losses}')
    with open(os.path.join(run_dir, 'metrics.csv')) as f:
        csv_text = f.read()
    check(all(k in csv_text for k in ('val_loss', 'val_wer', 'train_wer',
                                       'learning_rate')),
          'metrics.csv has train and validation metrics')
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_train.main(base + ['trainer.max_epochs=3',
                                     'trainer.max_steps=6', '--resume'])
    torch.cuda.synchronize()
    print(f'train.main --resume ({what}): ' + ' | '.join(
        out.getvalue().strip().splitlines()))
    losses = read_losses(run_dir)
    check(rc == 0 and 'Resumed from step 4' in out.getvalue()
          and Checkpointer(os.path.join(run_dir, 'checkpoints')).latest_step()
          == 6 and sorted(losses) == [1, 2, 3, 4, 5, 6]
          and all(math.isfinite(v) for v in losses.values()),
          f'--resume continued from step 4 to 6: losses {losses}')
    return launches, run_dir


class BranchClamp(torch.autograd.Function):
    """clamp(0, 20) whose backward passes the gradient where ``mask`` says
    (the branches another evaluation took) instead of where ``x`` is."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return torch.clamp(x, 0.0, 20.0)

    @staticmethod
    def backward(ctx, grad):
        (mask,) = ctx.saved_tensors
        return grad * mask, None


def modulated_tones(rng, B: int, T: int) -> np.ndarray:
    """[B, T] float32: three tones under a slow amplitude envelope, plus
    noise. Unlike stationary noise, it keeps deep activations varying in
    time, so BatchNorm's x - mean does not cancel to rounding noise."""
    t = np.arange(T) / 16000
    rows = []
    for _ in range(B):
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t
                                 + rng.uniform(0, 6))
        tones = sum(np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
                    for _ in range(3))
        rows.append(0.1 * env * tones + 0.02 * rng.standard_normal(T))
    return np.stack(rows).astype(np.float32)


def float64_update(cfg, state: dict, batch: dict, branches: dict) -> dict:
    """The state dict after the same train step run on the CPU in float64,
    every clamp taking the branch recorded in ``branches`` (block index ->
    bool mask of its pre-activations)."""
    from wav2letter_pytorch_tpu_torch.models import wav2letter as w2l
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(state)
    model.double().train()
    opt, _ = build_optimizer(model.parameters(), cfg['model'], 1, 1)
    fe = build_frontend(cfg['model'], dither=0.0)
    b = port_eval.to_device(batch, torch.device('cpu'))
    with torch.no_grad():
        feats, flens = fe(b['audio'], b['audio_lengths'])
    masks = iter([branches[i].double() for i in sorted(branches)])
    plain_clamp = w2l.hardtanh_0_20
    w2l.hardtanh_0_20 = lambda x: BranchClamp.apply(x, next(masks))
    try:
        log_probs, out_lens = model(feats.double(), flens)
    finally:
        w2l.hardtanh_0_20 = plain_clamp
    port_eval.masked_ctc_mean(log_probs, out_lens, b['targets'],
                              b['target_lengths'],
                              b['batch_mask'].double()).backward()
    opt.step()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_train_cpu_reference(root: str):
    """One full-width train step on the card vs the CPU: same weights and
    batch, dither/dropout/augment off, the default SGD (lr 1e-5, Nesterov,
    weight decay).

    clamp(0, 20) has no derivative at 0: a pre-activation within ~1e-6 of
    0 can take the other branch in another float32 evaluation, and through
    BatchNorm's coupling of a channel one such unit moves the gradient of
    every block below it by ~1 % (measured on the CPU against float64). A
    float32 card step and a float32 CPU step differ in a handful of such
    units, so their updates differ by ~1 % whatever the port does. The
    update is therefore held against the same step on the CPU in float64
    that takes the card's clamp branches (``float64_update``); the loss and
    the new BatchNorm statistics, which no branch moves, are held against
    the CPU's float32 step, and the branch disagreements are counted. The
    update is also held against the CPU's float32 step, with no input from
    the card, on the parameters no flip reaches: the blocks above the
    deepest flipped block, and that block's channels that did not flip."""
    cfg = train_config(no_dropout=True)
    rng = np.random.default_rng(6)
    T = 16000
    batch = dict(audio=modulated_tones(rng, 2, T),
                 audio_lengths=np.array([T, 12000], np.int32),
                 targets=rng.integers(1, 29, (2, 16)).astype(np.int32),
                 target_lengths=np.array([16, 9], np.int32),
                 batch_mask=np.ones(2, np.float32))
    res = {}
    for dev in (DEVICE, torch.device('cpu')):
        tr = make_trainer(cfg, os.path.join(root, f'step_{dev.type}'), dev,
                          dither=0.0)
        branches = {}

        def record(i):
            def hook(module, inputs, z):  # clamp's backward passes 0 <= z <= 20
                branches[i] = ((z >= 0) & (z <= 20)).cpu()
            return hook
        hooks = [blk.batch_norm.register_forward_hook(record(i))
                 for i, blk in enumerate(tr.model.conv1ds)
                 if blk.batch_norm is not None and blk.use_activation]
        before = {k: v.detach().cpu().clone()
                  for k, v in tr.model.state_dict().items()}
        loss, _, _ = tr.train_step(port_eval.to_device(batch, dev))
        after = {k: v.detach().cpu().clone()
                 for k, v in tr.model.state_dict().items()}
        for h in hooks:
            h.remove()
        res[dev.type] = (float(loss), before, after, branches)
        del tr
    (lc, bc, ac, zc), (lr_, br, ar, zr) = res[DEVICE.type], res['cpu']
    ref = float64_update(cfg, br, batch, zc)
    flips = sum(int((zc[i] != zr[i]).sum()) for i in zr)
    n_units = sum(z.numel() for z in zr.values())
    params = [k for k in ar if k.endswith(('.weight', '.bias'))]
    stats = [k for k in ar if k.endswith(('running_mean', 'running_var'))]

    def rel_norm(keys, x, y):
        num = sum(float(((x(k) - y(k)) ** 2).sum()) for k in keys)
        return math.sqrt(num / sum(float((y(k) ** 2).sum()) for k in keys))
    upd = rel_norm(params, lambda k: (ac[k] - bc[k]).double(),
                   lambda k: ref[k] - br[k].double())
    upd_cpu = rel_norm(params, lambda k: (ac[k] - bc[k]).double(),
                       lambda k: (ar[k] - br[k]).double())
    # Parameters no flip reaches (keys conv1ds.conv1d_{i}.*; a clamp in
    # block i moves the gradient of its own channel and of every block
    # below it): rows by output channel.
    flipped = {i: (zc[i] != zr[i]).any(dim=2).any(dim=0) for i in zr}
    deepest = max((i for i in zr if flipped[i].any()), default=-1)
    clean = {}
    for k in params:
        i = int(k.split('.')[1].rpartition('_')[2])
        if i > deepest:
            clean[k] = slice(None)
        elif i == deepest:
            clean[k] = ~flipped[i]
    upd_clean = rel_norm(clean, lambda k: (ac[k] - bc[k])[clean[k]].double(),
                         lambda k: (ar[k] - br[k])[clean[k]].double())
    n_clean = sum(ar[k][clean[k]].numel() for k in clean)
    bn = rel_norm(stats, lambda k: ac[k].double(), lambda k: ar[k].double())
    same_init = all(torch.equal(bc[k], br[k]) for k in br)
    loss_rel = abs(lc - lr_) / abs(lr_)
    check(same_init and math.isfinite(lc) and loss_rel < STEP_LOSS_RTOL
          and upd < STEP_UPDATE_RTOL and bn < STEP_BN_RTOL
          and flips <= MAX_BRANCH_FLIPS and upd_clean < STEP_UPDATE_RTOL,
          f'train step, Wav2Letter-20 full width, B=2 x 1 s: card vs CPU loss '
          f'{lc:.6f} vs {lr_:.6f} (rel {loss_rel:.2e}, gate {STEP_LOSS_RTOL});'
          f' update of all {len(params)} parameters vs the CPU float64 step '
          f'on the card\'s clamp branches: relative global norm of the '
          f'difference {upd:.2e} (gate {STEP_UPDATE_RTOL}); vs the CPU '
          f'float32 step {upd_cpu:.2e} with {flips} of {n_units} clamp '
          f'branches taken differently (gate {MAX_BRANCH_FLIPS}), and '
          f'{upd_clean:.2e} (gate {STEP_UPDATE_RTOL}) on the {n_clean} '
          f'parameters no flip reaches (deepest flipped block {deepest}); '
          f'new BN stats {bn:.2e} (gate {STEP_BN_RTOL})')


class BranchRelu(torch.autograd.Function):
    """ReLU whose backward passes the gradient where ``mask`` says (the
    branches another evaluation took) instead of where ``x > 0``."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, grad):
        (mask,) = ctx.saved_tensors
        return grad * mask, None


def activations(model) -> dict:
    return {n: m for n, m in model.named_modules()
            if isinstance(m, Activation)}


def jasper_float64_update(cfg, state: dict, batch: dict,
                          branches: dict) -> dict:
    """The state dict after the same train step run on the CPU in float64,
    every ReLU taking the branch recorded in ``branches`` (module name ->
    bool mask of its input > 0)."""
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(state)
    model.double().train()
    opt, _ = build_optimizer(model.parameters(), cfg['model'], 1, 1)
    fe = build_frontend(cfg['model'], dither=0.0)
    b = port_eval.to_device(batch, torch.device('cpu'))
    with torch.no_grad():
        feats, flens = fe(b['audio'], b['audio_lengths'])

    def force(name):
        def hook(module, inputs, out):
            return BranchRelu.apply(inputs[0], branches[name].double())
        return hook
    hooks = [m.register_forward_hook(force(n))
             for n, m in activations(model).items()]
    try:
        log_probs, out_lens = model(feats.double(), flens)
    finally:
        for h in hooks:
            h.remove()
    port_eval.masked_ctc_mean(log_probs, out_lens, b['targets'],
                              b['target_lengths'],
                              b['batch_mask'].double()).backward()
    opt.step()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_jasper_train_cpu_reference(root: str, overrides, what: str):
    """One full-width Jasper-family train step on the card vs the CPU (same
    weights and batch, dither and dropout off, the config's optimizer).
    ReLU has no derivative at 0, so, as with Wav2Letter's clamp, the update
    is held against the CPU step in float64 on the card's ReLU branches,
    the loss and new BatchNorm statistics against the CPU's float32 step,
    and the update also against the CPU float32 step on the parameters no
    branch flip reaches (the blocks above the deepest flipped block, and
    the head)."""
    cfg = train_config(*overrides, no_dropout=True)
    rng = np.random.default_rng(6)
    T = 16000
    batch = dict(audio=modulated_tones(rng, 2, T),
                 audio_lengths=np.array([T, 12000], np.int32),
                 targets=rng.integers(1, 29, (2, 16)).astype(np.int32),
                 target_lengths=np.array([16, 9], np.int32),
                 batch_mask=np.ones(2, np.float32))
    res = {}
    for dev in (DEVICE, torch.device('cpu')):
        tr = make_trainer(cfg, os.path.join(root, f'jstep_{dev.type}'), dev,
                          dither=0.0)
        branches = {}

        def record(name):
            def hook(module, inputs, out):
                branches[name] = (inputs[0] > 0).cpu()
            return hook
        hooks = [m.register_forward_hook(record(n))
                 for n, m in activations(tr.model).items()]
        before = {k: v.detach().cpu().clone()
                  for k, v in tr.model.state_dict().items()}
        loss, _, _ = tr.train_step(port_eval.to_device(batch, dev))
        after = {k: v.detach().cpu().clone()
                 for k, v in tr.model.state_dict().items()}
        for h in hooks:
            h.remove()
        res[dev.type] = (float(loss), before, after, branches)
        del tr
    (lc, bc, ac, zc), (lr_, br, ar, zr) = res[DEVICE.type], res['cpu']
    ref = jasper_float64_update(cfg, br, batch, zc)
    ref_cpu = jasper_float64_update(cfg, br, batch, zr)
    flips = {n: int((zc[n] != zr[n]).sum()) for n in zr}
    n_flips = sum(flips.values())
    n_units = sum(z.numel() for z in zr.values())
    params = [k for k in ar if k.endswith(('.weight', '.bias'))]
    stats = [k for k in ar if k.endswith(('running_mean', 'running_var'))]

    def rel_norm(keys, x, y):
        num = sum(float(((x(k) - y(k)) ** 2).sum()) for k in keys)
        return math.sqrt(num / sum(float((y(k) ** 2).sum()) for k in keys))
    upd = rel_norm(params, lambda k: (ac[k] - bc[k]).double(),
                   lambda k: ref[k] - br[k].double())
    upd_cpu = rel_norm(params, lambda k: (ac[k] - bc[k]).double(),
                       lambda k: (ar[k] - br[k]).double())
    # The float32 floor: the CPU's own float32 step against the float64
    # step on the CPU's branches.
    floor = rel_norm(params, lambda k: (ar[k] - br[k]).double(),
                     lambda k: ref_cpu[k] - br[k].double())
    deepest = max((int(n.split('.')[1]) for n, f in flips.items() if f),
                  default=-1)
    clean = [k for k in params if not k.startswith('jasper_encoder.')
             or int(k.split('.')[1]) > deepest]
    upd_clean = rel_norm(clean, lambda k: (ac[k] - bc[k]).double(),
                         lambda k: (ar[k] - br[k]).double())
    n_clean = sum(ar[k].numel() for k in clean)
    bn = rel_norm(stats, lambda k: ac[k].double(), lambda k: ar[k].double())
    same_init = all(torch.equal(bc[k], br[k]) for k in br)
    loss_rel = abs(lc - lr_) / abs(lr_)
    check(same_init and math.isfinite(lc) and loss_rel < STEP_LOSS_RTOL
          and upd < JASPER_UPDATE_FLOOR_RATIO * floor
          and upd < JASPER_UPDATE_RTOL and bn < STEP_BN_RTOL
          and n_flips <= RELU_FLIP_SHARE * n_units
          and upd_clean < STEP_UPDATE_RTOL,
          f'train step, {what} full width, B=2 x 1 s: card vs CPU loss '
          f'{lc:.6f} vs {lr_:.6f} (rel {loss_rel:.2e}, gate {STEP_LOSS_RTOL});'
          f' update of all {len(params)} parameters vs the CPU float64 step '
          f'on the card\'s ReLU branches: relative global norm of the '
          f'difference {upd:.2e} (gates {JASPER_UPDATE_FLOOR_RATIO} x the '
          f'CPU float32 step\'s own {floor:.2e} against float64 on its '
          f'branches, and {JASPER_UPDATE_RTOL}); vs the CPU '
          f'float32 step {upd_cpu:.2e} with {n_flips} of {n_units} ReLU '
          f'branches taken differently (gate {RELU_FLIP_SHARE} of them), and '
          f'{upd_clean:.2e} (gate {STEP_UPDATE_RTOL}) on the {n_clean} '
          f'parameters no flip reaches (deepest flipped block {deepest}); '
          f'new BN stats {bn:.2e} (gate {STEP_BN_RTOL})')


def phase_overfit(root: str, overrides=(), what='Wav2Letter-20',
                  lr=OVERFIT_LR, steps=OVERFIT_STEPS):
    """Full width, one repeated batch (B=8, ~2 s), dropout off, AdamW."""
    cfg = train_config(*overrides, no_dropout=True)
    rng = np.random.default_rng(8)
    n = 32000
    t = np.arange(n) / 16000
    audio = np.stack([sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
                          for _ in range(3)) + 0.05 * rng.standard_normal(n)
                      for _ in range(8)]).astype(np.float32)
    lens = rng.integers(28000, n + 1, size=8).astype(np.int32)
    tl = rng.integers(15, 25, size=8).astype(np.int32)
    targets = rng.integers(1, 29, (8, 32)).astype(np.int32)
    targets[np.arange(32)[None, :] >= tl[:, None]] = 0
    batch = port_eval.to_device(dict(
        audio=audio, audio_lengths=lens, targets=targets, target_lengths=tl,
        batch_mask=np.ones(8, np.float32)), DEVICE)
    tr = make_trainer(cfg, os.path.join(root, f'overfit_{what}'), DEVICE,
                      optimizer=lambda p: torch.optim.AdamW(
                          p, lr=lr, weight_decay=0.0))
    losses = [float(tr.train_step(batch)[0]) for _ in range(steps)]
    print(f'{what} overfit losses: ' + ' '.join(f'{v:.3f}' for v in losses))
    first_below = next(i for i, v in enumerate(losses + [0.0])
                       if v < OVERFIT_RATIO * losses[0])
    check(losses[-1] < OVERFIT_RATIO * losses[0],
          f'{what} trains: AdamW lr {lr}, loss {losses[0]:.4f} -> '
          f'{losses[-1]:.4f} after {steps - 1} steps (gate < '
          f'{OVERFIT_RATIO} x first; first below it at step {first_below})')


def phase_train_timing(manifest: str, root: str, card: str, overrides=(),
                       what='Wav2Letter-20'):
    """Train step (the config's defaults: dither, dropout, its optimizer) at
    B=32 of ~8 s."""
    cfg = train_config(f'data.train_manifest={manifest}',
                       f'data.val_manifest={manifest}',
                       f'data.batch_size={BATCH}', *overrides)
    labels = build_labels(cfg['model'])
    loader, _ = port_train.get_data_loaders(labels, cfg['data'])
    batches = [port_eval.to_device(b, DEVICE) for b in loader]
    tr = make_trainer(cfg, os.path.join(root, f'timing_{what}'), DEVICE)
    for b in batches:  # warm-up (cuDNN plans, allocator)
        tr.train_step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        for b in batches:
            loss = tr.train_step(b)[0]
    float(loss)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / (reps * len(batches))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    opt = type(tr.optimizer).__name__
    print(f'{what} train step (frontend + model fwd/bwd + CTC K2/K3 + '
          f'{opt}), B={BATCH}, {tuple(batches[0]["audio"].shape)} audio: '
          f'{per_step * 1e3:.3f} ms/step, {BATCH / per_step:.1f} utt/s, peak '
          f'memory {peak:.3f} GiB [{card}]')
    profile_top(lambda: [tr.train_step(b) for b in batches],
                f'{what}, {len(batches)} train steps')
    return per_step


def profile_top(fn, what: str):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e6
    events = kernel_rows(prof)
    busy = sum(e.self_device_time_total for e in events)
    if busy <= 0:
        print('profiler: no device time recorded (not measured)')
        return
    launches = sum(e.count for e in events)
    print(f'profiler, {what}: device busy {busy / 1e3:.3f} ms of '
          f'{window / 1e3:.3f} ms wall ({100 * busy / window:.1f}%), '
          f'{launches} kernel launches')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f'  {100 * e.self_device_time_total / busy:5.1f}%  '
              f'{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} '
              f'{e.key[:90]}')


def k1_fft_ops(n_fft: int, band_bins: int, n_mels: int) -> int:
    """Operations of one frame in K1 as the kernel runs it: the window
    (n_fft multiplies), the n_fft/2-point complex FFT (a radix-2 pass
    without twiddles when log2(n_fft/2) is odd, 4 adds a butterfly; radix-4
    passes of 3 complex twiddle products, 6 each, and 8 complex adds), the
    split step (14 a bin) and the power (3 a bin), the banded mel (2 a
    band bin) and the log (2 a mel)."""
    m = n_fft // 2
    log2_m = m.bit_length() - 1
    fft = (log2_m % 2) * (m // 2) * 4 + (log2_m // 2) * (m // 4) * (18 + 16)
    return n_fft + fft + 17 * (m + 1) + 2 * band_bins + 2 * n_mels


def k1_numbers(fe, padded, nf):
    B, P = padded.shape
    n_fft, nm = fe.n_fft, fe.n_mels
    tables = fe.k1_tables()
    args = (*k1_args(fe, padded, nf), tables)
    ms = cuda_ms(lambda: stft_mel_log(*args))
    print(f'K1 {ms:.4f} ms queued, '
          f'{cuda_ms(lambda: stft_mel_log(*args), queued=False):.4f} ms back '
          'to back')
    plain_ms = cuda_ms(lambda: stft_mel_log_reference(*args[:6]), iters=5)

    def library():
        spec = torch.stft(padded, n_fft, fe.hop, window=fe.window,
                          center=False, return_complex=True)[..., :nf]
        power = spec.real ** 2 + spec.imag ** 2        # [B, bins, frames]
        return torch.log1p(power.transpose(1, 2) @ fe.fb_t + 2.0 ** -24)
    lib_err = (library() - stft_mel_log(*args)).abs().max().item()
    library_ms = cuda_ms(library)
    band_bins = int(tables.bands[:, 1].sum().item())
    # padded audio read once, the tables, the log-mel written once
    nbytes = 4 * (B * P + B * nf * nm + 3 * n_fft + 3 * nm + band_bins)
    ops = B * nf * k1_fft_ops(n_fft, band_bins, nm)
    print(f'K1 at B={B}, P={P}, {nf} frames, n_fft {n_fft}: '
          f'{ops / 1e9:.3f} GFLOP (real FFT, banded mel over {band_bins} '
          f'bins), {nbytes / 1e6:.1f} MB; torch.stft path agrees to '
          f'{lib_err:.2e}')
    return ms, plain_ms, library_ms, nbytes, ops


def lattice_sizes(args):
    """Per row: frames the recursions run (clamped lengths) and lattice
    positions 2*S_b + 1, on the host."""
    lp, ll, tg, tl = args
    lens = torch.clamp(ll.long(), 1, lp.shape[1]).cpu()
    return lens, 2 * tl.long().cpu() + 1


def k2_numbers(args, what='main path', plain=True):
    """Times of the store-alphas variant (the training path's launch); the
    eval variant's time and both variants' ns a dependent step (time over
    the longest row's frames) are printed beside it. ``plain``: time the
    plain version too (else its time is None)."""
    lp, ll, tg, tl = args
    B, T, L = lp.shape
    ms = cuda_ms(lambda: ctc_alpha(*args, store_alphas=True))
    b2b = cuda_ms(lambda: ctc_alpha(*args, store_alphas=True), queued=False)
    print(f'K2 {what}: {ms:.4f} ms queued, {b2b:.4f} ms back to back')
    eval_ms = cuda_ms(lambda: ctc_alpha(*args))
    plain_ms = (cuda_ms(lambda: ctc_alpha_reference(*args,
                                                    store_alphas=True),
                        iters=3, warmup=1) if plain else None)
    lp_tbl = lp.transpose(0, 1)

    def library():
        return torch.nn.functional.ctc_loss(lp_tbl, tg, ll, tl,
                                            reduction='none',
                                            zero_infinity=True)
    with torch.no_grad():
        lib_err = (library() - reduce_ctc(ctc_alpha(*args), tl, 'none')
                   ).abs().max().item()
        library_ms = cuda_ms(library)
    lens, n_lat = lattice_sizes(args)
    # log-prob rows read, targets and lengths, nll and the alphas written
    nbytes = int(4 * (lens.sum().item() * L + B * tg.shape[1] + 3 * B
                      + (lens * n_lat).sum().item()))
    ops = int(K2_OPS_PER_UPDATE * ((lens - 1) * n_lat).sum().item())
    steps = int(lens.max())
    print(f'K2 {what} at B={B}, T={T}, L={L}, S={tg.shape[1]}: '
          f'{ops / 1e6:.1f} Mop, {nbytes / 1e6:.2f} MB, {steps} dependent '
          f'steps; storing alphas {ms:.4f} ms ({ms * 1e6 / steps:.1f} ns a '
          f'step), eval variant {eval_ms:.4f} ms ({eval_ms * 1e6 / steps:.1f}'
          f' ns a step); F.ctc_loss forward {library_ms:.4f} ms, agrees to '
          f'{lib_err:.2e}; bound {ctc_bound_ms(nbytes, ops):.4f} ms')
    return ms, plain_ms, library_ms, nbytes, ops


def k3_numbers(args, what='main path', plain=True):
    """K3 (two device launches: the beta chain, then the per-label sums)
    with the upstream gradient of the mean loss; the library yardstick is
    F.ctc_loss's backward (forward + backward minus forward)."""
    lp, ll, tg, tl = args
    B, T, L = lp.shape
    nll, alphas = ctc_alpha(*args, store_alphas=True)
    g = (1.0 / (B * torch.clamp(tl, min=1).float())).contiguous()
    ms = cuda_ms(lambda: ctc_beta(lp, alphas, nll, ll, tg, tl, g))
    b2b = cuda_ms(lambda: ctc_beta(lp, alphas, nll, ll, tg, tl, g),
                  queued=False)
    print(f'K3 {what}: {ms:.4f} ms queued, {b2b:.4f} ms back to back')
    plain_ms = None
    if plain:
        nll_p, al_p = ctc_alpha_reference(*args, store_alphas=True)
        plain_ms = cuda_ms(lambda: ctc_beta_reference(
            lp, al_p, nll_p, ll, tg, tl, g), iters=3, warmup=1)
    x = lp.transpose(0, 1).detach().requires_grad_()

    def forward():
        return torch.nn.functional.ctc_loss(x, tg, ll, tl, reduction='sum',
                                            zero_infinity=True)

    def forward_backward():
        forward().backward()
    library_ms = max(cuda_ms(forward_backward) - cuda_ms(forward), 0.0)
    lens, n_lat = lattice_sizes(args)
    # alphas and log-prob rows read, the gradient written, small vectors
    nbytes = int(4 * ((lens * (n_lat + L)).sum().item() + B * T * L
                      + B * tg.shape[1] + 5 * B))
    ops = int(K3_OPS_PER_UPDATE * ((lens - 1) * n_lat).sum().item()
              + K3_OPS_PER_GAMMA * (lens * n_lat).sum().item())
    steps = int(lens.max())
    print(f'K3 {what} at B={B}, T={T}, L={L}, S={tg.shape[1]}: '
          f'{ops / 1e6:.1f} Mop, {nbytes / 1e6:.2f} MB, {steps} dependent '
          f'steps; {ms:.4f} ms ({ms * 1e6 / steps:.1f} ns a step); '
          f'F.ctc_loss backward {library_ms:.4f} ms; bound '
          f'{ctc_bound_ms(nbytes, ops):.4f} ms')
    return ms, plain_ms, library_ms, nbytes, ops


def ctc_bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3


def k4_numbers(dtype=torch.float32):
    """K4 at QuartzNet's C1 (B=32, 808 frames, 64 mels, K=33, stride 2),
    x and w in ``dtype``; the library yardstick is cuDNN's depthwise conv
    (groups = C) in the same dtype."""
    B, T, C, K, s, d = DW_MAIN
    (x, w, g), p = dw_inputs(*DW_MAIN, 30, DEVICE)
    x, w = x.to(dtype), w.to(dtype)
    es = x.element_size()
    t_out = g.shape[1]
    ms = cuda_ms(lambda: depthwise_fwd(x, w, s, d, p))
    b2b = cuda_ms(lambda: depthwise_fwd(x, w, s, d, p), queued=False)
    print(f'K4 ({dtype}) {ms:.4f} ms queued, {b2b:.4f} ms back to back')
    plain_ms = cuda_ms(lambda: depthwise_fwd_reference(x, w, s, d, p),
                       iters=5)
    xt, wt = x.transpose(1, 2), w.t().unsqueeze(1).contiguous()

    def library():
        return torch.nn.functional.conv1d(xt, wt, stride=s, padding=p,
                                          dilation=d, groups=C)
    lib_err = (library().transpose(1, 2).float()
               - depthwise_fwd(x, w, s, d, p).float()).abs().max().item()
    library_ms = cuda_ms(library)
    nbytes = es * (B * T * C + K * C + B * t_out * C)
    ops = 2 * B * t_out * C * K
    print(f'K4 ({dtype}) at {DW_MAIN}: {ops / 1e9:.3f} GFLOP, '
          f'{nbytes / 1e6:.2f} MB; cuDNN agrees to {lib_err:.2e}; '
          f'{fwd_plan(t_out, K, s, d, es)}')
    return ms, plain_ms, library_ms, nbytes, ops


def k5_numbers(dtype=torch.float32):
    """K5 at C1's shape, x and g in ``dtype`` (dw float32); the yardstick
    is cuDNN's weight gradient (torch.nn.grad.conv1d_weight, one
    convolution_backward call) in the same dtype."""
    B, T, C, K, s, d = DW_MAIN
    (x, w, g), p = dw_inputs(*DW_MAIN, 31, DEVICE)
    x, g = x.to(dtype), g.to(dtype)
    es = x.element_size()
    t_out = g.shape[1]
    ms = cuda_ms(lambda: depthwise_wgrad(x, g, K, s, d, p))
    b2b = cuda_ms(lambda: depthwise_wgrad(x, g, K, s, d, p), queued=False)
    print(f'K5 ({dtype}) {ms:.4f} ms queued (both launches), {b2b:.4f} ms '
          'back to back')
    plain_ms = cuda_ms(lambda: depthwise_wgrad_reference(x, g, K, s, d, p),
                       iters=5)
    xt, gt = x.transpose(1, 2), g.transpose(1, 2)

    def library():
        return torch.nn.grad.conv1d_weight(xt, (C, 1, K), gt, stride=s,
                                           padding=p, dilation=d, groups=C)
    lib_err = rel_err(library()[:, 0, :].t(),
                      depthwise_wgrad(x, g, K, s, d, p))
    library_ms = cuda_ms(library)
    nbytes = es * (B * T * C + B * t_out * C) + 4 * K * C
    ops = 2 * B * t_out * C * K
    print(f'K5 ({dtype}) at {DW_MAIN}: {ops / 1e9:.3f} GFLOP, '
          f'{nbytes / 1e6:.2f} MB; cuDNN agrees to {lib_err:.2e} (relative); '
          f'{wgrad_plan(B, t_out, K, s, d, es)}')
    return ms, plain_ms, library_ms, nbytes, ops


def sep_library(x, wdw, wpw, d, p):
    """cuDNN: the depthwise conv (groups = Cin), then the 1x1 conv."""
    cin = x.shape[2]
    h = torch.nn.functional.conv1d(x.transpose(1, 2),
                                   wdw.t().unsqueeze(1).contiguous(),
                                   padding=p, dilation=d, groups=cin)
    return torch.nn.functional.conv1d(h, wpw.t().unsqueeze(2).contiguous())


def k6_k7_numbers(dtype=torch.float32):
    """K6 and K7 at each of QuartzNet's unit shapes (B=32, 404 frames,
    ragged lengths; x in ``dtype``), averaged over the 76 launches of a
    forward: per launch ms, plain ms, library ms (cuDNN: the depthwise and
    1x1 convs, in ``dtype``; for K7 their backward, forward + backward
    minus forward), bytes and operations."""
    B, T = BATCH, 404
    tot6 = np.zeros(5)
    tot7 = np.zeros(5)
    for i, ((cin, cout, K, d), count) in enumerate(SEP_PATH_UNITS.items()):
        (x, wdw, wpw, g), l1, l2, p = sep_inputs(B, T, cin, cout, K, d,
                                                 60 + i, DEVICE)
        x = x.to(dtype)
        es = x.element_size()
        t_out = g.shape[1]
        ms6 = cuda_ms(lambda: sep_fwd(x, l1, l2, wdw, wpw, d, p), iters=10)
        plain6 = cuda_ms(lambda: sep_fwd_reference(x, l1, l2, wdw, wpw, d,
                                                   p), iters=3, warmup=1)
        lib6 = cuda_ms(lambda: sep_library(x, wdw.to(dtype), wpw.to(dtype),
                                           d, p), iters=10)
        ms7 = cuda_ms(lambda: sep_bwd(x, l1, l2, wdw, wpw, g, d, p),
                      iters=10)
        plain7 = cuda_ms(lambda: sep_bwd_reference(x, l1, l2, wdw, wpw, g, d,
                                                   p), iters=3, warmup=1)
        ins = [t.detach().to(dtype).requires_grad_() for t in (x, wdw, wpw)]
        gt = g.transpose(1, 2).to(dtype)

        def lib_fwd():
            return sep_library(*ins, d, p)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), ins, gt)
        lib7 = max(cuda_ms(lib_fwd_bwd, iters=10) - cuda_ms(lib_fwd,
                                                            iters=10), 0.0)
        ops6 = 2 * B * t_out * cin * (K + cout)
        bytes6 = es * B * T * cin + 4 * (K * cin + cin * cout
                                         + B * t_out * cout + 2 * B)
        ops7 = sum(k7_part_ops(x, l1, l2, wdw, wpw, g).values())
        bytes7 = es * 2 * B * T * cin + 4 * (B * t_out * cout + 2 * K * cin
                                             + 2 * cin * cout + 2 * B)
        tot6 += count * np.array([ms6, plain6, lib6, bytes6, ops6])
        tot7 += count * np.array([ms7, plain7, lib7, bytes7, ops7])
        print(f'K6/K7 ({dtype}) at (Cin, Cout, K, d)=({cin}, {cout}, {K}, '
              f'{d}) x{count}: K6 {ms6:.4f} ms ({ops6 / ms6 / 1e9:.1f} '
              f'TFLOP/s; plain '
              f'{plain6:.3f}, cuDNN {lib6:.4f}), K7 {ms7:.4f} ms '
              f'({ops7 / ms7 / 1e9:.1f} TFLOP/s; plain {plain7:.3f}, cuDNN '
              f'backward {lib7:.4f})')
    n = sum(SEP_PATH_UNITS.values())
    print(f'K6 ({dtype}) per forward: {tot6[0]:.3f} ms over {n} launches '
          f'({tot6[4] / 1e12:.3f} TFLOP); K7 per backward: {tot7[0]:.3f} ms '
          f'({tot7[4] / 1e12:.3f} TFLOP)')
    if dtype == torch.float32:
        k7_split_per_backward()
    return tuple(tot6 / n), tuple(tot7 / n)


def k7_split_per_backward(split: bool = True) -> float:
    """K7 at each of QuartzNet's unit shapes (B=32, 404 frames, ragged
    lengths, the inputs ``k6_k7_numbers`` times): its whole time
    (``cuda_ms``) and, with ``split``, each of its kernels' device time by
    part (``k7_split``) with TFLOP/s and bound; then the totals per
    backward (76 calls). Returns K7's ms a backward."""
    total, parts_total, ops_total = 0.0, {}, {}
    for i, ((cin, cout, K, d), count) in enumerate(SEP_PATH_UNITS.items()):
        (x, wdw, wpw, g), l1, l2, p = sep_inputs(BATCH, 404, cin, cout, K, d,
                                                 60 + i, DEVICE)
        ms = cuda_ms(lambda: sep_bwd(x, l1, l2, wdw, wpw, g, d, p), iters=10)
        total += count * ms
        if not split:
            continue
        parts = k7_split(x, l1, l2, wdw, wpw, g, d, p)
        ops = k7_part_ops(x, l1, l2, wdw, wpw, g)
        for n, v in parts.items():
            parts_total[n] = parts_total.get(n, 0.0) + count * v
        for n, v in ops.items():
            ops_total[n] = ops_total.get(n, 0) + count * v
        print(f'K7 split at (Cin, Cout, K, d)={(cin, cout, K, d)} x{count}: '
              f'{ms:.4f} ms; ' + k7_split_line(parts, ops), flush=True)
    n = sum(SEP_PATH_UNITS.values())
    if split:
        print(f'K7 split per backward ({n} calls): {total:.3f} ms '
              f'({total / n:.4f} ms a call); '
              + k7_split_line(parts_total, ops_total), flush=True)
    return total


# K7's kernels by a piece of their (demangled) names -> the part of the
# backward each computes (csrc/sep_conv.cu's header).
K7_PARTS = (('gdw_gemm_kernel', '(i) gdw'), ('sep_bwd_dw_kernel', '(ii) dw'),
            ('pw_gemm_kernel', '(iii) dwpw'),
            ('sum_partials_kernel', '(iv,v) sums'))


def k7_part_ops(x, l1, l2, wdw, wpw, g) -> dict:
    """FLOP of each K7 part that the function needs on these inputs, over
    the frames the masks keep: two products of 2·Cin·Cout a frame before
    len2 (gdw is zero after it, and dwres, which dwpw reduces, too), and
    three depthwise passes of 2·Cin·K a frame (dx before len1, dwres and
    dwdw before len2)."""
    B, T, cin = x.shape
    K, cout, t_out = wdw.shape[0], wpw.shape[1], g.shape[1]
    if l1 is None:
        kept1, kept2 = B * T, B * t_out
    else:
        kept1 = int(l1.clamp(0, T).sum())
        kept2 = int(l2.clamp(0, t_out).sum())
    mm = 2 * kept2 * cin * cout
    return {'(i) gdw': mm, '(ii) dw': 2 * cin * K * (kept1 + 2 * kept2),
            '(iii) dwpw': mm}


def k7_split(x, l1, l2, wdw, wpw, g, d, p, iters: int = 10) -> dict:
    """Device ms of one K7 call by part, from torch.profiler's kernel rows
    over ``iters`` calls (after a warm-up): each part's mean launch in the
    trace times its launches a call (the sums two, the rest one), since
    in a process that profiled before, the trace can miss some launches."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        sep_bwd(x, l1, l2, wdw, wpw, g, d, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            sep_bwd(x, l1, l2, wdw, wpw, g, d, p)
        torch.cuda.synchronize()
    total, seen = {}, {}
    for e in kernel_rows(prof):
        part = next((name for key, name in K7_PARTS if key in e.key), e.key)
        total[part] = total.get(part, 0.0) + e.self_device_time_total / 1e3
        seen[part] = seen.get(part, 0) + e.count
    per_call = {n: 2 if n == '(iv,v) sums' else 1 for n in total}
    off = {n: c for n, c in seen.items() if c != iters * per_call[n]}
    if off:
        print(f'k7_split: launches in the trace over {iters} calls: {off}')
    return {n: total[n] / seen[n] * per_call[n] for n in total}


def k7_split_line(parts: dict, ops: dict) -> str:
    """Each part's ms, with its TFLOP/s and its bound at the FP32 peak."""
    return ', '.join(
        f'{n} {ms:.4f} ms' + (f' ({ops[n] / ms / 1e9:.1f} TFLOP/s, bound '
                              f'{ops[n] / FP32_FLOPS * 1e3:.4f} ms)'
                              if n in ops else '')
        for n, ms in sorted(parts.items()))


# ---------------------------------------------------------------- decoding

PEAKY_SHAPE = (8, 202, 29)   # 8 rows, half the frames, of the main path's
#                              eval-step output
PEAKY_K, PEAKY_ALPHA, PEAKY_BETA = 8, 0.5, 1.0
HOTWORDS = ['the', 'would', 'people']
PY_UTTS = 1                  # utterances the float64 Python DP checks
DECODE_CLI_UTTS = 1          # the corpus head evaluate.main beam-decodes
# The device search's ops are profiled over this share of a batch's frames
# (its ops a frame do not depend on the frame count)
PROFILE_FRAME_SHARE = 8
DECODE_LM_ROWS = 8           # rows of the batch the LM searches are timed on
NBEST_RTOL = 1e-5            # n-best log scores, card vs CPU search
HYP_SCORE_RTOL = 1e-5        # a device/host hypothesis difference must be
#                              a tie of the host DP's ranked scores
LOSS_SAME_RTOL = 1e-5        # CLI loss vs the same state restored by hand


def random_probs(rng, T: int, V: int, peaky: bool = True) -> np.ndarray:
    """The JAX package's tests/test_beam_device.py::_random_probs."""
    logits = rng.standard_normal((T, V)) * (3.0 if peaky else 1.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def manifest_texts(manifest: str) -> list:
    with open(manifest) as f:
        return [json.loads(line)['text'] for line in f if line.strip()]


def phase_lm(manifest: str, root: str) -> str:
    """A 3-gram ARPA trained by the port's ngram_train from the corpus
    transcripts."""
    path = os.path.join(root, 'corpus_3gram.arpa')
    t0 = time.time()
    lm = train_arpa(manifest_texts(manifest), path, order=3)
    print(f'LM: 3-gram over {len(manifest_texts(manifest))} transcripts '
          f'({len(lm.probs[0])} unigrams, {len(lm.probs[1])} bigrams, '
          f'{len(lm.probs[2])} trigrams) in {time.time() - t0:.2f} s')
    return path


def phase_decoding_peaky(lm_path: str):
    """Sharpened log-probs at the main shape: the device search on the card
    and on the CPU, the C++ host search and (on PY_UTTS utterances) the
    float64 Python DP give the same strings, LM-free, LM-fused, with
    hotwords and with both; the card's and the CPU's n-best scores agree."""
    B, T, V = PEAKY_SHAPE
    labels = resolve_labels(port_eval.LABELS)
    rng = np.random.default_rng(0)
    probs = np.stack([random_probs(rng, T, V) for _ in range(B)]).astype(
        np.float32)
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[0] = T
    lp = np.log(probs)
    lp_card = torch.from_numpy(lp).to(DEVICE)
    lm = ArpaLM(lm_path)

    def lm_prob(sentence: str) -> float:
        return 10.0 ** lm.score(sentence)
    kw = dict(k=PEAKY_K, beta=PEAKY_BETA)
    for what, use_lm, hot in (('LM-free', False, None),
                              ('LM-fused', True, None),
                              ('hotwords', False, HOTWORDS),
                              ('LM-fused + hotwords', True, HOTWORDS)):
        times = {}
        if use_lm or hot:
            outs = []
            for x in (lp_card, lp):
                t0 = time.perf_counter()
                outs.append(beam_search_device_lm(
                    x, lens, labels, lm_prob if use_lm else None,
                    alpha=PEAKY_ALPHA, hotwords=hot, **kw))
                times['card' if x is lp_card else 'cpu'] = \
                    time.perf_counter() - t0
            card, cpu = outs
        else:
            nbest = []
            for x in (lp_card, lp):
                t0 = time.perf_counter()
                nbest.append(beam_search_device(x, lens, labels,
                                                n_best=PEAKY_K, **kw))
                times['card' if x is lp_card else 'cpu'] = \
                    time.perf_counter() - t0
            strings = [[[''.join(labels[i] for i in h[0]) for h in hyps]
                        for hyps in r] for r in nbest]
            worst = max(abs(ha[j] - hb[j]) / abs(hb[j])
                        for ra, rb in zip(*nbest) for ha, hb in zip(ra, rb)
                        for j in (1, 2))
            check(strings[0] == strings[1] and worst <= NBEST_RTOL,
                  f'peaky {what}: card and CPU n-best lists (k={PEAKY_K}) '
                  f'equal, scores within {worst:.2e} relative (gate '
                  f'{NBEST_RTOL})')
            card, cpu = [[s[0] for s in r] for r in strings]
        t0 = time.perf_counter()
        host = [prefix_beam_search_native(
            probs[b, :lens[b]], labels, lm=lm if use_lm else None,
            alpha=PEAKY_ALPHA, hotwords=hot, **kw) for b in range(B)]
        times['host C++'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = [prefix_beam_search(
            probs[b, :lens[b]], labels, lm=lm_prob if use_lm else None,
            alpha=PEAKY_ALPHA, hotwords=hot, **kw) for b in range(PY_UTTS)]
        times[f'host Python ({PY_UTTS} utts)'] = time.perf_counter() - t0
        bad = [b for b in range(B) if not card[b] == cpu[b] == host[b]]
        check(not bad and py == host[:PY_UTTS],
              f'peaky {what}, B={B} T={T} V={V} k={PEAKY_K}: card, CPU and '
              f'host C++ strings equal on all {B} utterances (differ on '
              f'{bad}), Python DP equal on {PY_UTTS}; '
              f'{sum(" " in h for h in host)} hypotheses hold a space; '
              + ', '.join(f'{k} {v:.2f} s' for k, v in times.items()))


class timed_evaluate:
    """Records the wall time of ``evaluate.evaluate`` while
    ``evaluate.main`` runs inside the ``with`` block."""

    def __enter__(self):
        self.seconds = None
        self._orig = port_eval.evaluate

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = self._orig(*a, **k)
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t0
            return out
        port_eval.evaluate = wrapped
        return self

    def __exit__(self, *exc):
        port_eval.evaluate = self._orig
        return False


def run_cli(argv, counters=()) -> tuple:
    """evaluate.main(argv): (result, stdout lines, stderr, launches,
    evaluate() seconds)."""
    for fn in counters:
        fn.launches = 0
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            timed_evaluate() as tm:
        rc = port_eval.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, 'evaluate.main returned 0')
    lines = out.getvalue().strip().splitlines()
    launches = {fn.__name__: fn.launches for fn in counters}
    return json.loads(lines[-1]), lines[:-1], err.getvalue(), launches, \
        tm.seconds


def run_model_outputs(run_dir: str, manifest: str, average_last: int):
    """The ``average_last`` state of a run restored by hand (not through
    evaluate.main): (model, frontend, labels, {path: model output [T', V]
    on the host}, the greedy loss of ``evaluate()``)."""
    cfg = run_config(run_dir)
    labels = build_labels(cfg['model'])
    state = average_checkpoints(
        Checkpointer(os.path.join(run_dir, 'checkpoints')), average_last)
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(state['model'])
    model.to(DEVICE).eval()
    fe = build_frontend(cfg['model'], dither=0.0, device=DEVICE)
    loader = port_eval.make_loader(manifest, BATCH, fe, labels)
    greedy = port_eval.evaluate(model, fe, loader,
                                port_eval.GreedyDecoder(labels), DEVICE)
    outs = {}
    for batch in loader:
        _, out, lens = port_eval.eval_step(
            model, fe, port_eval.to_device(batch, DEVICE), 'model')
        out, lens = out.cpu().numpy(), lens.cpu().numpy()
        for j, path in enumerate(batch['paths']):
            if batch['batch_mask'][j]:
                outs[path] = out[j, :lens[j]]
    return model, fe, labels, outs, greedy['loss']


def read_dump(path: str) -> dict:
    with open(path) as f:
        return {r['path']: r for r in map(json.loads, f) if r}


def phase_decoding_w2l(manifest: str, run_dir: str, lm_path: str,
                       root: str, card: str) -> dict:
    """evaluate.main --model-path <Wav2Letter-20 run> --average-last 2
    --lm-path <arpa> --word-timings --dump-jsonl over ``manifest`` (the
    corpus's first DECODE_CLI_UTTS utterances), on the device backend and
    on the host backend: equal hypotheses (a difference only where the
    host DP ranks the two within HYP_SCORE_RTOL), K1 and K2 launched, and
    the CLI's loss equal to the same state restored by hand. Returns
    (each backend's (result, evaluate() seconds), that state's (model,
    frontend, labels))."""
    n_utts = len(manifest_texts(manifest))
    common = ['--model-path', run_dir, '--test-manifest', manifest,
              '--device', str(DEVICE), '--batch-size', str(BATCH),
              '--average-last', '2', '--lm-path', lm_path, '--word-timings']
    runs = {}
    for backend in ('device', 'host'):
        dump = os.path.join(root, f'w2l_{backend}.jsonl')
        runs[backend] = run_cli(
            common + ['--beam-backend', backend, '--dump-jsonl', dump],
            counters=(stft_mel_log, ctc_alpha)) + (read_dump(dump),)
        result, lines, err, launches, secs, _ = runs[backend]
        print(f'evaluate.main --beam-backend {backend} (Wav2Letter-20, '
              f'beam + LM): {json.dumps(result)}; {err.strip()}; '
              f'launches {launches}; evaluate() {secs:.2f} s, '
              f'{result["num_utterances"] / secs:.1f} utt/s [{card}]')
        check(launches['stft_mel_log'] > 0 and launches['ctc_alpha'] > 0
              and 'Averaged last 2 checkpoints (through step 6)' in err
              and sum(l.startswith('timings  :') for l in lines) == n_utts
              and result['num_utterances'] == n_utts,
              f'{backend} backend: K1 and K2 launched, the last 2 '
              f'checkpoints averaged through step 6, {n_utts} timing lines')
    dev, host = runs['device'][-1], runs['host'][-1]
    check(sorted(dev) == sorted(host) and len(dev) == n_utts,
          f'both dumps hold the {n_utts} utterances')
    diff = [p for p in host if dev[p]['hyp'] != host[p]['hyp']]
    model, fe, labels, outs, hand_loss = run_model_outputs(run_dir,
                                                           manifest, 2)
    cli_loss = runs['device'][0]['loss']
    rel = abs(cli_loss - hand_loss) / abs(hand_loss)
    check(rel <= LOSS_SAME_RTOL and runs['host'][0]['loss'] == cli_loss,
          f'the --average-last 2 state restored by hand, greedy: loss '
          f'{hand_loss:.6f} vs the CLI\'s {cli_loss:.6f} (rel {rel:.1e}, gate '
          f'{LOSS_SAME_RTOL})')
    lm = ArpaLM(lm_path)
    for p in diff:
        probs = np.exp(outs[p])
        nbest = dict(prefix_beam_search(
            probs, labels, lm=lambda s: 10.0 ** lm.score(s),
            k=DEFAULT_BEAM_K, alpha=DEFAULT_BEAM_ALPHA,
            beta=DEFAULT_BEAM_BETA, prune=DEFAULT_BEAM_PRUNE,
            return_nbest=DEFAULT_BEAM_K))
        a, b = dev[p]['hyp'], host[p]['hyp']
        sa, sb = nbest.get(a), nbest.get(b)
        print(f'  {os.path.basename(p)}: device {a!r} host score {sa}, '
              f'host {b!r} host score {sb}')
        check(sa is not None and sb is not None
              and abs(sa - sb) <= HYP_SCORE_RTOL * max(abs(sa), abs(sb)),
              f'{os.path.basename(p)}: the hypotheses differ only by a tie '
              f'(gate {HYP_SCORE_RTOL} relative)')
    words = sum(len(r['hyp'].split()) for r in host.values())
    print(f'Wav2Letter-20 device vs host backend: {n_utts - len(diff)} of '
          f'{n_utts} hypotheses equal ({words} words in all), {len(diff)} '
          'ties')
    return {b: (runs[b][0], runs[b][4]) for b in runs}, (model, fe, labels)


def phase_decoding_qn(manifest: str, run_dir: str, card: str):
    """The probabilities branch: QuartzNet-15x5's run, host beam, no LM,
    over ``manifest`` (the corpus's first DECODE_CLI_UTTS utterances)."""
    result, _, err, launches, secs = run_cli(
        ['--model-path', run_dir, '--test-manifest', manifest, '--device',
         str(DEVICE), '--batch-size', str(BATCH), '--beam-search-params',
         f'k={DEFAULT_BEAM_K}', '--beam-backend', 'host'],
        counters=(stft_mel_log, ctc_alpha, depthwise_fwd, sep_fwd))
    print(f'evaluate.main --beam-backend host (QuartzNet-15x5, k='
          f'{DEFAULT_BEAM_K}): {json.dumps(result)}; {err.strip()}; '
          f'launches {launches}; evaluate() {secs:.2f} s, '
          f'{result["num_utterances"] / secs:.1f} utt/s [{card}]')
    check(launches['depthwise_fwd'] > 0 and launches['sep_fwd'] > 0
          and 'Loaded checkpoint at step 6' in err
          and result['num_utterances'] == len(manifest_texts(manifest))
          and all(math.isfinite(result[k]) for k in ('loss', 'wer', 'cer')),
          'QuartzNet-15x5 beam evaluation: K4 and K6 launched, finite '
          'loss/WER/CER')


def host_ms(fn, reps: int = 3, warmup: bool = True) -> float:
    """Mean wall ms of ``fn`` over ``reps`` calls, synchronised."""
    if warmup:
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def search_launches(fn, frames: int) -> tuple:
    """(device ops: kernels and copies, the same a frame, device-busy ms)
    of one call, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = kernel_rows(prof)
    n = sum(e.count for e in events)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    return n, n / frames, busy


def phase_decoding_timing(manifest: str, restored_model: tuple,
                          lm_path: str, card: str, cli: dict):
    """Decode time of one Wav2Letter-20 batch (B=32; the searches with an
    LM over its first DECODE_LM_ROWS rows) under each decoder, evaluate()
    end to end under each, and the device search's launches,
    on the run's --average-last 2 state (``restored_model``: (model,
    frontend, labels), ``phase_decoding_w2l``'s)."""
    model, fe, labels = restored_model
    loader = port_eval.make_loader(manifest, BATCH, fe, labels)
    torch.cuda.synchronize()
    batch = port_eval.to_device(next(iter(loader)), DEVICE)
    _, ids, lens = port_eval.eval_step(model, fe, batch)
    _, lp, _ = port_eval.eval_step(model, fe, batch, 'model')
    torch.cuda.synchronize()
    B, T, _ = lp.shape
    greedy = port_eval.GreedyDecoder(labels)
    host_lm = PrefixBeamSearchLMDecoder(lm_path, labels)
    dev_free = DeviceBeamDecoder(labels, device=DEVICE)
    dev_lm = DeviceBeamDecoder(labels, lm_path=lm_path, device=DEVICE)
    sizes = lens.cpu().numpy()
    n = DECODE_LM_ROWS   # the LM searches: the batch's first rows
    rows = (
        ('host greedy (ids to the host, collapse)', 5, B,
         lambda: greedy.decode_ids(ids.cpu().numpy(), sizes)),
        ('host C++ beam + LM (log-probs to the host, exp)', 1, n,
         lambda: host_lm.decode(np.exp(lp[:n].cpu().numpy()), sizes[:n])),
        ('device beam, LM-free', 1, B,
         lambda: dev_free.decode_log_probs(lp, lens)),
        ('device beam + LM, fused', 1, n,
         lambda: dev_lm.decode_log_probs(lp[:n], lens[:n])))
    for what, reps, rows_b, fn in rows:
        ms = host_ms(fn, reps, warmup=what.startswith(('host greedy',
                                                       'device beam, LM')))
        print(f"decode a batch, Wav2Letter-20 B={rows_b} T'={T}, "
              f'k={DEFAULT_BEAM_K}: {what}: {ms:.2f} ms [{card}]')
    t_prof = T // PROFILE_FRAME_SHARE
    lp_prof = lp[:, :t_prof].contiguous()
    lens_prof = torch.clamp(lens, max=t_prof)
    for what, dec in (('LM-free', dev_free), ('+ LM, fused', dev_lm)):
        n, per_frame, busy = search_launches(
            lambda: dec.decode_log_probs(lp_prof, lens_prof), t_prof)
        print(f'device beam {what}, one batch of its first {t_prof} frames: '
              f'{n} device ops, kernels and copies ({per_frame:.1f} a '
              f'frame), device busy {busy:.2f} ms (profiler) [{card}]')
    for what, dec in (('greedy', greedy), ('device beam, LM-free',
                                           dev_free)):
        t0 = time.perf_counter()
        result = port_eval.evaluate(model, fe, loader, dec, DEVICE)
        secs = time.perf_counter() - t0
        print(f'evaluate() end to end, Wav2Letter-20, {what}: {secs:.2f} s '
              f'for {result["num_utterances"]} utterances, '
              f'{result["num_utterances"] / secs:.1f} utt/s [{card}]')
    for backend, (result, secs) in cli.items():
        print(f'evaluate() end to end, Wav2Letter-20, {backend} beam + LM '
              f'(+ word timings): {secs:.2f} s for '
              f'{result["num_utterances"]} utterances, '
              f'{result["num_utterances"] / secs:.1f} utt/s [{card}]')


# ----------------------------------------------------------------- serving

# MeshInference('f32') on the artifact's fold vs the unfolded model's eval
# forward on the card, max |d logp| / max |logp|: the fold (w * g) rounds
# once per weight and cuDNN may pick other algorithms; float32 rounding
# through 20 layers. A greedy string may differ only at frames whose top-2
# margin in the unfolded output is below this share of max |logp| (random
# weights leave near-ties).
SERVE_FOLD_RTOL = 1e-4
# int8_full on the card vs on the CPU on the same features: the int8 sums
# are exact and the elementwise float32 steps are IEEE on both, so only
# log_softmax's exp/log may differ (a few ulp); max |d| / max |logp|.
SERVE_Q8_RTOL = 1e-5
SERVE_Q8_CPU_ROWS = 2        # batch rows of the CPU int8_full comparison
LONG_MINUTES = 2.5           # long-form clip: the corpus concatenated
# Chunked vs one-shot, max |d logp|: f32 convs may sum a window in another
# order than the whole clip (1.43e-6 seen on the card); int8_full with
# static scales is integer sums and elementwise float32 steps, so exact.
LONG_ATOL = {'f32': 1e-5, 'int8_full': 0.0}
SERVE_LM_PARAMS = 'k=8,alpha=0.5,beta=1.0,prune=0.05'
WIDE_LAYER = 17              # k=29, 896 -> 896, dilation 2


def run_counted(main, argv, counters, what: str = '',
                want: dict | None = None) -> tuple:
    """``main(argv)`` with stdout and stderr captured, each of
    ``counters`` set to 0 just before the call and read just after; the
    call must return 0 and, unless ``want`` is None, the counts equal
    ``want``. Returns (stdout lines, stderr text, wall seconds, counts)."""
    for fn in counters:
        fn.launches = 0
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    check(rc == 0 and want in (None, launches),
          f'{what or main.__module__ + ".main"}: returned {rc}; launches '
          f'{launches}' + ('' if want is None else f' (want {want})'))
    return out.getvalue().strip().splitlines(), err.getvalue().strip(), \
        secs, launches


def run_quiet(main, argv, k1=None, what='', want=None) -> tuple:
    """``run_counted`` on K1 alone: (stdout lines, stderr text, wall
    seconds). With ``k1`` (a dict), K1's count goes into ``k1[what]`` and
    must be ``want``."""
    lines, err, secs, launches = run_counted(
        main, argv, (stft_mel_log,), what,
        None if k1 is None else {'stft_mel_log': want})
    if k1 is not None:
        k1[what] = launches['stft_mel_log']
    return lines, err, secs


def phase_serving_exports(manifest: str, run_dir: str, lm_path: str,
                          root: str, card: str, k1: dict) -> dict:
    """export_serving.main on the Wav2Letter-20 run: f32 with CMVN, int8
    with CMVN and static activation scales, f32 with the corpus LM. K1
    runs once an utterance for CMVN and once for the calibration batch."""
    arts = {}
    for name, extra, want in (
            ('f32', ['--cmvn-manifest', manifest], N_UTTS),
            ('int8', ['--int8', '--cmvn-manifest', manifest, '--calibrate'],
             N_UTTS + 1),
            ('lm', ['--lm-path', lm_path, '--lm-beam-params',
                    SERVE_LM_PARAMS], 0)):
        out = os.path.join(root, f'artifact_{name}')
        _, err, secs = run_quiet(port_export.main, [
            '--model-path', run_dir, '--out', out, '--device', str(DEVICE),
            *extra], k1, f'export_serving --{name}', want)
        meta, folded, stats = load_serving(out)
        print(f'export_serving --{name}: {secs:.2f} s; '
              f'{err.replace(chr(10), "; ")} [{card}]')
        check(meta['num_layers'] == MID_LAYERS + 1
              and meta['format'] == ('int8' if name == 'int8' else 'f32')
              and (stats is not None) == (name != 'lm')
              and (meta['act_scales'] is not None) == (name == 'int8')
              and ('lm' in meta) == (name == 'lm'),
              f'{name} artifact: {MID_LAYERS + 1} layers, its format, CMVN, '
              'scales and LM as asked')
        arts[name] = out
    return arts


def serving_outputs(run_dir: str, manifest: str, art: str) -> tuple:
    """Per-utterance log-probs on the card of the run's newest checkpoint:
    the unfolded model's eval forward and MeshInference('f32') on the
    artifact's fold, batch for batch (B=32). (ref, got, labels)."""
    cfg, model, labels, _ = load_run(run_dir)
    model.to(DEVICE).eval()
    fe = build_frontend(cfg['model'], dither=0.0, device=DEVICE)
    meta, folded, _ = load_serving(art)
    mi = MeshInference(meta['layers'], folded,
                       artifact_frontend(meta, device=DEVICE), device=DEVICE)
    ref, got = {}, {}
    for batch in port_eval.make_loader(manifest, BATCH, fe, labels):
        b = port_eval.to_device(batch, DEVICE)
        _, out, lens = port_eval.eval_step(model, fe, b, 'model')
        lp, mlens = mi.logprobs_device(b['audio'], b['audio_lengths'])
        check(torch.equal(lens, mlens), 'MeshInference gives the model\'s '
              'output lengths')
        for j, path in enumerate(batch['paths']):
            if batch['batch_mask'][j]:
                n = int(lens[j])
                ref[path] = out[j, :n].cpu().numpy()
                got[path] = lp[j, :n].cpu().numpy()
    return ref, got, labels


def phase_serving_fold(run_dir: str, manifest: str, art: str) -> tuple:
    """The BN fold on the card: MeshInference('f32') against the unfolded
    model. Returns (utterances whose greedy strings differ, all of them
    near-ties; their greedy strings under each)."""
    ref, got, labels = serving_outputs(run_dir, manifest, art)
    scale = max(float(np.abs(r).max()) for r in ref.values())
    err = max(float(np.abs(got[p] - ref[p]).max()) for p in ref)
    check(err <= SERVE_FOLD_RTOL * scale,
          f'BN-folded artifact (MeshInference f32) vs the unfolded eval '
          f'forward, {len(ref)} utterances: max |d logp| {err:.3e}, '
          f'{err / scale:.2e} of max |logp| {scale:.2f} (gate '
          f'{SERVE_FOLD_RTOL})')
    greedy = port_eval.GreedyDecoder(labels)
    differ = {}
    for p in ref:
        a = greedy.decode(ref[p][None])[0]
        b = greedy.decode(got[p][None])[0]
        if a == b:
            continue
        top2 = np.sort(ref[p], axis=-1)[:, -2:]
        flips = np.nonzero(ref[p].argmax(-1) != got[p].argmax(-1))[0]
        margins = (top2[flips, 1] - top2[flips, 0]).tolist()
        print(f'  {os.path.basename(p)}: unfolded {a!r}, folded {b!r}; '
              f'argmax differs at frames {flips.tolist()}, top-2 margins '
              f'{margins}')
        check(max(margins) <= SERVE_FOLD_RTOL * scale,
              f'{os.path.basename(p)}: the strings differ only at near-ties')
        differ[p] = (a, b)
    print(f'BN fold: {len(ref) - len(differ)} of {len(ref)} greedy strings '
          f'equal, {len(differ)} near-ties')
    return differ


def phase_serving_card_vs_cpu(manifest: str, arts: dict, card: str):
    """int8 on the card vs the CPU: the first layer's int32 accumulators
    (B=32), the int8_full log-probs with dynamic and static scales
    (SERVE_Q8_CPU_ROWS rows); int8 weight-only against f32 on the card."""
    meta, folded_q, _ = load_serving(arts['int8'])
    _, folded_f, _ = load_serving(arts['f32'])
    layers = meta['layers']
    fe = artifact_frontend(meta, device=DEVICE)
    batch = next(iter(port_eval.make_loader(manifest, BATCH, fe,
                                            meta['labels'])))
    b = port_eval.to_device(batch, DEVICE)
    with torch.no_grad():
        feats, flens = fe(b['audio'], b['audio_lengths'])
    q_dev = serving_infer.to_device(folded_q, DEVICE)
    k, s, d = serving_infer._layer_geometry(layers)[0]
    accs = []
    for x, lens, q0 in ((feats, flens, q_dev[0][0]),
                        (feats.cpu(), flens.cpu(),
                         torch.from_numpy(folded_q[0][0]))):
        xq = serving_infer.quantize_act(
            x, serving_infer.dynamic_act_scale(x, lens))
        accs.append(serving_infer.conv_q8(xq, q0, s, d).cpu())
    check(accs[0].dtype == torch.int32 and torch.equal(accs[0], accs[1]),
          f'int8 first layer, B={BATCH}: the int32 accumulators '
          f'{tuple(accs[0].shape)} are equal on the card and the CPU')
    rows = slice(0, SERVE_Q8_CPU_ROWS)
    for what, scales in (('dynamic', None), ('static', meta['act_scales'])):
        outs = []
        for dev, w in ((DEVICE, q_dev), (torch.device('cpu'), folded_q)):
            with torch.no_grad():
                lp, _ = offline_forward_q8(
                    layers, w, feats[rows].to(dev), flens[rows].to(dev),
                    act_scales=scales)
            outs.append(lp.cpu())
        err = (outs[0] - outs[1]).abs().max().item()
        scale = outs[1].abs().max().item()
        same = (outs[0].argmax(-1) == outs[1].argmax(-1)).all().item()
        check(err <= SERVE_Q8_RTOL * scale and same,
              f'int8_full ({what} scales), card vs CPU on the same '
              f'features, {SERVE_Q8_CPU_ROWS} rows: max |d logp| {err:.3e} '
              f'({err / scale:.1e} of max |logp|, gate {SERVE_Q8_RTOL}), '
              'argmax equal')
    outs = {}
    for mode, folded in (('f32', folded_f), ('int8', folded_q)):
        mi = MeshInference(layers, folded, fe, mode=mode, device=DEVICE)
        outs[mode] = [t.cpu().numpy() for t in mi.logprobs_device(
            b['audio'], b['audio_lengths'])]
    (f_lp, lens), (q_lp, _) = outs['f32'], outs['int8']
    valid = np.arange(f_lp.shape[1])[None, :] < lens[:, None]
    greedy = port_eval.GreedyDecoder(meta['labels'])
    equal = sum(a == c for a, c in zip(greedy.decode(f_lp, lens),
                                       greedy.decode(q_lp, lens)))
    check(np.isfinite(q_lp).all(), 'int8 weight-only log-probs are finite')
    print(f'int8 weight-only vs f32, B={BATCH}: max |d logp| '
          f'{np.abs(q_lp - f_lp)[valid].max():.4f}, argmax agreement '
          f'{(q_lp.argmax(-1) == f_lp.argmax(-1))[valid].mean():.4f}, '
          f'{equal} of {BATCH} greedy strings equal [{card}]')


def serving_common(manifest: str) -> list:
    return ['--test-manifest', manifest, '--device', str(DEVICE),
            '--batch-size', str(BATCH)]


def serving_reference(manifest: str, run_dir: str, root: str) -> tuple:
    """evaluate.main --model-path on the run (the unfolded model, outside
    the serving path's counts): (result, dump)."""
    dump = os.path.join(root, 'model_path.jsonl')
    lines, _, _ = run_quiet(port_eval.main, [
        '--model-path', run_dir, *serving_common(manifest), '--dump-jsonl',
        dump])
    return json.loads(lines[-1]), read_dump(dump)


def phase_serving_cli(manifest: str, arts: dict, root: str, card: str,
                      differ: dict, reference: tuple, k1: dict) -> dict:
    """evaluate.main --artifact --offline (B=32) in each mode, held to
    evaluate.main --model-path (``reference``) on the same batches;
    transcribe_long.main over LONG_MINUTES of the corpus, f32 and int8_full
    (static scales), each against the one-shot forward. Each entry point's
    K1 launches go into ``k1``: once a batch; long form once for each of
    its two runs (warm-up, timed) and once for the one-shot check."""
    common = serving_common(manifest)
    want, want_dump = reference
    results = {}
    for name, argv in (
            ('f32', [arts['f32']]),
            ('f32, CMVN', [arts['f32'], '--offline-norm', 'cmvn']),
            ('int8', [arts['int8']]),
            ('int8_full', [arts['int8'], '--int8-full']),
            ('f32 + LM beam', [arts['lm']])):
        dump = os.path.join(root, f'artifact_{len(results)}.jsonl')
        lines, _, secs = run_quiet(port_eval.main, [
            '--artifact', argv[0], '--offline', *common, *argv[1:],
            '--dump-jsonl', dump], k1, f'evaluate --artifact ({name})',
            N_UTTS // BATCH)
        result = json.loads(lines[-1])
        results[name] = (result, read_dump(dump), secs)
        print(f'evaluate.main --artifact --offline ({name}): '
              f'{json.dumps(result)}; {secs:.2f} s end to end (artifact '
              f'load, WAV read, inference, decode), '
              f'{result["num_utterances"] / secs:.1f} utt/s [{card}]')
        check(result['num_utterances'] == N_UTTS and result['offline']
              and result['decode'] == ('beam_lm' if 'LM' in name
                                       else 'greedy')
              and all(math.isfinite(result[k]) for k in ('wer', 'cer')),
              f'{name}: {N_UTTS} utterances, finite WER/CER, the decoder '
              'asked for')
    got, got_dump, _ = results['f32']
    diff = sorted(p for p in want_dump
                  if want_dump[p]['hyp'] != got_dump[p]['hyp'])
    check(set(diff) <= set(differ) and (
        diff or (got['wer'], got['cer']) == (want['wer'], want['cer'])),
          f'f32 artifact vs --model-path: WER {got["wer"]} / {want["wer"]}, '
          f'CER {got["cer"]} / {want["cer"]}; {len(diff)} strings differ, '
          'each a near-tie of the fold check')
    for name, flags, art in (('f32', [], arts['f32']),
                             ('int8_full', ['--int8-full'], arts['int8'])):
        out = os.path.join(root, f'long_{name}.json')
        lines, err, secs = run_quiet(port_long.main, [
            '--artifact', art, '--concat-manifest', manifest, '--minutes',
            str(LONG_MINUTES), '--verify-oneshot', '--device', str(DEVICE),
            '--json-out', out, *flags], k1, f'transcribe_long ({name})', 3)
        result = json.loads(lines[0])
        print(f'transcribe_long ({name}, {result["audio_seconds"]} s of '
              f'audio): {json.dumps(result)}; {secs:.2f} s in all; '
              f'{result["x_realtime"]} s of audio a second [{card}]')
        check(result['oneshot_argmax_equal']
              and result['oneshot_max_abs_diff'] <= LONG_ATOL[name]
              and result['audio_seconds'] >= LONG_MINUTES * 60
              and result['mode'] == name,
              f'long form {name}: chunked vs one-shot max |d logp| '
              f'{result["oneshot_max_abs_diff"]:.3e} (gate '
              f'{LONG_ATOL[name]}), '
              'argmax equal at every frame, so the greedy strings are')
    return results


def im2col_ms(layers, B: int, T: int, cins) -> float:
    """ms of int8_full's per-layer padding and im2col alone (the int8
    inputs drawn at random; the values do not change the copies)."""
    xs = []
    t = T
    for (k, s, d), cin in zip(serving_infer._layer_geometry(layers), cins):
        xs.append((torch.randint(-127, 128, (B, t, cin), dtype=torch.int8,
                                 device=DEVICE), k, s, d))
        t = -(-t // s)

    def run():
        for x, k, s, d in xs:
            cols = serving_infer.im2col(x, k, s, d)
            cols.reshape(-1, cols.shape[2]).contiguous()
    return cuda_ms(run, iters=5, warmup=1)


def phase_serving_timing(manifest: str, arts: dict, card: str):
    """ms a batch (B=32) and at B=1 in each mode, utt/s, peak memory; the
    int8_full stack against the f32 cuDNN stack with its im2col share; the
    widest layer's int8 product against its cuDNN FP32 conv; weight bytes;
    K1's time in the pipeline."""
    meta, folded_q, _ = load_serving(arts['int8'])
    _, folded_f, _ = load_serving(arts['f32'])
    layers = meta['layers']
    fe = artifact_frontend(meta, device=DEVICE)
    batch = next(iter(port_eval.make_loader(manifest, BATCH, fe,
                                            meta['labels'])))
    audio = torch.from_numpy(batch['audio']).to(DEVICE)
    lens = torch.from_numpy(batch['audio_lengths']).to(DEVICE)
    one = (audio[:1, :int(lens[0])].contiguous(), lens[:1])
    pipe_ms = {}
    for mode, folded, scales in (('f32', folded_f, None),
                                 ('int8', folded_q, None),
                                 ('int8_full', folded_q,
                                  meta['act_scales'])):
        mi = MeshInference(layers, folded, fe, mode=mode,
                           act_scales=scales, device=DEVICE)
        mi.logprobs_device(audio, lens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: mi.logprobs_device(audio, lens), iters=5,
                     warmup=1, queued=False)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms1 = cuda_ms(lambda: mi.logprobs_device(*one), iters=10, warmup=2,
                      queued=False)
        pipe_ms[mode] = ms
        print(f'serving {mode} (frontend K1 + folded stack), B={BATCH} x '
              f'{audio.shape[1] / 16000:.2f} s: {ms:.3f} ms/batch, '
              f'{BATCH / ms * 1e3:.1f} utt/s, peak memory {peak:.3f} GiB; '
              f'B=1 ({int(lens[0]) / 16000:.2f} s): {ms1:.3f} ms [{card}]')
    with torch.no_grad():
        feats, flens = fe(audio, lens)
    w_f = serving_infer.to_device(folded_f, DEVICE)
    w_q = serving_infer.to_device(folded_q, DEVICE)
    f32_ms = cuda_ms(lambda: offline_forward(layers, w_f, feats, flens),
                     iters=5, warmup=1)
    q8_ms = cuda_ms(lambda: offline_forward_q8(
        layers, w_q, feats, flens, act_scales=meta['act_scales']),
        iters=5, warmup=1)
    cins = [int(np.asarray(w).shape[1]) for w, *_ in folded_q[:-1]]
    col_ms = im2col_ms(layers, BATCH, feats.shape[1], cins)
    fe_ms = cuda_ms(lambda: fe(audio, lens), iters=10, warmup=2)
    macs = sum(int(np.asarray(w).size) * t for (w, *_), t in zip(
        folded_q, serving_t_out(layers, feats.shape[1])))  # an utterance
    print(f'conv stack alone, B={BATCH}, T={feats.shape[1]}: f32 cuDNN '
          f'{f32_ms:.3f} ms ({2 * BATCH * macs / f32_ms / 1e9:.1f} TFLOP/s), '
          f'int8_full {q8_ms:.3f} ms ({2 * BATCH * macs / q8_ms / 1e9:.1f} '
          f'TOP/s), of which padding + im2col {col_ms:.3f} ms '
          f'({col_ms / q8_ms:.1%}); {2 * BATCH * macs / 1e12:.3f} TOP a '
          f'batch [{card}]')
    print(f'K1 (frontend) in the serving pipeline, B={BATCH}: {fe_ms:.3f} ms'
          f', {fe_ms / pipe_ms["f32"]:.1%} of f32, '
          f'{fe_ms / pipe_ms["int8_full"]:.1%} of int8_full [{card}]')
    k, s, d = serving_infer._layer_geometry(layers)[WIDE_LAYER]
    q = w_q[WIDE_LAYER][0]
    cin, cout = q.shape[1], q.shape[2]
    t = serving_t_out(layers, feats.shape[1])[WIDE_LAYER]
    a = torch.randint(-127, 128, (BATCH * t, k * cin), dtype=torch.int8,
                      device=DEVICE)
    wmat = q.reshape(k * cin, cout)
    mm_ms = cuda_ms(lambda: serving_infer.int_mm(a, wmat), iters=10)
    x = torch.randn(BATCH, cin, t + (k - 1) * d, device=DEVICE)
    wf = w_f[WIDE_LAYER][0].permute(2, 1, 0)
    conv_ms = cuda_ms(lambda: F.conv1d(x, wf, dilation=d), iters=10)
    ops = 2 * BATCH * t * k * cin * cout
    print(f'widest layer (k={k}, {cin} -> {cout}, d={d}), B={BATCH} x T={t}:'
          f' torch._int_mm {mm_ms:.3f} ms, {ops / mm_ms / 1e9:.1f} TOP/s; '
          f'cuDNN FP32 conv {conv_ms:.3f} ms, {ops / conv_ms / 1e9:.1f} '
          f'TFLOP/s [{card}]')
    f32_bytes = sum(w.nbytes + b.nbytes for w, b in folded_f)
    print(f'weights: int8 {quantized_bytes(folded_q)} bytes (quantized_bytes)'
          f' vs f32 {f32_bytes} bytes, '
          f'{quantized_bytes(folded_q) / f32_bytes:.3f}x [{card}]')


def phase_serving_k1(manifest: str, run_dir: str, arts: dict):
    """K1 against its plain version at the serving path's own shapes: the
    long-form clip (one row of LONG_MINUTES) and one CMVN row (B=1, the
    unnormalised frontend, zero-padded to the 0.5 s grid)."""
    meta, _, _ = load_serving(arts['f32'])
    fe = artifact_frontend(meta, device=DEVICE)
    audio, _ = port_long.read_input(port_long.parse_args(
        ['--artifact', arts['f32'], '--concat-manifest', manifest,
         '--minutes', str(LONG_MINUTES)]), meta, fe.conf.sample_rate)
    raw_fe = build_frontend(run_config(run_dir)['model'], dither=0.0,
                            device=DEVICE, normalize=False)
    clip = np.asarray(ManifestDataset(manifest, fe.conf.sample_rate,
                                      meta['labels'])[0][0], np.float32)
    grid = fe.conf.sample_rate // 2
    row = np.zeros(-(-len(clip) // grid) * grid, np.float32)
    row[:len(clip)] = clip
    for name, f, x, n in (('serving long form', fe, audio, len(audio)),
                          ('serving CMVN row', raw_fe, row, len(clip))):
        a = torch.from_numpy(x[None]).to(DEVICE)
        lens = torch.tensor([n], dtype=torch.int32, device=DEVICE)
        k1_compare(name, f, f.prepare(a, lens), lens, 1 + len(x) // f.hop)


def phase_serving(manifest: str, run_dir: str, lm_path: str, root: str,
                  card: str) -> tuple:
    """The serving slice on the Wav2Letter-20 run; returns K1's launches
    on its path by entry point, each counted from 0 just before the entry
    point ran and read just after, and the artifacts."""
    reference = serving_reference(manifest, run_dir, root)
    k1 = {}
    arts = phase_serving_exports(manifest, run_dir, lm_path, root, card, k1)
    differ = phase_serving_fold(run_dir, manifest, arts['f32'])
    phase_serving_cli(manifest, arts, root, card, differ, reference, k1)
    print(f'serving path: K1 launched {sum(k1.values())} times: '
          f'{json.dumps(k1)}')
    phase_serving_k1(manifest, run_dir, arts)
    phase_serving_card_vs_cpu(manifest, arts, card)
    phase_serving_timing(manifest, arts, card)
    return k1, arts


# ---------------------------------------------------------------- streaming

STREAM_CHUNK = 64            # frames a step: 640 ms at the 10 ms hop
# Streamed log-probs vs MeshInference('f32') on the same fold and CMVN,
# padded past the lookahead: the same float32 math, windows of other
# lengths (cuDNN may pick other algorithms); max |d| / max |logp|.
STREAM_RTOL = 1e-4
NEAR_TIE = 1e-4              # top-2 gap below which a greedy flip is a tie
# Card vs CPU streams: int8 weights run float32 math (rounding only);
# int8_full's int32 sums are exact and its scales divide as on the CPU.
STREAM_INT8_RTOL = 1e-4
STREAM_Q8_RTOL = 1e-5
# The bounded-lookahead streamer with the full one-sided context vs the
# offline forward, interior rows (max |d logp|).
LOOKAHEAD_ATOL = 1e-4
LOOKAHEAD_UTTS = 3           # utterances concatenated for that check
# QuartzNet-15x5 bounded lookahead: a small window (128 + 64 + 96 frames)
# on one utterance; card vs CPU probabilities, float32 both (max |d|).
QN_LA_LEFT, QN_LA = 128, 96
QN_LA_UTTS = 1
QN_LA_ATOL = 1e-3
# evaluate.main's --model-path streaming modes run on the corpus's first
# STREAM_CLI_UTTS utterances (--artifact on all, against --offline).
STREAM_CLI_UTTS = 1
STREAM_ARTIFACT_UTTS = 4    # the corpus head evaluate --artifact streams
TICK_SLOTS = (16, 64)
TICK_ITERS = 5
TCP_SLOTS = 16
TCP_PIECE_S = 0.1            # each client sends 100 ms pieces, unpaced


def stream_steps(sw, n: int) -> int:
    """K1 launches of one utterance of ``n`` samples through
    ``stream_logprobs``: a prime, a step a full chunk after it, a finish."""
    return 2 + (n - sw.prime_samples) // sw.chunk_samples


def lookahead_k1(chunk_samples: int, n: int) -> int:
    """K1 launches of one utterance through a bounded-lookahead session:
    one a full frontend chunk, one for the finish (or the prime of a
    stream shorter than a chunk)."""
    return n // chunk_samples + 1


def corpus_audio(manifest: str, labels) -> list:
    ds = ManifestDataset(manifest, 16000, labels)
    return [(ds[i][2], np.asarray(ds[i][0], np.float32))
            for i in range(len(ds))]


def phase_streaming_k1(arts: dict):
    """K1 against its plain version at the streaming buffers: prime, step
    and finish at B=1 and B=16, chunk 64 (phase 3's gates)."""
    sw, _, _ = streaming_from_artifact(arts['f32'],
                                       chunk_frames=STREAM_CHUNK,
                                       device=DEVICE)
    seen = []
    orig = sw._frames_to_mel

    def record(buf, n):
        seen.append((buf.contiguous(), n))
        return orig(buf, n)
    sw._frames_to_mel = record
    rng = np.random.default_rng(17)
    for B in (1, 16):
        audio = torch.from_numpy((0.1 * rng.standard_normal(
            (B, sw.prime_samples + sw.chunk_samples))).astype(np.float32)
        ).to(DEVICE)
        w = sw._weights_dev
        state, _ = sw._prime_fn(w, audio[:, :sw.prime_samples])
        state, _ = sw._step_fn(w, state, audio[:, sw.prime_samples:])
        tail_len = torch.from_numpy(rng.integers(
            0, sw.chunk_samples + 1, B)).to(DEVICE)
        sw._finish_fn(w, state, audio[:, :sw.chunk_samples], tail_len)
    sw._frames_to_mel = orig
    errs = []
    for (buf, n), what in zip(seen, ['prime', 'step', 'finish'] * 2):
        lens = torch.full((buf.shape[0],), (n - 1) * sw.hop,
                          dtype=torch.int32, device=DEVICE)
        errs.append(k1_compare(f'streaming {what} B={buf.shape[0]}',
                               sw.frontend, buf, lens, n))
    return max(errs)


def stream_all(sw, utts) -> dict:
    with torch.no_grad():
        return {p: stream_logprobs(sw, a[None])[0] for p, a in utts}


def stream_vs_offline(art: str, sw, utts, got: dict, what: str) -> dict:
    """Streamed log-probs ``got`` against MeshInference('f32') on the
    artifact under its CMVN, on the audio zero-padded past the lookahead
    (an even frame count): the valid frames within STREAM_RTOL of max
    |logp|. Returns the offline log-probs by path."""
    meta, folded, stats = load_serving(art)
    mi = MeshInference(meta['layers'], folded,
                       artifact_frontend(meta, stats, device=DEVICE),
                       device=DEVICE)
    hop = sw.hop
    pad = max(len(a) for _, a in utts) + (sw.lookahead_frames + 8) * hop
    pad += -pad % hop
    if (1 + pad // hop) % 2:
        pad += hop
    ref = {}
    for i in range(0, len(utts), BATCH):
        rows = utts[i:i + BATCH]
        audio = np.zeros((len(rows), pad), np.float32)
        for j, (_, a) in enumerate(rows):
            audio[j, :len(a)] = a
        lp, lens = mi.logprobs(audio, [len(a) for _, a in rows])
        for j, (p, _) in enumerate(rows):
            ref[p] = lp[j, :int(lens[j])]
    scale = max(float(np.abs(r).max()) for r in ref.values())
    err = 0.0
    for p, r in ref.items():
        check(got[p].shape == r.shape, f'{os.path.basename(p)}: streamed '
              f'{got[p].shape[0]} frames, offline {r.shape[0]}')
        err = max(err, float(np.abs(got[p] - r).max()))
    check(err <= STREAM_RTOL * scale,
          f'streaming {what} (B=1, chunk {STREAM_CHUNK}) vs MeshInference '
          f'f32, {len(utts)} utterances, same CMVN: max |d logp| '
          f'{err:.3e}, {err / scale:.2e} of max |logp| {scale:.2f} (gate '
          f'{STREAM_RTOL})')
    return ref


def phase_streaming_exact(manifest: str, arts: dict, card: str,
                          k1: dict) -> dict:
    """Every utterance streamed (B=1) through ``streaming_from_artifact``
    on the f32 + CMVN artifact against MeshInference('f32') under the
    same CMVN on the audio zero-padded past the lookahead (an even frame
    count): the valid frames within STREAM_RTOL of max |logp|, greedy
    strings equal but at near-ties. Returns the streamed strings."""
    labels = load_serving(arts['f32'])[0]['labels']
    utts = corpus_audio(manifest, labels)
    stft_mel_log.launches = 0
    t0 = time.perf_counter()
    sw, _, _ = streaming_from_artifact(arts['f32'],
                                       chunk_frames=STREAM_CHUNK,
                                       device=DEVICE)
    got = stream_all(sw, utts)
    secs = time.perf_counter() - t0
    k1['streaming_from_artifact + stream_logprobs'] = stft_mel_log.launches
    want_k1 = sum(stream_steps(sw, len(a)) for _, a in utts)
    check(stft_mel_log.launches == want_k1,
          f'K1 launched {stft_mel_log.launches} times over {len(utts)} '
          f'streams: one a prime, step and finish ({want_k1})')
    ref = stream_vs_offline(arts['f32'], sw, utts, got, 'f32')
    greedy = port_eval.GreedyDecoder(labels)
    strings, ties = {}, 0
    for p, r in ref.items():
        a = greedy.decode(r[None])[0]
        strings[p] = b = greedy.decode(got[p][None])[0]
        if a != b:
            top2 = np.sort(r, axis=-1)[:, -2:]
            flips = np.nonzero(r.argmax(-1) != got[p].argmax(-1))[0]
            gaps = (top2[flips, 1] - top2[flips, 0]).tolist()
            check(max(gaps) < NEAR_TIE, f'{os.path.basename(p)}: the '
                  f'strings differ only at near-ties (gaps {gaps})')
            ties += 1
    audio_s = sum(len(a) for _, a in utts) / 16000
    print(f'streaming exactness: {len(utts) - ties} of {len(utts)} greedy '
          f'strings equal offline, {ties} near-ties; {len(utts)} streams '
          f'({audio_s:.1f} s of audio, B=1) in {secs:.2f} s, '
          f'{audio_s / secs:.1f} s of audio a second [{card}]')
    return strings


def stack_card_vs_cpu(sw_card, sw_cpu, audio) -> tuple:
    """One stream on the card with the features each phase hands its conv
    stack recorded, then the CPU streamer's conv stack over the same
    features in the same order (prime, steps, finish): (card rows, CPU
    rows) of every phase's output, flush rows included."""
    seen = []
    orig = sw_card._conv_layers

    def record(folded, feats, carries, primed):
        out = orig(folded, feats, carries, primed)
        seen.append((feats.cpu(), primed, out[0].cpu()))
        return out
    sw_card._conv_layers = record
    stream_all(sw_card, [('a', audio)])
    sw_card._conv_layers = orig
    carries, rows = None, []
    with torch.no_grad():
        for feats, primed, _ in seen:
            logp, carries = sw_cpu._conv_layers(
                sw_cpu._weights_dev, feats, None if primed else carries,
                primed)
            rows.append(logp)
    return (torch.cat([o for *_, o in seen], 1)[0].numpy(),
            torch.cat(rows, 1)[0].numpy())


def phase_streaming_card_vs_cpu(manifest: str, arts: dict):
    """One utterance cut to a prime, a step and a tail on the card and on
    the CPU: int8 weights streamed end to end on each; int8_full (dynamic
    and static scales) with both conv stacks on the card's features, as
    phase 16 holds int8_full: K1 and the plain DFT differ in the last
    bits, which flips an int8 rounding at a step's edge now and then
    (end to end with dynamic scales on an H100: 4.4e-05 of max |logp|,
    argmax agreement 0.9884)."""
    meta, folded_q, stats = load_serving(arts['int8'])
    _, audio = corpus_audio(manifest, meta['labels'])[0]
    for what, weights, scales in (('int8 weights', 'int8', None),
                                  ('int8_full dynamic', 'int8_full', None),
                                  ('int8_full static', 'int8_full',
                                   meta['act_scales'])):
        sws = [StreamingWav2Letter(
            meta['layers'], meta['num_labels'], None,
            artifact_frontend(meta, device=dev), folded=folded_q,
            weights=weights, act_scales=scales, chunk_frames=STREAM_CHUNK,
            norm='precomputed', norm_stats=stats, device=dev)
            for dev in (DEVICE, torch.device('cpu'))]
        a = audio[:sws[0].prime_samples + sws[0].chunk_samples + 5000]
        if weights == 'int8':
            card, cpu = (stream_all(sw, [('a', a)])['a'] for sw in sws)
            how, gate = 'streamed end to end', STREAM_INT8_RTOL
        else:
            card, cpu = stack_card_vs_cpu(*sws, a)
            how, gate = 'conv stacks on the card\'s features', STREAM_Q8_RTOL
        err = float(np.abs(card - cpu).max())
        scale = float(np.abs(cpu).max())
        same = bool((card.argmax(-1) == cpu.argmax(-1)).all())
        check(err <= gate * scale and (weights == 'int8' or same),
              f'streaming {what}, card vs CPU ({how}), {card.shape[0]} '
              f'frames: max |d logp| {err:.3e} ({err / scale:.1e} of max '
              f'|logp|, gate {gate}), argmax equal: {same}')


def phase_streaming_cli(manifest: str, arts: dict, run_dir: str, root: str,
                        card: str, strings: dict, k1: dict):
    """evaluate.main's streaming modes on the card, K1 counted and gated
    around each: --artifact over the corpus's first STREAM_ARTIFACT_UTTS
    utterances (its strings those of the exact check, its records those
    of --artifact --offline --offline-norm cmvn where the strings are
    equal); over its first STREAM_CLI_UTTS
    utterances --model-path --streaming with cumulative and CMVN
    normalisation (the CMVN over the whole corpus) and with --int8,
    --lookahead-frames 96 and the full one-sided context."""
    labels = load_serving(arts['f32'])[0]['labels']
    with open(manifest) as f:
        rows = f.read().splitlines()
    subset = os.path.join(root, 'stream_subset.jsonl')
    with open(subset, 'w') as f:
        f.write('\n'.join(rows[:STREAM_CLI_UTTS]) + '\n')
    lens = [len(a) for _, a in corpus_audio(manifest, labels)]
    sub = lens[:STREAM_CLI_UTTS]
    head = head_manifest(manifest, root, STREAM_ARTIFACT_UTTS)
    sw, _, _ = streaming_from_artifact(arts['f32'],
                                       chunk_frames=STREAM_CHUNK,
                                       device=DEVICE)
    n_stream = sum(stream_steps(sw, n) for n in sub)
    n_la = sum(lookahead_k1(sw.chunk_samples, n) for n in sub)
    run = ['--model-path', run_dir, '--test-manifest', subset, '--streaming']
    dumps, results = {}, {}
    for name, argv, want, n_utts in (
            ('--artifact', ['--artifact', arts['f32'], '--test-manifest',
                            head],
             sum(stream_steps(sw, n) for n in lens[:STREAM_ARTIFACT_UTTS]),
             STREAM_ARTIFACT_UTTS),
            ('--streaming', run, n_stream, STREAM_CLI_UTTS),
            ('--streaming --streaming-norm cmvn',
             [*run, '--streaming-norm', 'cmvn', '--streaming-cmvn-manifest',
              manifest], n_stream + N_UTTS, STREAM_CLI_UTTS),
            ('--streaming --int8', [*run, '--int8'], n_stream,
             STREAM_CLI_UTTS),
            ('--streaming --lookahead-frames 96',
             [*run, '--lookahead-frames', '96'], n_la, STREAM_CLI_UTTS),
            ('--streaming --lookahead-frames full',
             [*run, '--lookahead-frames', str(sw.lookahead_frames)], n_la,
             STREAM_CLI_UTTS)):
        dump = os.path.join(root, f'stream_{len(dumps)}.jsonl')
        lines, err, secs, launches = run_counted(
            port_eval.main, [*argv, '--device', str(DEVICE), '--dump-jsonl',
                             dump],
            (stft_mel_log,), f'evaluate {name}', {'stft_mel_log': want})
        k1[f'evaluate {name}'] = launches['stft_mel_log']
        results[name] = result = json.loads(lines[-1])
        dumps[name] = read_dump(dump)
        print(f'evaluate.main {name}: {json.dumps(result)}; '
              f'{err.strip().splitlines()[-1] if err.strip() else ""}; '
              f'{secs:.2f} s end to end [{card}]')
        check(result['num_utterances'] == n_utts and result['streaming']
              and all(math.isfinite(result[k]) for k in ('wer', 'cer')),
              f'{name}: {n_utts} utterances streamed, finite WER/CER')
    art = dumps['--artifact']
    check(all(art[p]['hyp'] == strings[p] for p in art),
          '--artifact streaming gives the strings of the exactness check')
    dump = os.path.join(root, 'offline_cmvn.jsonl')
    lines, _, _ = run_quiet(port_eval.main, [
        '--artifact', arts['f32'], '--offline', '--offline-norm', 'cmvn',
        *serving_common(head), '--dump-jsonl', dump])
    off, offline = read_dump(dump), json.loads(lines[-1])
    same = [p for p in art if art[p]['hyp'] == off[p]['hyp']]
    streamed = results['--artifact']
    check(all(art[p] == off[p] for p in same) and (
        len(same) < len(art) or (streamed['wer'], streamed['cer'])
        == (offline['wer'], offline['cer'])),
          f'--artifact streaming (WER {streamed["wer"]}, CER '
          f'{streamed["cer"]}) vs --artifact --offline --offline-norm cmvn '
          f'(WER {offline["wer"]}, CER {offline["cer"]}): {len(same)} of '
          f'{len(art)} strings equal, each with the same edit counts')


def phase_streaming_lookahead_exact(manifest: str, run_dir: str,
                                    arts: dict, card: str):
    """The bounded-lookahead streamer with the full one-sided context on
    the run's Wav2Letter-20, LOOKAHEAD_UTTS utterances concatenated (an
    even frame count), the artifact's CMVN: its interior rows (a receptive
    field from the edges) within LOOKAHEAD_ATOL of the offline forward."""
    cfg, model, labels, _ = load_run(run_dir)
    model.to(DEVICE).eval()
    mcfg = cfg['model']
    _, _, stats = load_serving(arts['f32'])
    specs = _conv_specs_w2l(mcfg['layers'][:int(mcfg['mid_layers'])])
    rf = one_sided_context(specs)
    la = -(-rf // 2) * 2 + 2
    sw = BoundedLookaheadStreamer(
        model, build_frontend(mcfg, dither=0.0, device=DEVICE), specs,
        chunk_frames=STREAM_CHUNK, lookahead_frames=la, norm='precomputed',
        norm_stats=stats, device=DEVICE)
    audio = np.concatenate([a for _, a in corpus_audio(
        manifest, labels)[:LOOKAHEAD_UTTS]])
    n = (len(audio) // sw.hop) * sw.hop
    if (1 + n // sw.hop) % 2:
        n -= sw.hop
    audio = audio[:n]
    t0 = time.perf_counter()
    got = bounded_stream_logprobs(sw, audio[None])[0]
    secs = time.perf_counter() - t0
    fe = build_frontend(mcfg, dither=0.0, device=DEVICE, norm_stats=stats)
    with torch.no_grad():
        feats, flens = fe(torch.from_numpy(audio[None]).to(DEVICE),
                          torch.tensor([n], device=DEVICE))
        want, lens = model(feats, flens)
    want = want[0, :int(lens[0])].cpu().numpy()
    edge = -(-rf // 2) + 1
    err = float(np.abs(got[edge:-edge] - want[edge:-edge]).max())
    scale = float(np.abs(want).max())
    check(got.shape == want.shape and err <= LOOKAHEAD_ATOL,
          f'bounded lookahead at the full one-sided context ({la} frames, '
          f'window {sw.window_frames}), {n / 16000:.2f} s: interior rows '
          f'[{edge}, {want.shape[0] - edge}) of {want.shape[0]} vs the '
          f'offline forward, max |d logp| {err:.3e} ({err / scale:.1e} of '
          f'max |logp|; gate {LOOKAHEAD_ATOL}); {secs:.2f} s [{card}]')


class count_windows:
    """Counts ``BoundedLookaheadStreamer._win_fn`` calls (model windows)
    inside the ``with`` block."""

    def __enter__(self):
        self.n = 0
        self._orig = BoundedLookaheadStreamer._win_fn

        def counted(sw, feats):
            self.n += 1
            return self._orig(sw, feats)
        BoundedLookaheadStreamer._win_fn = counted
        return self

    def __exit__(self, *exc):
        BoundedLookaheadStreamer._win_fn = self._orig
        return False


def phase_streaming_qn(manifest: str, qn_run: str, root: str, card: str,
                       k1: dict) -> dict:
    """Bounded lookahead on the QuartzNet-15x5 run (left 128, chunk 64,
    lookahead 96 frames) over QN_LA_UTTS utterances: evaluate.main on the
    card, K1 once a frontend chunk and a finish, K4 once and K6 76 times
    a window; the card's probabilities against the CPU's. Returns K4's and
    K6's launches."""
    with open(manifest) as f:
        rows = f.read().splitlines()[:QN_LA_UTTS]
    small = os.path.join(root, 'qn_lookahead.jsonl')
    with open(small, 'w') as f:
        f.write('\n'.join(rows) + '\n')
    cfg, _, labels, _ = load_run(qn_run)
    mcfg = cfg['model']
    utts = corpus_audio(small, labels)
    chunk = STREAM_CHUNK * build_frontend(mcfg).hop
    with count_windows() as win:
        lines, _, secs, launches = run_counted(
            port_eval.main, ['--model-path', qn_run, '--test-manifest', small,
                             '--device', str(DEVICE), '--streaming',
                             '--lookahead-frames', str(QN_LA),
                             '--lookahead-left-frames', str(QN_LA_LEFT)],
            (stft_mel_log, depthwise_fwd, sep_fwd),
            'evaluate --streaming --lookahead-frames (QuartzNet-15x5)', None)
    k1['evaluate --lookahead-frames (QuartzNet-15x5)'] = \
        launches['stft_mel_log']
    want = {'stft_mel_log': sum(lookahead_k1(chunk, len(a))
                                for _, a in utts),
            'depthwise_fwd': win.n, 'sep_fwd': QN_UNITS * win.n}
    result = json.loads(lines[-1])
    print(f'evaluate.main --streaming --lookahead-frames {QN_LA} '
          f'--lookahead-left-frames {QN_LA_LEFT} (QuartzNet-15x5): '
          f'{json.dumps(result)}; {secs:.2f} s [{card}]')
    check(launches == want and win.n > 0
          and result['num_utterances'] == QN_LA_UTTS
          and all(math.isfinite(result[k]) for k in ('wer', 'cer')),
          f'QuartzNet bounded lookahead: {win.n} windows, launches '
          f'{launches} (want {want}: K1 a frontend chunk and a finish, K4 '
          f'once and K6 {QN_UNITS} times a window), finite WER/CER')
    specs = _conv_specs_jasper(
        mcfg['jasper_blocks'][:int(mcfg['mid_layers'])])
    outs = {}
    for dev in (DEVICE, torch.device('cpu')):
        sw = BoundedLookaheadStreamer(
            load_run(qn_run)[1], build_frontend(mcfg, dither=0.0,
                                                device=dev), specs,
            chunk_frames=STREAM_CHUNK, lookahead_frames=QN_LA,
            left_frames=QN_LA_LEFT, device=dev)
        outs[dev.type] = [bounded_stream_logprobs(sw, a[None])[0]
                          for _, a in utts]
        if dev == DEVICE:
            window = torch.zeros(1, sw.window_frames, sw.feat_dim,
                                 device=DEVICE)
            win_ms = cuda_ms(lambda: sw._win_fn(window), iters=10, warmup=2,
                             queued=False)
    pairs = list(zip(outs[DEVICE.type], outs['cpu']))
    err = max(float(np.abs(a - b).max()) for a, b in pairs)
    agree = np.mean(np.concatenate([a.argmax(-1) == b.argmax(-1)
                                    for a, b in pairs]))
    check(err <= QN_LA_ATOL,
          f'QuartzNet bounded lookahead, card vs CPU, {QN_LA_UTTS} '
          f'utterances: max |d prob| {err:.3e} (gate {QN_LA_ATOL}), argmax '
          f'agreement {agree:.4f}; a window of {QN_LA_LEFT} + '
          f'{STREAM_CHUNK} + {QN_LA} frames {win_ms:.3f} ms at B=1 [{card}]')
    return {'depthwise_fwd': launches['depthwise_fwd'],
            'sep_fwd': launches['sep_fwd']}


def serve_in_thread(srv):
    """Run a StreamingServer's loop in a thread; returns its stopper."""
    import asyncio
    import threading
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(srv.start())
        started.set()
        loop.run_forever()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    check(started.wait(60), f'serve_tcp listening on 127.0.0.1:{srv.port}')

    def stop():
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
    return stop


def dedicated_text(sw, labels, audio) -> str:
    """A dedicated one-stream StreamingTranscriber's final text."""
    tr = StreamingTranscriber(sw.start(1), labels)
    tr.feed(audio[None])
    return tr.finish(np.array([len(audio)]))[0]


def phase_streaming_tcp(manifest: str, arts: dict, card: str):
    """serve_tcp's server (16 slots, 127.0.0.1, the f32 + CMVN artifact)
    and 16 concurrent StreamClients, one in s16 and one at 8 kHz (the
    server resamples), sending 100 ms pieces unpaced: every FINAL equals
    a dedicated StreamingTranscriber's on the card; the 17th connection
    gets BUSY."""
    import threading
    srv, meta = port_serve.build_server(port_serve.parse_args(
        ['--artifact', arts['f32'], '--host', '127.0.0.1', '--port', '0',
         '--slots', str(TCP_SLOTS), '--chunk-frames', str(STREAM_CHUNK),
         '--device', str(DEVICE)]))
    sw, labels = srv.mux.m, meta['labels']
    plans = []
    for i, (_, a) in enumerate(corpus_audio(manifest, labels)[:TCP_SLOTS]):
        if i == 0:      # s16 on the wire: the server hears it quantized
            heard = np.clip(a * 32768.0, -32768, 32767).astype('<i2') \
                .astype(np.float32) / 32768.0
            plans.append((a, 16000, 's16', heard))
        elif i == 1:    # an 8 kHz client, resampled by the server
            a8 = resample(a, 16000, 8000)
            plans.append((a8, 8000, 'f32', resample(a8, 8000, 16000)))
        else:
            plans.append((a, 16000, 'f32', a))
    expected = [dedicated_text(sw, labels, heard) for *_, heard in plans]
    stop = serve_in_thread(srv)
    finals = [None] * TCP_SLOTS
    try:
        clients = [StreamClient('127.0.0.1', srv.port, sample_rate=rate,
                                fmt=fmt, timeout=300)
                   for _, rate, fmt, _ in plans]
        try:
            StreamClient('127.0.0.1', srv.port, timeout=60)
            busy = ''
        except RuntimeError as e:
            busy = str(e)
        check('busy' in busy, f'connection {TCP_SLOTS + 1} refused: '
              f'{busy!r}')

        def send(i):
            audio, rate, _, _ = plans[i]
            piece = int(rate * TCP_PIECE_S)
            for j in range(0, len(audio), piece):
                clients[i].send(audio[j:j + piece])
            finals[i] = clients[i].finish()
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(TCP_SLOTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
    finally:
        stop()
    audio_s = sum(len(a) / r for a, r, _, _ in plans)
    check(finals == expected,
          f'serve_tcp: {TCP_SLOTS} concurrent clients ({audio_s:.1f} s of '
          f'audio in {TCP_PIECE_S * 1000:.0f} ms pieces, unpaced; one s16, '
          f'one at 8 kHz): every FINAL equals its dedicated session\'s; '
          f'{wall:.2f} s wall, {audio_s / wall:.1f} s of audio a second '
          f'[{card}]')


def profile_ticks(mux, n: int) -> tuple:
    """(launches a tick, device-busy share, K1's share of the busy time)
    over ``n`` ticks under the profiler; None where no device time was
    recorded."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            mux.tick()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e6
    events = kernel_rows(prof)
    busy = sum(e.self_device_time_total for e in events)
    if busy <= 0:
        return None
    k1 = sum(e.self_device_time_total for e in events
             if 'stft_mel_log_kernel' in e.key)
    return (sum(e.count for e in events) / n, busy / window, k1 / busy)


def time_ticks(sw, slots: int, labels, rng):
    """A StreamMultiplexer of ``slots`` streams, each attached and primed
    (B=1), then TICK_ITERS ticks timed (chained: each returns the host's
    text, so it ends synchronised) after two warm-up ticks: (ms a tick,
    peak GiB, profile_ticks over three more)."""
    mux = StreamMultiplexer(sw, slots=slots, labels=labels)
    n = sw.prime_samples + (TICK_ITERS + 5) * sw.chunk_samples
    audio = (0.1 * rng.standard_normal((slots, n))).astype(np.float32)
    for s in range(slots):
        mux.feed(mux.attach(), audio[s])
    for _ in range(2):
        mux.tick()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TICK_ITERS):
        mux.tick()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TICK_ITERS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_ticks(mux, 3)
    del mux
    torch.cuda.empty_cache()
    return ms, peak, prof


def phase_streaming_timing(arts: dict, card: str):
    """B=1 prime, step and finish ms (f32); StreamMultiplexer.tick ms at
    TICK_SLOTS slots for f32, int8 weights and int8_full (static scales),
    the real-time factor (tick / chunk), the streams a card keeps at real
    time at that batch, peak memory; launches, busy share and K1's share
    of a tick (profiler)."""
    meta, folded_f, stats = load_serving(arts['f32'])
    meta_q, folded_q, _ = load_serving(arts['int8'])
    labels = meta['labels']

    def streamer(mode):
        return StreamingWav2Letter(
            meta['layers'], meta['num_labels'], None,
            artifact_frontend(meta, device=DEVICE),
            folded=folded_f if mode == 'f32' else folded_q,
            weights='int8_full' if mode == 'int8_full' else 'f32',
            act_scales=meta_q['act_scales'] if mode == 'int8_full' else None,
            chunk_frames=STREAM_CHUNK, norm='precomputed', norm_stats=stats,
            device=DEVICE)
    rng = np.random.default_rng(29)
    sw = streamer('f32')
    w = sw._weights_dev
    a = torch.from_numpy((0.1 * rng.standard_normal(
        (1, sw.prime_samples + sw.chunk_samples))).astype(np.float32)).to(
        DEVICE)
    prime, step = a[:, :sw.prime_samples], a[:, sw.prime_samples:]
    state, _ = sw._prime_fn(w, prime)
    tail = torch.tensor([sw.chunk_samples // 2], device=DEVICE)
    phases = {'prime': lambda: sw._prime_fn(w, prime),
              'step': lambda: sw._step_fn(w, state, step),
              'finish': lambda: sw._finish_fn(w, state, step, tail)}
    print('streaming phases, B=1, f32, chunk 64: ' + '; '.join(
        f'{k} {cuda_ms(f, iters=10, warmup=2, queued=False):.3f} ms '
        f'({cuda_ms(f, iters=10, warmup=2):.3f} ms device)'
        for k, f in phases.items()) + f' [{card}]')
    profile_top(lambda: [phases['step']() for _ in range(3)],
                'three f32 steps at B=1')
    # The widest layer at a step's shapes: cuDNN against the same
    # convolution as an unfold and one cuBLAS product.
    k, _, d = serving_infer._layer_geometry(meta['layers'])[WIDE_LAYER]
    wf = w[WIDE_LAYER][0].permute(2, 1, 0)              # [C_out, C_in, k]
    cout, cin, _ = wf.shape
    wmat = wf.permute(2, 1, 0).reshape(k * cin, cout)
    t_out = sw._chunk_outs[WIDE_LAYER + 1]
    for B in (1, 16):
        x = torch.randn(B, cin, t_out + (k - 1) * d, device=DEVICE)

        def gemm():
            cols = x.unfold(2, (k - 1) * d + 1, 1)[..., ::d]
            return cols.permute(0, 2, 3, 1).reshape(B * t_out, k * cin) \
                @ wmat
        conv = F.conv1d(x, wf, dilation=d)
        agree = (gemm().view(B, t_out, cout).transpose(1, 2)
                 - conv).abs().max().item()
        conv_ms = cuda_ms(lambda: F.conv1d(x, wf, dilation=d))
        gemm_ms = cuda_ms(gemm)
        ops = 2 * B * t_out * k * cin * cout
        bound = max(4 * (wf.numel() + x.numel() + B * t_out * cout)
                    / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3
        print(f'widest layer (k={k}, {cin} -> {cout}, d={d}) at a step, '
              f'B={B} x {t_out} frames: cuDNN {conv_ms:.3f} ms '
              f'({ops / conv_ms / 1e9:.2f} TFLOP/s), unfold + cuBLAS '
              f'{gemm_ms:.3f} ms (agrees to {agree:.1e}); bound {bound:.4f} '
              f'ms [{card}]')
    chunk_ms = sw.chunk_samples / sw.sample_rate * 1e3
    for mode in ('f32', 'int8', 'int8_full'):
        sw_mode = sw if mode == 'f32' else streamer(mode)
        for slots in TICK_SLOTS:
            ms, peak, prof = time_ticks(sw_mode, slots, labels, rng)
            prof_text = 'profiler: no device time (not measured)' \
                if prof is None else (
                    f'{prof[0]:.0f} launches a tick, device busy '
                    f'{prof[1]:.1%}, K1 {prof[2]:.2%} of the busy time')
            rtf = ms / chunk_ms
            print(f'StreamMultiplexer.tick, {mode}, {slots} slots: '
                  f'{ms:.3f} ms a tick (chained, synchronised), real-time '
                  f'factor {rtf:.4f}, {int(slots / rtf)} streams at real '
                  f'time at this batch; peak memory {peak:.3f} GiB; '
                  f'{prof_text} [{card}]')


def phase_streaming(manifest: str, w2l_run: str, qn_run: str, arts: dict,
                    root: str, card: str) -> dict:
    """The streaming slice on the Wav2Letter-20 run and its artifacts and
    the QuartzNet-15x5 run. Returns K1's streaming launches by entry point
    (each counted from 0 just before and read just after), K4's and K6's
    on the QuartzNet lookahead, and K1's largest error at the streaming
    shapes."""
    t0 = time.time()
    k1, secs = {}, {}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        secs[name] = round(time.time() - t, 1)
        return out
    k1_err = timed('K1', phase_streaming_k1, arts)
    strings = timed('exact', phase_streaming_exact, manifest, arts, card, k1)
    timed('card vs CPU', phase_streaming_card_vs_cpu, manifest, arts)
    timed('evaluate', phase_streaming_cli, manifest, arts, w2l_run, root,
          card, strings, k1)
    timed('full lookahead', phase_streaming_lookahead_exact, manifest,
          w2l_run, arts, card)
    qn = timed('QuartzNet lookahead', phase_streaming_qn, manifest, qn_run,
               root, card, k1)
    timed('TCP', phase_streaming_tcp, manifest, arts, card)
    timed('times', phase_streaming_timing, arts, card)
    print(f'streaming path: K1 launched {sum(k1.values())} times: '
          f'{json.dumps(k1)}; K4/K6 on the QuartzNet lookahead: '
          f'{json.dumps(qn)}; phase {time.time() - t0:.1f} s, by part '
          f'{json.dumps(secs)}')
    return {'k1': k1, 'qn': qn, 'k1_err': k1_err}


# ------------------------------------------------------- streaming Jasper

# Clips longer than QuartzNet-15x5's 40.29 s prime window: QN_CLIP_UTTS
# corpus utterances (~8.07 s each) concatenated, ~48.4 s: the prime and
# at least 12 steps of 640 ms.
QN_CLIP_UTTS = 6
QN_CLIPS = 2
QN_DW_OPS = 77               # depthwise convs a phase: C1, 15 x 5, C2
# The stream vs the eval forward (K4 + K6) on the clips zero-padded past
# the lookahead, on log(max(p, 1e-30)): max |d| / max |log p|. The same
# float32 math in other orders (K6 fuses what the stream does as K4 and a
# product); card vs CPU streams (f32, int8 weights) likewise.
QN_STREAM_RTOL = 1e-4
QN_CPU_CLIPS = 1
QN_MUX_STREAMS = 8
QN_TICK_SLOTS = (16,)


def log_probs(p: np.ndarray) -> np.ndarray:
    return np.log(np.maximum(p, 1e-30))


def write_clips(manifest: str, root: str) -> str:
    """QN_CLIPS WAVs of QN_CLIP_UTTS corpus utterances each, with their
    transcripts joined; returns their manifest."""
    with open(manifest) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    out = []
    for c in range(QN_CLIPS):
        part = range(c * QN_CLIP_UTTS, (c + 1) * QN_CLIP_UTTS)
        path = os.path.join(root, f'clip{c}.wav')
        write_wav(path, np.concatenate([
            read_wav(rows[i]['audio_filepath'])[0] for i in part]), 16000)
        out.append({'audio_filepath': path,
                    'text': ' '.join(rows[i]['text'] for i in part)})
    clips = os.path.join(root, 'qn_clips.jsonl')
    with open(clips, 'w') as f:
        f.write('\n'.join(json.dumps(r) for r in out) + '\n')
    return clips


def stream_phases(sw, n: int) -> int:
    """Phases of one stream of ``n`` samples: a prime, a step a full
    chunk after it, a finish."""
    return 2 + (n - sw.prime_samples) // sw.chunk_samples


def phase_qn_stream_kernels(sw, audio) -> tuple:
    """(a) K4 against its plain version at every (B, T, C, K, s, d) the
    streamer gives it in a prime, a step and a finish at B=1 and a step
    at B=16 (the multiplexer's shapes), p = 0; K1 at the phases' buffers
    (phase 3's gates). Returns K4's largest |d| and K1's largest
    error."""
    seen, bufs = {}, []
    orig_dw, orig_k1 = streaming_jasper.depthwise_fwd, sw._frames_to_mel

    def dw(x, w, s, d, p):
        seen.setdefault((*x.shape, w.shape[0], s, d, p), None)
        return orig_dw(x, w, s, d, p)

    def k1(buf, n):
        bufs.append((buf.contiguous(), n))
        return orig_k1(buf, n)
    streaming_jasper.depthwise_fwd, sw._frames_to_mel = dw, k1
    try:
        w = sw._weights_dev
        a = torch.from_numpy(audio[None, :sw.prime_samples
                                   + sw.chunk_samples]).to(DEVICE)
        state, _ = sw._prime_fn(w, a[:, :sw.prime_samples])
        step = a[:, sw.prime_samples:]
        new, _ = sw._step_fn(w, state, step)
        sw._finish_fn(w, new, step, torch.full(
            (1,), sw.chunk_samples // 3, device=DEVICE))
        # a tick of 16 slots: the multiplexer primes and finishes at B=1
        sw._step_fn(w, map_state(lambda t: t.repeat_interleave(16, dim=0),
                                 state), step.repeat(16, 1))
    finally:
        streaming_jasper.depthwise_fwd = orig_dw
        del sw._frames_to_mel
    rng = np.random.default_rng(61)
    worst, err_abs, kinds = 0.0, 0.0, set()
    for B, T, C, K, s, d, p in seen:
        x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(
            np.float32)).to(DEVICE)
        wk = torch.from_numpy((0.1 * rng.standard_normal((K, C))).astype(
            np.float32)).to(DEVICE)
        got = depthwise_fwd(x, wk, s, d, p)
        ref = depthwise_fwd_reference(x, wk, s, d, p)
        worst = max(worst, rel_err(got, ref))
        err_abs = max(err_abs, (got - ref).abs().max().item())
        kinds.add((C, K, s, d))
    check(worst < SEP_DW_RTOL and not any(p for *_, p in seen),
          f'K4 at the QuartzNet streamer\'s {len(seen)} shapes ({len(kinds)} '
          f'(C, K, s, d); prime, step and finish at B=1, step at 16; p = 0) '
          f'vs '
          f'its plain version: max |d| / max |plain| {worst:.2e} (gate '
          f'{SEP_DW_RTOL})')
    errs = []
    for (buf, n), what in zip(bufs, ['prime', 'step', 'finish', 'step']):
        lens = torch.full((buf.shape[0],), (n - 1) * sw.hop,
                          dtype=torch.int32, device=DEVICE)
        errs.append(k1_compare(f'QuartzNet streaming {what} '
                               f'B={buf.shape[0]}', sw.frontend, buf, lens,
                               n))
    return err_abs, max(errs)


def qn_offline(qn_run: str, stats, utts, sw) -> dict:
    """The run's eval Jasper (K4 + K6) on the card behind a frontend with
    the artifact's CMVN, on the clips zero-padded past the lookahead as
    the JAX parity test pads: {path: probabilities [T', L]}."""
    cfg, model, _, _ = load_run(qn_run)
    model.to(DEVICE).eval()
    fe = build_frontend(cfg['model'], dither=0.0, device=DEVICE,
                        norm_stats=stats)
    pad = max(len(a) for _, a in utts) + (sw.lookahead_frames + 16) * sw.hop
    audio = np.zeros((len(utts), pad), np.float32)
    for j, (_, a) in enumerate(utts):
        audio[j, :len(a)] = a
    with torch.no_grad():
        feats, flens = fe(torch.from_numpy(audio).to(DEVICE),
                          torch.tensor([len(a) for _, a in utts],
                                       device=DEVICE))
        probs, lens = model(feats, flens)
    probs, lens = probs.cpu().numpy(), lens.cpu().numpy()
    return {p: probs[j, :lens[j]] for j, (p, _) in enumerate(utts)}


def greedy_equal(greedy, ref: dict, got: dict, what: str) -> dict:
    """Greedy strings of ``got`` (probabilities), each equal to ``ref``'s
    but where they differ only at near-ties (a top-2 gap of ``ref``'s log
    probabilities below NEAR_TIE at every frame whose argmax differs)."""
    strings, ties = {}, 0
    for p, r in ref.items():
        a, b = greedy.decode(r[None])[0], greedy.decode(got[p][None])[0]
        strings[p] = b
        if a != b:
            top2 = np.sort(log_probs(r), axis=-1)[:, -2:]
            flips = np.nonzero(r.argmax(-1) != got[p].argmax(-1))[0]
            gaps = (top2[flips, 1] - top2[flips, 0]).tolist()
            name = os.path.basename(p) if isinstance(p, str) else p
            check(max(gaps) < NEAR_TIE, f'{what}, {name}: the strings '
                  f'differ only at near-ties (gaps {gaps})')
            ties += 1
    print(f'{what}: {len(ref) - ties} of {len(ref)} greedy strings equal, '
          f'{ties} at near-ties')
    return strings


def phase_qn_stream_exact(art: str, qn_run: str, utts, card: str,
                          counts: dict):
    """(b) The f32 stream of the artifact (its CMVN), one session a clip,
    against the eval forward: returns (streamer, streamed strings)."""
    sw, labels, meta = streaming_from_artifact(art, chunk_frames=STREAM_CHUNK,
                                               device=DEVICE)
    stats = load_serving(art)[2]
    phases = sum(stream_phases(sw, len(a)) for _, a in utts)
    stft_mel_log.launches = depthwise_fwd.launches = 0
    t0 = time.perf_counter()
    got = stream_all(sw, utts)
    secs = time.perf_counter() - t0
    counts['stream_logprobs'] = (stft_mel_log.launches,
                                 depthwise_fwd.launches)
    check(counts['stream_logprobs'] == (phases, QN_DW_OPS * phases),
          f'QuartzNet streams: K1 {stft_mel_log.launches}, K4 '
          f'{depthwise_fwd.launches} launches over {phases} phases (one and '
          f'{QN_DW_OPS} a phase)')
    ref = qn_offline(qn_run, stats, utts, sw)
    scale = max(float(np.abs(log_probs(r)).max()) for r in ref.values())
    err = 0.0
    for p, r in ref.items():
        check(got[p].shape == r.shape, f'{os.path.basename(p)}: streamed '
              f'{got[p].shape[0]} frames, offline {r.shape[0]}')
        err = max(err, float(np.abs(log_probs(got[p]) - log_probs(r)).max()))
    audio_s = sum(len(a) for _, a in utts) / 16000
    check(err <= QN_STREAM_RTOL * scale,
          f'QuartzNet-15x5 streaming (B=1, chunk {STREAM_CHUNK}, prime '
          f'{sw.prime_samples / 16000:.2f} s, lookahead '
          f'{sw.lookahead_frames} frames) vs its eval forward (K4 + K6), '
          f'{len(utts)} clips of {audio_s / len(utts):.1f} s, same CMVN: max '
          f'|d log p| {err:.3e}, {err / scale:.2e} of max |log p| '
          f'{scale:.2f} (gate {QN_STREAM_RTOL}); {secs:.2f} s, '
          f'{audio_s / secs:.1f} s of audio a second [{card}]')
    strings = greedy_equal(port_eval.GreedyDecoder(labels), ref, got,
                           'QuartzNet stream vs offline')
    return sw, strings


def phase_qn_stream_card_vs_cpu(art: str, utts):
    """(c) StreamingJasper on the card against the same class on the CPU
    on QN_CPU_CLIPS clips cut to one length (one session each): f32 and int8
    weights within QN_STREAM_RTOL of max |log p|; in every mode the greedy
    strings equal but at near-ties (int8_full: an activation at an int8
    rounding edge may quantize apart, as K1 and the plain DFT differ in
    the last bits, so its log-probabilities are printed, not gated)."""
    meta, folded, stats = load_serving(art)
    greedy = port_eval.GreedyDecoder(meta['labels'])
    n = min(len(a) for _, a in utts[:QN_CPU_CLIPS])
    audio = np.stack([a[:n] for _, a in utts[:QN_CPU_CLIPS]])
    for weights in ('f32', 'int8', 'int8_full'):
        outs = []
        t0 = time.perf_counter()
        for dev in (DEVICE, torch.device('cpu')):
            sw = StreamingJasper(meta['jasper_blocks'], meta['num_labels'],
                                 None, artifact_frontend(meta, device=dev),
                                 folded=folded, weights=weights,
                                 chunk_frames=STREAM_CHUNK,
                                 norm='precomputed', norm_stats=stats,
                                 device=dev)
            with torch.no_grad():
                sess = sw.start(QN_CPU_CLIPS)
                emitted = [sess.feed(audio)]
                fin, valid = sess.finish()
            out = np.concatenate(emitted + [fin], axis=1)
            v = sess.head_frames_emitted + valid
            outs.append([out[b, :v[b]] for b in range(QN_CPU_CLIPS)])
        card, cpu = outs
        err = max(float(np.abs(log_probs(a) - log_probs(b)).max())
                  for a, b in zip(card, cpu))
        scale = max(float(np.abs(log_probs(b)).max()) for b in cpu)
        agree = np.mean(np.concatenate([a.argmax(-1) == b.argmax(-1)
                                        for a, b in zip(card, cpu)]))
        greedy_equal(greedy, dict(enumerate(cpu)), dict(enumerate(card)),
                     f'QuartzNet streaming {weights}, card vs CPU')
        check(weights == 'int8_full' or err <= QN_STREAM_RTOL * scale,
              f'QuartzNet streaming {weights}, card vs CPU, '
              f'{QN_CPU_CLIPS} clips of {n / 16000:.1f} s (B={QN_CPU_CLIPS}): '
              f'max |d log '
              f'p| {err:.3e} ({err / scale:.1e} of max |log p|'
              + ('' if weights == 'int8_full' else
                 f', gate {QN_STREAM_RTOL}') + f'), argmax agreement '
              f'{agree:.4f}; {time.perf_counter() - t0:.1f} s')


def phase_qn_stream_cli(clips: str, art: str, qn_run: str, utts, sw,
                        strings: dict, root: str, card: str, counts: dict):
    """(d) evaluate --streaming --streaming-norm cmvn on the run and
    evaluate --artifact on its artifact, over the clips: no offline
    fallback, the dumps (b)'s strings; K1 once and K4 QN_DW_OPS times a
    phase (the CMVN pass: K1 once a clip)."""
    phases = sum(stream_phases(sw, len(a)) for _, a in utts)
    for name, argv, k1_extra in (
            ('--streaming --streaming-norm cmvn',
             ['--model-path', qn_run, '--streaming', '--streaming-norm',
              'cmvn', '--streaming-cmvn-manifest', clips], len(utts)),
            ('--artifact', ['--artifact', art], 0)):
        dump = os.path.join(root, f'qn_stream_{len(counts)}.jsonl')
        lines, err, secs, launches = run_counted(
            port_eval.main, [*argv, '--test-manifest', clips, '--device',
                             str(DEVICE), '--dump-jsonl', dump],
            (stft_mel_log, depthwise_fwd),
            f'evaluate {name} (QuartzNet-15x5)',
            {'stft_mel_log': phases + k1_extra,
             'depthwise_fwd': QN_DW_OPS * phases})
        counts[f'evaluate {name}'] = (launches['stft_mel_log'],
                                      launches['depthwise_fwd'])
        result = json.loads(lines[-1])
        hyps = {p: r['hyp'] for p, r in read_dump(dump).items()}
        print(f'evaluate.main {name} (QuartzNet-15x5): {json.dumps(result)}; '
              f'{err.strip().splitlines()[-1] if err.strip() else ""}; '
              f'{secs:.2f} s end to end [{card}]')
        check(result['num_utterances'] == len(utts) and result['streaming']
              and result.get('offline_fallback', 0) == 0
              and result.get('skipped_below_prime', 0) == 0
              and hyps == strings,
              f'{name}: {len(utts)} clips streamed, no offline fallback, '
              'the dump has the strings of the exactness check')


def qn_mux_streams(utts) -> list:
    """QN_MUX_STREAMS streams: the clips, each again with its first 0.2 s
    more cut off per round."""
    n = len(utts)
    return [utts[s % n][1][(s // n) * 3200:] for s in range(QN_MUX_STREAMS)]


def phase_qn_stream_mux(sw, utts, labels, card: str, counts: dict):
    """(e) StreamMultiplexer over QN_MUX_STREAMS streams of the clips
    (attached together, stepped by tick_ready until each has less than a
    chunk left, detached): each stream's probabilities within
    QN_STREAM_RTOL of max |log p| of its dedicated session's (B=1, where
    the products run at another M) and its transcript the dedicated
    session's but at near-ties; K1 once and K4 QN_DW_OPS times a prime,
    tick and finish."""
    streams = qn_mux_streams(utts)
    with torch.no_grad():
        ref = {i: stream_logprobs(sw, a[None])[0]
               for i, a in enumerate(streams)}
    stft_mel_log.launches = depthwise_fwd.launches = 0
    t0 = time.perf_counter()
    mux = StreamMultiplexer(sw, slots=QN_MUX_STREAMS, labels=labels)
    boot = (stft_mel_log.launches, depthwise_fwd.launches)
    slots = [mux.attach() for _ in streams]
    rows = {s: [] for s in slots}
    decode = mux._decode

    def record(slot, out):
        rows[slot].append(out)
        return decode(slot, out)
    mux._decode = record
    for s, a in zip(slots, streams):
        mux.feed(s, a)
    ticks = 0
    while any(mux.pending(s) >= sw.chunk_samples for s in slots):
        ticks += bool(mux.tick_ready())
    texts = [mux.detach(s) for s in slots]
    secs = time.perf_counter() - t0
    phases = 1 + 2 * QN_MUX_STREAMS + ticks     # with the bootstrap prime
    counts['StreamMultiplexer'] = (stft_mel_log.launches,
                                   depthwise_fwd.launches)
    got = {i: np.concatenate(rows[s]) for i, s in enumerate(slots)}
    greedy = port_eval.GreedyDecoder(labels)
    strings = greedy_equal(greedy, ref, got,
                           'StreamMultiplexer vs dedicated sessions')
    err = max(float(np.abs(log_probs(got[i]) - log_probs(r)).max())
              if got[i].shape == r.shape else math.inf
              for i, r in ref.items())
    scale = max(float(np.abs(log_probs(r)).max()) for r in ref.values())
    audio_s = sum(len(a) for a in streams) / 16000
    check(texts == [strings[i] for i in range(len(streams))]
          and err <= QN_STREAM_RTOL * scale and boot == (1, QN_DW_OPS)
          and counts['StreamMultiplexer'] == (phases, QN_DW_OPS * phases),
          f'StreamMultiplexer, QuartzNet-15x5, {QN_MUX_STREAMS} streams '
          f'({audio_s:.1f} s of audio) vs dedicated sessions: max |d log p| '
          f'{err:.3e} ({err / scale:.1e} of max |log p|, gate '
          f'{QN_STREAM_RTOL}); {ticks} ticks; K1 {stft_mel_log.launches}, '
          f'K4 {depthwise_fwd.launches} launches over {phases} phases (one '
          f'and {QN_DW_OPS} a phase); {secs:.2f} s [{card}]')


def phase_qn_stream_timing(art: str, card: str):
    """B=1 prime, step and finish ms, and StreamMultiplexer.tick at
    QN_TICK_SLOTS slots with launches, busy share and peak memory, f32
    and int8_full (dynamic scales)."""
    meta, folded, stats = load_serving(art)
    labels = meta['labels']
    rng = np.random.default_rng(31)
    chunk_ms = STREAM_CHUNK * 10.0
    for weights in ('f32', 'int8_full'):
        sw = StreamingJasper(meta['jasper_blocks'], meta['num_labels'], None,
                             artifact_frontend(meta, device=DEVICE),
                             folded=folded, weights=weights,
                             chunk_frames=STREAM_CHUNK, norm='precomputed',
                             norm_stats=stats, device=DEVICE)
        w = sw._weights_dev
        a = torch.from_numpy((0.1 * rng.standard_normal(
            (1, sw.prime_samples + sw.chunk_samples))).astype(np.float32)).to(
            DEVICE)
        prime, step = a[:, :sw.prime_samples], a[:, sw.prime_samples:]
        state, _ = sw._prime_fn(w, prime)
        tail = torch.tensor([sw.chunk_samples // 2], device=DEVICE)
        phases = {'prime': lambda: sw._prime_fn(w, prime),
                  'step': lambda: sw._step_fn(w, state, step),
                  'finish': lambda: sw._finish_fn(w, state, step, tail)}
        print(f'QuartzNet-15x5 streaming phases, B=1, {weights}, chunk '
              f'{STREAM_CHUNK}: ' + '; '.join(
                  f'{k} {cuda_ms(f, iters=5, warmup=1, queued=False):.3f} ms '
                  f'({device_ms(f):.3f} ms device)'
                  for k, f in phases.items()) + f' [{card}]')
        profile_top(lambda: [phases['step']() for _ in range(3)],
                    f'three QuartzNet {weights} steps at B=1')
        if weights == 'f32':
            host_profile(lambda: [phases['step']() for _ in range(3)],
                         'three QuartzNet f32 steps at B=1')
        for slots in QN_TICK_SLOTS:
            ms, peak, prof = time_ticks(sw, slots, labels, rng)
            prof_text = 'profiler: no device time (not measured)' \
                if prof is None else (
                    f'{prof[0]:.0f} launches a tick, device busy '
                    f'{prof[1]:.1%}, K1 {prof[2]:.2%} of the busy time')
            rtf = ms / chunk_ms
            print(f'StreamMultiplexer.tick, QuartzNet-15x5, {weights}, '
                  f'{slots} slots: {ms:.3f} ms a tick, real-time factor '
                  f'{rtf:.4f}, {int(slots / rtf)} streams at real time at '
                  f'this batch; peak memory {peak:.3f} GiB; {prof_text} '
                  f'[{card}]')


def device_ms(fn, n: int = 3) -> float:
    """Device time of one call of ``fn``: the profiler's kernel time over
    ``n`` calls, divided by ``n`` (NaN where it recorded none). Unlike
    ``cuda_ms`` it holds for a call of more launches than the device's
    queue takes (~1 000), whose host side no spin can hide."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in kernel_rows(prof))
    return busy / n / 1e3 if busy > 0 else math.nan


def host_profile(fn, what: str, top: int = 10):
    """The host's time by function (cProfile, own time) over ``fn``."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    total = stats.total_tt
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(f'host profile, {what}: {total * 1e3:.1f} ms in Python')
    for (path, line, name), (_, calls, own, cum, _) in rows:
        print(f'  {100 * own / total:5.1f}%  {own * 1e3:8.2f} ms own '
              f'{cum * 1e3:8.2f} ms cum  x{calls:<6d} '
              f'{os.path.basename(path)}:{line}({name})')


def phase_streaming_jasper(manifest: str, qn_run: str, root: str,
                           card: str) -> dict:
    """Exact QuartzNet-15x5 streaming (StreamingJasper: K1 a phase, K4 on
    each of 77 depthwise convs a phase) on the QuartzNet run and its
    artifact, over clips longer than the prime window. Returns K1's and
    K4's launches by entry point and their largest errors at the
    streamer's shapes."""
    t0 = time.time()
    secs = {}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        secs[name] = round(time.time() - t, 1)
        return out
    clips = write_clips(manifest, root)
    art = os.path.join(root, 'artifact_qn')
    k1_export = {}
    timed('export', run_quiet, port_export.main, [
        '--model-path', qn_run, '--out', art, '--cmvn-manifest', clips,
        '--device', str(DEVICE)], k1_export, 'export_serving (QuartzNet)',
          QN_CLIPS)
    meta = load_serving(art)[0]
    labels = meta['labels']
    utts = corpus_audio(clips, labels)
    counts = {}
    sw, strings = timed('exact', phase_qn_stream_exact, art, qn_run, utts,
                        card, counts)
    check(meta['family'] == 'jasper'
          and sw.prime_samples < min(len(a) for _, a in utts)
          - 12 * sw.chunk_samples,
          f'QuartzNet artifact streams: prime {sw.prime_frames} frames '
          f'({sw.prime_samples / 16000:.2f} s), clips '
          f'{min(len(a) for _, a in utts) / 16000:.2f} s and longer')
    k4_err, k1_err = timed('K4', phase_qn_stream_kernels, sw, utts[0][1])
    timed('card vs CPU', phase_qn_stream_card_vs_cpu, art, utts)
    timed('evaluate', phase_qn_stream_cli, clips, art, qn_run, utts, sw,
          strings, root, card, counts)
    timed('multiplexer', phase_qn_stream_mux, sw, utts, labels, card, counts)
    timed('times', phase_qn_stream_timing, art, card)
    k1 = {k: v[0] for k, v in counts.items()}
    k4 = {k: v[1] for k, v in counts.items()}
    print(f'QuartzNet streaming path: K1 {json.dumps(k1)}, K4 '
          f'{json.dumps(k4)}; phase {time.time() - t0:.1f} s, by part '
          f'{json.dumps(secs)}')
    return {'k1': k1, 'k4': k4, 'k1_err': k1_err, 'k4_err': k4_err}


# ------------------------------------------------------------ data layer

# The FLAC corpus of make_offline_corpus (seeds 0 / 1 / 2): train and val
# as the JAX recipe writes them, the test split at least DATA_TEST_MIN_S
# long so that streaming evaluation streams past W2L-20's 4.22 s prime.
DATA_SPLITS = (64, 16, 1)
DATA_TEST_MIN_S = 4.5
DATA_BATCH = 16              # the recipe's batch size
DATA_EPOCHS = 2
DATA_PY_FILES = 2            # files the Python decoder decodes too
DATA_RATES = (8000, 22050)   # resampled in the loader to 16 kHz
DATA_RATE_UTTS = 2
DATA_FEAT_RTOL = 1e-5        # card vs CPU raw features, of max |ref|
DATA_STREAM_UTTS = 1         # MFCC streams held to the offline forward


def data_loader(manifest: str, shuffle=False, prefetch=0, **kw):
    """The recipe's train loader: B=16, 3 length buckets."""
    return BucketBatchLoader(
        ManifestDataset(manifest, 16000, resolve_labels('english_lowercase'),
                        **kw), DATA_BATCH, 160, num_buckets=3,
        prefetch=prefetch, shuffle=shuffle)


def write_flac_corpus(root: str, card: str) -> tuple:
    """make_offline_corpus.main: the corpus under ``root`` and 4
    utterances at each of DATA_RATES. Returns (manifests by split,
    {path: the rendered utterance as round(audio * 32767)})."""
    rendered = {}
    write_utt = port_corpus.write_utt

    def record(path, audio, sr, use_wav):
        rendered[path] = np.round(audio * 32767).astype(np.int32)
        write_utt(path, audio, sr, use_wav)
    port_corpus.write_utt = record
    n_train, n_val, n_test = DATA_SPLITS
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            port_corpus.main(['--root', root, '--n-train', str(n_train),
                              '--n-val', str(n_val), '--splits',
                              'train,val'])
            port_corpus.main(['--root', root, '--n-test', str(n_test),
                              '--splits', 'test', '--min-duration',
                              str(DATA_TEST_MIN_S)])
            for sr in DATA_RATES:
                port_corpus.main(['--root', os.path.join(root, f'sr{sr}'),
                                  '--n-test', str(DATA_RATE_UTTS),
                                  '--splits', 'test', '--sample-rate',
                                  str(sr)])
    finally:
        port_corpus.write_utt = write_utt
    secs = time.perf_counter() - t0
    manifests = {s: os.path.join(root, f'{s}_manifest.csv')
                 for s in ('train', 'val', 'test')}
    lens = {s: [audio_info(r['audio_filepath'])[0] / 16000
                for r in port_dataset.read_manifest(m)]
            for s, m in manifests.items()}
    print(f'make_offline_corpus: {len(rendered)} FLAC files in {secs:.1f} s '
          'on the host; ' + ', '.join(
              f'{s} {len(v)} x {min(v):.2f}-{max(v):.2f} s'
              for s, v in lens.items()) + f' [{card}]')
    return manifests, rendered


def phase_data_flac(rendered: dict, card: str):
    """(a) Every file through the C++ decoder equals round(audio * 32767)
    of its rendered utterance; the Python decoder gives the same samples
    on DATA_PY_FILES files; the two STREAMINFO parsers agree. (g) Decode
    rates on the host."""
    paths = sorted(rendered)
    data = {}
    for p in paths:
        with open(p, 'rb') as f:
            data[p] = f.read()
    t0 = time.perf_counter()
    dec = {p: flac_native.decode_native(data[p]) for p in paths}
    t_cpp = time.perf_counter() - t0
    bad = [p for p in paths if dec[p][2] != 16 or dec[p][0].shape[1] != 1
           or not np.array_equal(dec[p][0][:, 0], rendered[p])]
    check(not bad, f'{len(paths)} FLAC files of make_offline_corpus: the '
          'C++ decoder gives round(audio * 32767) of each rendered '
          f'utterance exactly ({len(bad)} differ)')
    sub = paths[::max(1, len(paths) // DATA_PY_FILES)][:DATA_PY_FILES]
    t0 = time.perf_counter()
    py = {p: port_flac.decode_flac(data[p], verify_md5=True)[0]
          for p in sub}
    t_py = time.perf_counter() - t0
    check(all(np.array_equal(py[p], dec[p][0]) for p in sub),
          f'the Python decoder (CRC and MD5 checked) gives the C++ '
          f'decoder\'s samples on {len(sub)} files')
    keys = ('sample_rate', 'channels', 'bits_per_sample', 'total_samples',
            'min_blocksize', 'max_blocksize')
    disagree = [p for p in paths if flac_native.parse_info_native(data[p])
                != {k: getattr(port_flac.read_flac_info(data[p]), k)
                    for k in keys}]
    check(not disagree, f'read_flac_info and parse_info_native agree on '
          f'{len(paths)} files')
    secs = sum(d[0].shape[0] / d[1] for d in dec.values())
    py_secs = sum(dec[p][0].shape[0] / dec[p][1] for p in sub)
    print(f'FLAC decode on the host: C++ {len(paths) / t_cpp:.1f} utt/s, '
          f'{secs / t_cpp:.1f} s of audio a second ({len(paths)} files, '
          f'{secs:.1f} s); Python {len(sub) / t_py:.2f} utt/s, '
          f'{py_secs / t_py:.2f} s of audio a second ({len(sub)} files, '
          f'{py_secs:.1f} s) [{card}]')


def phase_data_wire(manifests: dict, card: str) -> int:
    """(b) A loader batch on the int16 wire divided by 32768 equals the
    f32 batch bit for bit, and K1's features on the card on each are
    equal, with and without dither; K1 launches once a forward. Returns
    K1's launches."""
    b16 = data_loader(manifests['train'], audio_dtype='int16').peek_batch()
    b32 = data_loader(manifests['train']).peek_batch()
    f = (b16['audio'].astype(np.float32) / 32768.0).view(np.uint32)
    check(b16['audio'].dtype == np.int16 and np.array_equal(
        f, b32['audio'].view(np.uint32)),
          f'int16 batch {b16["audio"].shape} / 32768 equals the f32 batch '
          'bit for bit')
    fe = build_frontend(train_config()['model'], device=DEVICE)
    lens = torch.from_numpy(b32['audio_lengths']).to(DEVICE)
    stft_mel_log.launches = 0
    feats = {}
    with torch.no_grad():
        for name, b in (('int16', b16), ('f32', b32)):
            x = torch.from_numpy(b['audio']).to(DEVICE)
            feats[name] = fe(x, lens)[0]
            g = torch.Generator(device=DEVICE).manual_seed(7)
            feats[name + ' dither'] = fe(x, lens, g)[0]
    torch.cuda.synchronize()
    launches = stft_mel_log.launches
    check(torch.equal(feats['int16'], feats['f32'])
          and torch.equal(feats['int16 dither'], feats['f32 dither'])
          and launches == 4,
          f'K1 features on the card: int16 batch equals f32 bit for bit '
          f'{tuple(feats["f32"].shape)}, without and with dither; K1 '
          f'launched {launches} times for 4 forwards')
    n16 = sum(v.nbytes for v in b16.values() if isinstance(v, np.ndarray))
    n32 = sum(v.nbytes for v in b32.values() if isinstance(v, np.ndarray))
    print(f'host-to-device bytes a batch (B={DATA_BATCH}, '
          f'{b32["audio"].shape[1] / 16000:.2f} s bucket): int16 {n16} '
          f'(audio {b16["audio"].nbytes}), f32 {n32} (audio '
          f'{b32["audio"].nbytes}) [{card}]')
    return launches


def audio_seconds(batches) -> float:
    """Seconds of real audio (padding and masked rows left out)."""
    return sum(float(b['audio_lengths'][b['batch_mask'] > 0].sum())
               for b in batches) / 16000


def phase_data_cache(manifests: dict, root: str, card: str):
    """(c) Two epochs with cache_audio: the second reads no file and its
    batches equal the first's. (g) The loader alone in each epoch, the
    recipe's W2L-20 train step alone over every batch of an epoch, and
    the two together as in training (a fresh shuffled loader, epoch 1
    decoding and epoch 2 from the cache), in utt/s and s of audio a
    second."""
    reads = []
    read_audio = port_dataset.read_audio

    def counting(path, *args):
        reads.append(path)
        return read_audio(path, *args)
    port_dataset.read_audio = counting
    try:
        loader = data_loader(manifests['train'], prefetch=2,
                             cache_audio=True, audio_dtype='int16')
        n = len(loader.dataset)
        t0 = time.perf_counter()
        first = list(loader)
        t1 = time.perf_counter()
        n1 = len(reads)
        second = list(loader)
        t2 = time.perf_counter()
    finally:
        port_dataset.read_audio = read_audio
    same = len(first) == len(second) and all(
        np.array_equal(a[k], b[k]) for a, b in zip(first, second)
        for k in a if isinstance(a[k], np.ndarray))
    check(n1 == n and len(reads) == n and same,
          f'cache_audio: epoch 1 read {n1} files, epoch 2 '
          f'{len(reads) - n1}; the {len(second)} batches equal across '
          'epochs')
    audio_s = audio_seconds(first)

    def rate(secs):
        return (f'{n / secs:.1f} utt/s, {audio_s / secs:.1f} s of audio a '
                'second')
    print(f'loader alone (int16, cache_audio, B={DATA_BATCH}, prefetch 2, '
          f'{len(first)} batches, {n} utterances, {audio_s:.2f} s of '
          f'audio): epoch 1 (decode) {rate(t1 - t0)}; epoch 2 (cache) '
          f'{rate(t2 - t1)} [{card}]')
    args = port_fdr.parse_args(['--corpus-root', root, '--run-dir',
                                os.path.join(root, 'data_timing')])
    cfg = load_config(port_fdr.recipe_overrides(args, manifests))
    trainer = make_trainer(cfg, args.run_dir, DEVICE)
    for b in first:              # every bucket's shape once
        trainer.train_step(port_eval.to_device(b, DEVICE))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for b in first:
        trainer.train_step(port_eval.to_device(b, DEVICE))
    torch.cuda.synchronize()
    alone = time.perf_counter() - t
    fed = data_loader(manifests['train'], shuffle=True, prefetch=2,
                      cache_audio=True, audio_dtype='int16')
    walls = []
    for _ in range(2):
        t = time.perf_counter()
        for b in fed:
            trainer.train_step(port_eval.to_device(b, DEVICE))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    del trainer
    torch.cuda.empty_cache()
    print(f'the recipe\'s W2L-20 train step (NovoGrad, SpecAugment) over '
          f'the epoch\'s {len(first)} batches, B={DATA_BATCH}: alone '
          f'{alone:.3f} s, {rate(alone)}; fed by a fresh loader as in '
          f'training: epoch 1 (decode) {walls[0]:.3f} s, {rate(walls[0])} '
          f'({walls[0] / alone:.3f}x alone); epoch 2 (cache) '
          f'{walls[1]:.3f} s, {rate(walls[1])} ({walls[1] / alone:.3f}x '
          f'alone) [{card}]')


def phase_data_resample(root: str) -> int:
    """(d) 8 kHz and 22.05 kHz FLAC manifests resampled in the loader:
    lengths ceil(n * up / down); the card's raw features against the
    CPU path's within DATA_FEAT_RTOL of max |ref|. Returns K1's
    launches."""
    mcfg = train_config()['model']
    fe_card = build_frontend(mcfg, dither=0.0, device=DEVICE,
                             normalize=False)
    fe_cpu = build_frontend(mcfg, dither=0.0, device='cpu', normalize=False)
    labels = resolve_labels('english_lowercase')
    stft_mel_log.launches = 0
    for sr in DATA_RATES:
        manifest = os.path.join(root, f'sr{sr}', 'test_manifest.csv')
        ds = ManifestDataset(manifest, 16000, labels, resample=True)
        want = []
        for r in ds.rows:
            n, rate = audio_info(r['audio_filepath'])
            up, down = resample_ratio(rate, 16000)
            want.append(-(-n * up // down))
        got = [len(ds[i][0]) for i in range(len(ds))]
        meta = [ds.sample_meta(i)[0] for i in range(len(ds))]
        check(got == meta == want, f'{sr} Hz -> 16 kHz in the loader: '
              f'lengths {got} = ceil(n * up / down)')
        b = BucketBatchLoader(ds, len(ds), 160, num_buckets=1,
                              prefetch=0).peek_batch()
        with torch.no_grad():
            card = fe_card(torch.from_numpy(b['audio']).to(DEVICE),
                           torch.from_numpy(b['audio_lengths']).to(DEVICE)
                           )[0].cpu()
            cpu = fe_cpu(torch.from_numpy(b['audio']),
                         torch.from_numpy(b['audio_lengths']))[0]
        err = (card - cpu).abs().max().item()
        scale = cpu.abs().max().item()
        check(err <= DATA_FEAT_RTOL * scale,
              f'{sr} Hz resampled batch {tuple(b["audio"].shape)}: raw '
              f'log-mel card (K1) vs CPU (plain DFT) max err {err:.3e}, '
              f'{err / scale:.2e} of max |ref| {scale:.2f} (gate '
              f'{DATA_FEAT_RTOL})')
    launches = stft_mel_log.launches
    check(launches == len(DATA_RATES), f'K1 launched {launches} times for '
          f'{len(DATA_RATES)} resampled batches')
    return launches


def phase_data_mfcc(manifests: dict, root: str) -> int:
    """(e) A W2L-20 eval step with MFCC features, card vs CPU; an MFCC
    run exported with CMVN streamed (the DCT after K1 in every phase)
    against the offline forward of the same artifact, at phase 17's
    gate. Returns K1's launches on the streams."""
    mfcc = ['model.feature_type=mfcc']
    phase_cpu_reference(overrides=mfcc, what='Wav2Letter-20 MFCC')
    run = os.path.join(root, 'mfcc_run')
    os.makedirs(run)
    with open(os.path.join(run, 'config.json'), 'w') as f:
        json.dump(train_config(*mfcc), f)
    art = os.path.join(root, 'artifact_mfcc')
    run_quiet(port_export.main, ['--model-path', run, '--out', art,
                                 '--cmvn-manifest', manifests['train'],
                                 '--cmvn-limit', '16', '--device',
                                 str(DEVICE)], what='export_serving (MFCC)')
    sw, labels, meta = streaming_from_artifact(
        art, chunk_frames=STREAM_CHUNK, device=DEVICE)
    utts = corpus_audio(manifests['test'], labels)[:DATA_STREAM_UTTS]
    check(meta['feature_type'] == 'mfcc' and sw.frontend.feature_type
          == 'mfcc' and sw.feat_dim == 64
          and min(len(a) for _, a in utts) > sw.prime_samples,
          'the MFCC artifact carries feature_type mfcc into its streamer '
          f'(64 coefficients); {len(utts)} test utterances of '
          f'{min(len(a) for _, a in utts) / 16000:.2f} s and longer, past '
          f'the {sw.prime_samples / 16000:.2f} s prime')
    stft_mel_log.launches = 0
    got = stream_all(sw, utts)
    launches = stft_mel_log.launches
    want = sum(stream_steps(sw, len(a)) for _, a in utts)
    check(launches == want, f'K1 launched {launches} times over the MFCC '
          f'streams: one a prime, step and finish ({want})')
    stream_vs_offline(art, sw, utts, got, 'MFCC')
    return launches


def pipeline_want(stage: str, argv: list, run: str, cfg: dict,
                  manifests: dict, val_batches: list, steps: int) -> dict:
    """K1/K2/K3 launches of one stage of full_depth_run: training (K1 and
    K2 on every train and val batch, K3 on every train step), the export
    (K1 on each CMVN utterance and the calibration batch) or an evaluate
    call (K1 and K2 on each batch offline; K1 a stream phase, or a
    lookahead chunk and a finish, plus one each CMVN utterance when
    streaming; K1 a batch on the artifact)."""
    if stage == 'train':
        k1 = steps + sum(val_batches)
        return {'stft_mel_log': k1, 'ctc_alpha': k1, 'ctc_beta': steps}
    n_train = len(port_dataset.read_manifest(manifests['train']))
    if stage == 'export':
        return {'stft_mel_log': n_train + 1, 'ctc_alpha': 0, 'ctc_beta': 0}
    manifest = argv[argv.index('--test-manifest') + 1]
    labels = resolve_labels(cfg['model']['labels'])
    fe = build_frontend(cfg['model'], device='cpu')
    data = cfg['data']
    if '--artifact' in argv:
        ds = ManifestDataset(manifest, 16000, labels)
        n = len(BucketBatchLoader(ds, 8, fe.hop, num_buckets=4))
        return {'stft_mel_log': n, 'ctc_alpha': 0, 'ctc_beta': 0}
    if '--streaming' in argv:
        sw, _, _ = streaming_from_artifact(
            os.path.join(run, 'artifact'),
            chunk_frames=int(argv[argv.index('--streaming-chunk-frames')
                                  + 1]), device='cpu')
        lens = [len(a) for _, a in corpus_audio(manifest, labels)]
        k1 = sum(lookahead_k1(sw.chunk_samples, n)
                 if '--lookahead-frames' in argv else stream_steps(sw, n)
                 for n in lens)
        if '--streaming-norm' in argv:
            k1 += n_train
        return {'stft_mel_log': k1, 'ctc_alpha': 0, 'ctc_beta': 0}
    n = len(port_eval.make_loader(
        manifest, int(data['batch_size']), fe, labels,
        num_buckets=int(data['num_length_buckets']),
        max_duration=data['max_duration']))
    return {'stft_mel_log': n, 'ctc_alpha': n, 'ctc_beta': 0}


def phase_data_pipeline(root: str, card: str) -> tuple:
    """(f) full_depth_run.main on the corpus at full width (W2L-20) for
    DATA_EPOCHS epochs, with the recipe's cache_audio, int16 and augment
    map overrides, and every evaluate call of the chain; each stage's
    K1/K2/K3 launches pinned (``pipeline_want``). Returns (K1's launches,
    the result record)."""
    run = os.path.join(root, 'full_depth_run')
    argv = ['--corpus-root', root, '--run-dir', run, '--epochs',
            str(DATA_EPOCHS),
            '--override', 'trainer.log_every_n_steps=1',
            '--override', 'trainer.val_every_n_epochs=1',
            '--override', 'trainer.checkpoint.every_n_epochs=1']
    counters = (stft_mel_log, ctc_alpha, ctc_beta)
    stages, val_batches = [], []

    def counted(stage, fn):
        def wrapper(args_list):
            before = {c.__name__: c.launches for c in counters}
            t = time.perf_counter()
            out = fn(args_list)
            torch.cuda.synchronize()
            stages.append((stage, list(args_list), {
                c.__name__: c.launches - before[c.__name__]
                for c in counters}, round(time.perf_counter() - t, 1)))
            return out
        return wrapper
    validate = Trainer.validate

    def counted_validate(self, loader):
        val_batches.append(len(loader))
        return validate(self, loader)
    patches = [(port_fdr, 'run_evaluate',
                counted('evaluate', port_fdr.run_evaluate)),
               (port_train, 'main', counted('train', port_train.main)),
               (port_export, 'main', counted('export', port_export.main)),
               (Trainer, 'validate', counted_validate)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        lines, _, secs, launches = run_counted(
            port_fdr.main, argv, counters, 'full_depth_run.main')
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    result = json.loads(lines[-1])
    with open(os.path.join(run, 'full_depth_run.json')) as f:
        saved = json.load(f)
    with open(os.path.join(run, 'config.json')) as f:
        cfg = json.load(f)
    check(cfg['data']['cache_audio'] is True
          and cfg['data']['audio_dtype'] == 'int16'
          and cfg['data']['augment'] == {'spec_augment': {
              'freq_masks': 2, 'time_masks': 2, 'freq_width': 10,
              'time_width': 20}}
          and cfg['model']['mid_layers'] == MID_LAYERS and saved == result,
          'the run used the recipe\'s cache_audio, int16 wire and augment '
          'map at full width (mid_layers 20); the result JSON is written')
    losses = read_losses(run)
    steps = sorted(losses)
    check(steps == list(range(1, len(steps) + 1))
          and all(math.isfinite(v) for v in losses.values())
          and losses[steps[-1]] < losses[steps[0]],
          f'{len(steps)} train steps over {DATA_EPOCHS} epochs: loss finite '
          f'and falling, {losses[steps[0]]:.3f} at step {steps[0]} -> '
          f'{losses[steps[-1]]:.3f} at step {steps[-1]}')
    modes = ('val_greedy', 'test_greedy', 'test_beam', 'test_beam_lm',
             'test_streaming', 'test_streaming_cmvn', 'test_streaming_la96',
             'test_streaming_la96_cmvn', 'test_artifact_offline_int8full')
    check(all(k in result and math.isfinite(result[k]['wer'])
              for k in modes)
          and result['test_streaming']['offline_fallback'] == 0
          and result['test_streaming_cmvn']['offline_fallback'] == 0,
          f'evaluate ran in all {len(modes)} modes of the chain; the '
          'streaming modes streamed every test utterance')
    check(len(val_batches) == DATA_EPOCHS and [s[0] for s in stages]
          == ['train'] + ['evaluate'] * 8 + ['export', 'evaluate'],
          f'stages {[s[0] for s in stages]}; {len(val_batches)} '
          'validations')
    manifests = {s: os.path.join(root, f'{s}_manifest.csv')
                 for s in ('train', 'val', 'test')}
    total = dict.fromkeys(launches, 0)
    for stage, args_list, got, stage_s in stages:
        want = pipeline_want(stage, args_list, run, cfg, manifests,
                             val_batches, len(steps))
        flags = ' '.join(a for a in args_list if a.startswith('--')
                         and a not in ('--device', '--model-path',
                                       '--test-manifest'))
        check(got == want, f'full_depth_run {stage} {flags}: launches '
              f'{got} (want {want}); {stage_s} s')
        for k in total:
            total[k] += got[k]
    check(total == launches, f'the stages account for every launch of the '
          f'pipeline: {launches}')
    print('full_depth_run WER (printed, not gated: '
          f'{DATA_EPOCHS} epochs of {DATA_SPLITS[0]} utterances): '
          + ', '.join(f'{k} {result[k]["wer"]:.4f}' for k in modes
                      if k in result)
          + f'; train {result["train_wall_seconds"]} s, pipeline '
          f'{secs:.1f} s [{card}]')
    return launches['stft_mel_log'], result


def phase_data(root: str, card: str) -> dict:
    """Phase 19: the data layer and the full-depth pipeline on the card.
    Returns K1's launches by part."""
    t0 = time.time()
    secs, k1 = {}, {}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        secs[name] = round(time.time() - t, 1)
        return out
    data_root = os.path.join(root, 'flac_corpus')
    manifests, rendered = timed('corpus', write_flac_corpus, data_root,
                                card)
    timed('FLAC', phase_data_flac, rendered, card)
    k1['int16 wire'] = timed('wire', phase_data_wire, manifests, card)
    timed('cache', phase_data_cache, manifests, root, card)
    k1['resampled loader'] = timed('resample', phase_data_resample,
                                   data_root)
    k1['MFCC streams'] = timed('MFCC', phase_data_mfcc, manifests, root)
    k1['full_depth_run'], _ = timed('pipeline', phase_data_pipeline,
                                    data_root, card)
    print(f'data phase: K1 {json.dumps(k1)}; phase {time.time() - t0:.1f} '
          f's, by part {json.dumps(secs)}')
    return k1


# --------------------------------------------------------------------- QAT

QAT_BATCH = 16               # the qat_finetune CLI's default batch
# qat_forward vs offline_forward_q8, the JAX test's bars (tests/
# test_qat.py:62, 76), |d| <= atol + rtol * |want| element by element;
# QuantConv's exact sums make them the same bits. Both sides run
# infer.conv_q8_valid, so this gate holds the fake-quant, padding and clip
# code; the conv itself is phase 16's int8 card-vs-CPU checks.
QAT_Q8_ATOL, QAT_Q8_RTOL = 5e-3, 1e-3
# Every layer exempted vs offline_forward on the int8 weights: the same
# float32 convs on the same dequantized weights, the bias added apart.
QAT_F32_TOL = 1e-5
QAT_LOSS_RTOL = 1e-3         # one QAT step's loss, card vs CPU (TF32 off)
QAT_CPU_ROWS = 2             # rows of the card-vs-CPU step
QAT_OVERFIT_STEPS, QAT_OVERFIT_LR = 40, 3e-3   # test_qat.py's rule
QAT_CLI_STEPS = 10
QAT_COUNTERS = (stft_mel_log, ctc_alpha, ctc_beta)
QAT_STEP_WANT = {'stft_mel_log': 1, 'ctc_alpha': 1, 'ctc_beta': 1}


def allclose_excess(got, want, atol: float, rtol: float) -> float:
    """max(|got - want| - (atol + rtol * |want|)): <= 0 when
    ``np.allclose``'s test holds at every element."""
    return ((got - want).abs() - (atol + rtol * want.abs())).max().item()


def qat_batch(manifest: str, labels, fe, rows: int = QAT_BATCH) -> dict:
    """The first loader batch of ``rows`` corpus utterances (numpy)."""
    return next(iter(port_eval.make_loader(manifest, rows, fe, labels)))


def phase_qat_forward(layers, folded, meta, b: dict):
    """qat_forward on the card against the int8 graph on the card
    (offline_forward_q8, static and dynamic scales) and, with every layer
    exempted, against offline_forward on the int8 weights."""
    fe = artifact_frontend(meta, device=DEVICE)
    params = serving_qat.init_params(folded, DEVICE)
    q_dev = serving_infer.to_device(quantize_folded(folded), DEVICE)
    with torch.no_grad():
        feats, flens = fe(b['audio'], b['audio_lengths'])
        for what, scales in (('static', meta['act_scales']),
                             ('dynamic', None)):
            got, got_lens = serving_qat.qat_forward(
                layers, params, feats, flens, act_scales=scales)
            want, want_lens = offline_forward_q8(layers, q_dev, feats, flens,
                                                 act_scales=scales)
            excess = allclose_excess(got, want, QAT_Q8_ATOL, QAT_Q8_RTOL)
            agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
            check(torch.equal(got_lens, want_lens) and excess <= 0,
                  f'qat_forward vs offline_forward_q8 on the card ({what} '
                  f'scales, B={QAT_BATCH}, {tuple(feats.shape)}): max |d '
                  f'logp| {(got - want).abs().max().item():.3e}, within '
                  f'atol {QAT_Q8_ATOL} + rtol {QAT_Q8_RTOL} (excess '
                  f'{excess:.2e}); argmax agreement {agree:.5f}; the same '
                  f'bits: {torch.equal(got, want)}')
        exempt = tuple(range(len(layers))) + ('head',)
        got, _ = serving_qat.qat_forward(layers, params, feats, flens,
                                         f32_layers=exempt)
        want, _ = offline_forward(layers, q_dev, feats, flens)
        excess = allclose_excess(got, want, QAT_F32_TOL, QAT_F32_TOL)
        check(excess <= 0,
              f'qat_forward with every layer f32 vs offline_forward on the '
              f'int8 weights: max |d logp| '
              f'{(got - want).abs().max().item():.3e} (gate {QAT_F32_TOL} '
              f'+ {QAT_F32_TOL} |want|)')


def phase_qat_step(layers, folded, meta, batch: dict, card: str) -> dict:
    """One QAT step (``qat_finetune``, one batch, one step) with K1/K2/K3
    counted around it; the same step on the card and the CPU (loss); the
    step's time, utt/s, peak memory and busy share at B=QAT_BATCH.
    Returns the launches."""
    fe = artifact_frontend(meta, device=DEVICE)
    scales = meta['act_scales']
    for fn in QAT_COUNTERS:
        fn.launches = 0
    new, hist = serving_qat.qat_finetune(layers, folded, fe, [batch],
                                         act_scales=scales, steps=1)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in QAT_COUNTERS}
    check(launches == QAT_STEP_WANT and len(hist) == 1
          and math.isfinite(hist[0][1]),
          f'one QAT step (qat_finetune, B={QAT_BATCH}): loss '
          f'{hist[0][1]:.4f}; launches {launches} (want {QAT_STEP_WANT}: '
          'K1 in the frontend, K2 the loss, K3 its backward)')

    # The loss of a step is its forward's: the card runs the whole step,
    # the CPU (plain K1, plain CTC) the forward alone.
    rows = {k: v[:QAT_CPU_ROWS] if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}
    params = serving_qat.init_params(folded, DEVICE)
    opt = serving_qat.make_optimizer(params, 'lamb', 1e-4)
    card_loss = serving_qat.qat_step(
        layers, params, opt, fe, port_eval.to_device(rows, DEVICE),
        act_scales=scales).item()
    cpu = torch.device('cpu')
    r = port_eval.to_device(rows, cpu)
    with torch.no_grad():
        feats, flens = artifact_frontend(meta, device=cpu)(
            r['audio'], r['audio_lengths'])
        logp, lens = serving_qat.qat_forward(
            layers, serving_qat.init_params(folded, cpu), feats, flens,
            act_scales=scales)
        cpu_loss = masked_ctc_mean(logp, lens, r['targets'],
                                   r['target_lengths'],
                                   r['batch_mask']).item()
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(rel <= QAT_LOSS_RTOL,
          f'one QAT step, {QAT_CPU_ROWS} rows: loss card {card_loss:.6f} vs '
          f'CPU {cpu_loss:.6f}, rel {rel:.2e} (gate {QAT_LOSS_RTOL})')
    del params, opt

    b = port_eval.to_device(batch, DEVICE)
    params = serving_qat.init_params(folded, DEVICE)
    opt = serving_qat.make_optimizer(params, 'lamb', 1e-4)
    static = torch.tensor(scales, dtype=torch.float32, device=DEVICE)

    def step():
        return serving_qat.qat_step(layers, params, opt, fe, b,
                                    act_scales=static)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        loss = step()
    float(loss)
    per_step = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'QAT step (K1 frontend + fake-quant W2L-20 fwd/bwd + CTC K2/K3 '
          f'+ LAMB), B={QAT_BATCH}, {tuple(batch["audio"].shape)} audio: '
          f'{per_step * 1e3:.3f} ms/step, {QAT_BATCH / per_step:.1f} utt/s, '
          f'peak memory {peak:.3f} GiB [{card}]')
    profile_top(lambda: [step() for _ in range(2)], 'W2L-20, 2 QAT steps')
    return launches


def phase_qat_overfit(layers, folded, meta, batch: dict):
    """QAT_OVERFIT_STEPS LAMB steps on one repeated batch lower the CTC
    loss of the int8 graph (offline_forward_q8 over quantize_folded, static
    scales), test_qat_finetune_improves_int8_loss's rule."""
    fe = artifact_frontend(meta, device=DEVICE)
    scales = meta['act_scales']
    b = port_eval.to_device(batch, DEVICE)

    def int8_loss(fold):
        q = serving_infer.to_device(quantize_folded(fold), DEVICE)
        with torch.no_grad():
            feats, flens = fe(b['audio'], b['audio_lengths'])
            logp, lens = offline_forward_q8(layers, q, feats, flens,
                                            act_scales=scales)
            return masked_ctc_mean(logp, lens, b['targets'],
                                   b['target_lengths'],
                                   b['batch_mask']).item()
    before = int8_loss(folded)
    t0 = time.perf_counter()
    new, hist = serving_qat.qat_finetune(
        layers, folded, fe, [batch], act_scales=scales,
        steps=QAT_OVERFIT_STEPS, learning_rate=QAT_OVERFIT_LR, log_every=10)
    secs = time.perf_counter() - t0
    after = int8_loss(new)
    check(after < before and [s for s, _ in hist] == [10, 20, 30, 40],
          f'{QAT_OVERFIT_STEPS} LAMB steps (lr {QAT_OVERFIT_LR}) on one '
          f'batch: int8 graph CTC loss {before:.4f} -> {after:.4f}; QAT '
          f'loss {[round(v, 4) for _, v in hist]}; {secs:.1f} s')


def qat_eval_batches(manifest: str, labels, batch_size: int) -> int:
    """Batches of qat_finetune's int8_full evaluation of ``manifest``."""
    ds = ManifestDataset(manifest, 16000, labels)
    return len(BucketBatchLoader(ds, batch_size, 160, num_buckets=4))


def run_qat_cli(argv: list, what: str, want: dict | None = None) -> tuple:
    """``qat_finetune.main(argv)`` counted, with the fold it trained
    captured; its artifact loads and its int8 weights are, bit for bit,
    ``quantize_folded`` of that fold. Returns (report, launches, wall
    seconds)."""
    captured = []
    finetune = serving_qat.qat_finetune

    def capture(*args, **kwargs):
        out = finetune(*args, **kwargs)
        captured.append(out[0])
        return out
    serving_qat.qat_finetune = capture
    try:
        lines, _, secs, launches = run_counted(port_qat.main, argv,
                                               QAT_COUNTERS, what, want)
    finally:
        serving_qat.qat_finetune = finetune
    report = json.loads(lines[-1])
    src = argv[argv.index('--from-artifact') + 1]
    meta, folded_q, stats = load_serving(report['artifact'])
    src_meta, _, src_stats = load_serving(src)
    want_q = quantize_folded(captured[0])
    same = len(folded_q) == len(want_q) and all(
        a.dtype == c.dtype and np.array_equal(a, c)
        for g, w in zip(folded_q, want_q) for a, c in zip(g, w))
    check(same and meta['format'] == 'int8'
          and meta['act_scales'] == src_meta['act_scales']
          and all(np.array_equal(u, v) for u, v in zip(stats, src_stats))
          and all(math.isfinite(v) for _, v in report['history']),
          f'{what}: the artifact loads; its int8 weights are '
          f'quantize_folded of the trained fold bit for bit ({len(folded_q)} '
          'layers); CMVN and scales are the source\'s; the loss is finite')
    return report, launches, secs


def phase_qat(manifest: str, run_dir: str, arts: dict, root: str,
              card: str) -> dict:
    """Phase 20: QAT of the Wav2Letter-20 run's fold against its int8 +
    CMVN + static-scales artifact, at B=QAT_BATCH. Returns K1/K2/K3's
    launches on its counted paths (the one step and the CLI)."""
    t0 = time.time()
    meta, _, _ = load_serving(arts['int8'])
    layers = meta['layers']
    _, model, labels, _ = load_run(run_dir)
    folded = fold_batchnorm(model, len(layers))
    del model
    fe = artifact_frontend(meta, device=DEVICE)
    batch = qat_batch(manifest, labels, fe)
    phase_qat_forward(layers, folded, meta,
                      port_eval.to_device(batch, DEVICE))
    torch.cuda.empty_cache()
    step = phase_qat_step(layers, folded, meta, batch, card)
    torch.cuda.empty_cache()
    phase_qat_overfit(layers, folded, meta, batch)
    torch.cuda.empty_cache()
    n_eval = qat_eval_batches(manifest, labels, QAT_BATCH)
    want = {'stft_mel_log': QAT_CLI_STEPS + 2 * n_eval,
            'ctc_alpha': QAT_CLI_STEPS, 'ctc_beta': QAT_CLI_STEPS}
    out = os.path.join(root, 'artifact_qat')
    report, cli, secs = run_qat_cli([
        '--model-path', run_dir, '--from-artifact', arts['int8'],
        '--train-manifest', manifest, '--eval-manifest', manifest, '--out',
        out, '--steps', str(QAT_CLI_STEPS), '--batch-size', str(QAT_BATCH),
        '--log-every', '5', '--device', str(DEVICE)], 'qat_finetune.main',
        want)
    print(f'qat_finetune.main, {QAT_CLI_STEPS} steps at B={QAT_BATCH}: '
          f'int8_full before {report["before"]}, after {report["after"]}; '
          f'loss {report["history"]}; {secs:.1f} s end to end (WER of '
          f'6-step weights: printed, not gated) [{card}]')
    k1 = {}
    lines, _, _ = run_quiet(port_eval.main, [
        '--artifact', out, '--offline', '--int8-full',
        *serving_common(manifest)], k1, 'evaluate --artifact (QAT)',
        N_UTTS // BATCH)
    result = json.loads(lines[-1])
    check(result['weights'] == 'int8_full'
          and result['num_utterances'] == N_UTTS
          and all(math.isfinite(result[k]) for k in ('wer', 'cer')),
          f'evaluate --artifact --offline --int8-full on the QAT artifact: '
          f'{json.dumps(result)}')
    launches = {k: step[k] + cli[k] for k in step}
    print(f'QAT phase: launches {json.dumps(launches)} (one step '
          f'{json.dumps(step)}, the CLI {json.dumps(cli)}); phase '
          f'{time.time() - t0:.1f} s')
    return launches


# ------------------------------------------------------ serving tools

TOOLS_EPOCHS = 30            # the demo's epochs (validate_serving's default)
TOOLS_N_TRAIN = 400
TOOLS_QAT_STEPS = 300        # qat_finetune's default


def phase_tools(root: str, card: str) -> dict:
    """Phase 21: the serving tools on a model that trains: validate_serving
    (train_synthetic_demo, two exports, the parity rows and the WER
    matrix; exit 0), qat_finetune on the demo model (int8_full WER before
    and after, printed), build_arpa on the train split, align on the val
    split through the f32 artifact (no failure), error_analysis of an
    evaluate --dump-jsonl of the val split (its WER the eval's). Returns
    K1/K2/K3's launches of the QAT run."""
    t0 = time.time()
    out = os.path.join(root, 'serving_tools')
    dev = str(DEVICE)
    lines, err, secs, launches = run_counted(
        port_validate.main, ['--epochs', str(TOOLS_EPOCHS), '--n-train',
                             str(TOOLS_N_TRAIN), '--out', out, '--device',
                             dev], QAT_COUNTERS, 'validate_serving.main')
    report = json.loads(lines[-1])
    demo_line = [ln for ln in err.splitlines() if ln.startswith('{"demo"')]
    print(f'train_synthetic_demo ({TOOLS_EPOCHS} epochs, {TOOLS_N_TRAIN} '
          f'utterances): {demo_line[-1] if demo_line else "no result line"}')
    print(f'validate_serving parity: {json.dumps(report["parity"])}')
    for name, row in report['paths'].items():
        print(f'  {name:26s} WER {row["wer"]:.4f} CER {row["cer"]:.4f} '
              f'({row["normalization"]})')
    print(f'  same-tag checks: {json.dumps(report["same_tag_checks"])}')
    check(report['ok'] and launches['ctc_beta'] > 0
          and launches['stft_mel_log'] > 0,
          f'validate_serving: exit 0, parity and same-tag checks hold; '
          f'launches {launches}; {secs:.1f} s [{card}]')
    run = os.path.join(out, 'run')
    data = os.path.join(out, 'data')
    train, val = (os.path.join(data, f'{s}.jsonl') for s in ('train', 'val'))
    int8_art = os.path.join(out, 'artifact_int8')
    labels = load_serving(int8_art)[0]['labels']
    # qat_finetune's default batch of 16, its eval before and after
    want = {'stft_mel_log': TOOLS_QAT_STEPS
            + 2 * qat_eval_batches(val, labels, 16),
            'ctc_alpha': TOOLS_QAT_STEPS, 'ctc_beta': TOOLS_QAT_STEPS}
    qat, qat_launches, secs = run_qat_cli([
        '--model-path', run, '--from-artifact', int8_art,
        '--train-manifest', train, '--eval-manifest', val, '--out',
        os.path.join(out, 'artifact_qat'), '--steps', str(TOOLS_QAT_STEPS),
        '--device', dev], 'qat_finetune.main (demo)', want)
    print(f'QAT on the demo model ({TOOLS_QAT_STEPS} LAMB steps, lr 1e-4): '
          f'int8_full WER {qat["before"]["wer"]:.4f} -> '
          f'{qat["after"]["wer"]:.4f}, CER {qat["before"]["cer"]:.4f} -> '
          f'{qat["after"]["cer"]:.4f} (printed, not gated); loss '
          f'{qat["history"][0]} -> {qat["history"][-1]}; {secs:.1f} s '
          f'[{card}]')
    lines, _, _ = run_quiet(port_arpa.main, [
        '--manifest', train, '--out', os.path.join(out, 'lm.arpa')])
    print(f'build_arpa: {lines[-1]}')
    check(math.isfinite(json.loads(lines[-1])['train_ppl']),
          'build_arpa: a finite train-set perplexity')
    lines, _, secs = run_quiet(port_align.main, [
        '--artifact', os.path.join(out, 'artifact_f32'), '--manifest', val,
        '--out', os.path.join(out, 'align.jsonl'), '--device', dev])
    summary = json.loads(lines[-1])
    check(summary['failed'] == 0 and summary['num_utterances'] == 60,
          f'align on the val split: {json.dumps(summary)}; {secs:.2f} s')
    dump = os.path.join(out, 'val_dump.jsonl')
    lines, _, _ = run_quiet(port_eval.main, [
        '--model-path', run, '--test-manifest', val, '--dump-jsonl', dump,
        '--device', dev])
    result = json.loads(lines[-1])
    rep_path = os.path.join(out, 'errors.json')
    lines, _, _ = run_quiet(port_errors.main, [dump, '--worst', '3',
                                               '--json-out', rep_path])
    with open(rep_path) as f:
        rep = json.load(f)
    print('error_analysis: ' + '; '.join(lines[:2]))
    check(abs(rep['wer'] - result['wer']) < 1e-12
          and rep['num_utterances'] == result['num_utterances'],
          f'error_analysis WER {rep["wer"]:.6f} = evaluate\'s '
          f'{result["wer"]:.6f} over {rep["num_utterances"]} utterances')
    print(f'serving tools phase: {time.time() - t0:.1f} s')
    return qat_launches


# ------------------------------------------------------ data parallelism

DP_EPOCHS = 1                # (a) Wav2Letter-20: 2 steps under world 1
DP_QN_EPOCHS = 1             # (b) QuartzNet-15x5: 2 steps
DP_WORLD1_RTOL = 1e-6        # world 1 vs ungrouped: losses and weights
DP2_LAYERS = 4               # (c) Wav2Letter depth on two ranks
DP2_UTTS = 7                 # a global B=8: row 7 (rank 1's) is padding
DP2_BATCH = 8
DP2_STEPS = 3
DP2_LOSS_RTOL = 1e-5         # (c) 2 ranks vs 1 process on the card
DP2_PARAM_RTOL, DP2_PARAM_ATOL = 2e-4, 2e-6
DP_SERVE_UTTS = 16           # (d) MeshInference's batch
DP_LONG_MINUTES = 0.5        # (d) transcribe_long --mesh
DP_TCP_SLOTS = 4


def head_manifest(manifest: str, root: str, n: int) -> str:
    """A manifest of ``manifest``'s first ``n`` rows, under ``root``."""
    with open(manifest) as f:
        rows = f.read().splitlines()[:n]
    path = os.path.join(root, f'head{n}_manifest.jsonl')
    with open(path, 'w') as f:
        f.write('\n'.join(rows) + '\n')
    return path


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms while the block runs: two runs of
    the same training on the card otherwise differ from step 3 on (some
    of cuDNN's default weight-gradient algorithms sum in no fixed
    order)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


# Where the activations whose derivative has a branch sit: Wav2Letter's
# clamp(0, 20) on [B, C, T], Jasper's activations on [B, T, C] (the time
# dims along which a seq rank's masks are joined).
BRANCH_TIME_DIM = {'w2l': 2, 'jasper': 1}


@contextlib.contextmanager
def branch_sites(wrap):
    """Wav2Letter's clamp and Jasper's ReLU and hardtanh replaced by
    ``wrap(site, fn)`` while the block runs."""
    from wav2letter_pytorch_tpu_torch.models import jasper as jmod
    from wav2letter_pytorch_tpu_torch.models import wav2letter as wmod
    clamp, acts = wmod.hardtanh_0_20, dict(jmod._ACTIVATIONS)
    wmod.hardtanh_0_20 = wrap('w2l', clamp)
    for name in ('relu', 'hardtanh'):
        jmod._ACTIVATIONS[name] = wrap('jasper', acts[name])
    try:
        yield
    finally:
        wmod.hardtanh_0_20 = clamp
        jmod._ACTIVATIONS.update(acts)


def branched(step_fn, record=None, force=None, suffix=''):
    """``Trainer.train_step`` that, at the trainer steps ``record['steps']``
    lists, writes every branch an activation's backward takes (site, the
    pass-through mask, in call order) to ``record['path']`` + ``.step{n}``
    + ``suffix``, and at trainer step ``force['step']`` makes each
    activation's backward take the branches in ``force['path']``
    (``BranchClamp``, ``BranchRelu``): a float32 step of one process then
    takes the branches a run that rounded differently took."""
    def call(self, *args, **kw):
        step = self.step
        if record and step in record['steps']:
            masks = []

            def wrap(site, fn):
                def f(x):
                    masks.append((site, x > 0 if fn is F.relu
                                  else (x >= 0) & (x <= 20)))
                    return fn(x)
                return f
            with branch_sites(wrap):
                out = step_fn(self, *args, **kw)
            torch.save([(site, m.cpu()) for site, m in masks],
                       f'{record["path"]}.step{step}{suffix}')
            return out
        if force and step == force['step']:
            tape = torch.load(force['path'])
            given, sites = iter(tape), []

            def wrap(site, fn):
                def f(x):
                    site_given, m = next(given)
                    sites.append(site == site_given)
                    cls = BranchRelu if fn is F.relu else BranchClamp
                    return cls.apply(x, m.to(x.device, x.dtype))
                return f
            with branch_sites(wrap):
                out = step_fn(self, *args, **kw)
            check(len(sites) == len(tape) and all(sites),
                  f'forced branches at step {step}: each of the '
                  f'{len(tape)} recorded activations used once, in order, '
                  f'at its site ({sum(sites)} of {len(sites)} calls)')
            return out
        return step_fn(self, *args, **kw)
    return call


def joined_branches(prefix: str, step: int, world: int) -> str:
    """The seq ranks' records of trainer step ``step`` joined along each
    site's time dim into one process's record; returns its path."""
    ranks = [torch.load(f'{prefix}.step{step}.{r}') for r in range(world)]
    whole = [(parts[0][0], torch.cat([m for _, m in parts],
                                     BRANCH_TIME_DIM[parts[0][0]]))
             for parts in zip(*ranks)]
    path = f'{prefix}.step{step}.whole'
    torch.save(whole, path)
    return path


def train_worker(spec_path: str) -> int:
    """A training process of phases 22-24 (``chip_smoke.py
    --train-worker SPEC``, or this process): ``train.main`` on each of
    ``spec['runs']`` in turn, with cuDNN's deterministic algorithms, each
    run's kernel launches written to its ``launches`` file and, for a run
    with a ``memory`` file, the trainer's state bytes (``state_bytes``),
    each train step's ms and the peak memory of a step and of a
    checkpoint save above what was allocated when the run began written
    there; a run's ``record`` / ``force`` records or forces the branches
    of its activations at some steps (``branched``). Under torchrun's
    environment ``train.main`` joins
    the group; with ``spec['backend']`` (gloo, for two ranks on one GPU)
    this worker joins it first and records which collectives gloo takes
    on CUDA tensors as they are. A run with ``outputs`` (and a
    ``memory`` file) then writes the trained model's eval log-probs
    (``eval_outputs``)."""
    import torch.distributed as dist
    from wav2letter_pytorch_tpu_torch import parallel
    with open(spec_path) as f:
        spec = json.load(f)
    probe = {}
    if spec.get('backend'):
        dev = parallel.init_distributed(spec['device'], spec['backend'])
        for name, op in (
                ('all_reduce', lambda t: dist.all_reduce(t)),
                ('broadcast', lambda t: dist.broadcast(t, 0)),
                ('all_gather', lambda t: dist.all_gather(
                    [torch.empty_like(t) for _ in range(parallel.world())],
                    t))):
            try:
                op(torch.ones(4, device=dev))
                probe[name] = 'takes CUDA tensors'
            except (RuntimeError, ValueError) as e:
                probe[name] = f'refuses CUDA tensors: {str(e)[:120]}'
    rc = 0
    patched = {k: getattr(Trainer, k) for k in ('fit', 'train_step',
                                                '_save')}
    with cudnn_deterministic():
        for run in spec['runs']:
            for fn in TRAIN_COUNTERS:
                fn.launches = 0
            os.environ['W2L_LAUNCHES_JSON'] = run['launches']
            record = {'step_ms': [], 'step_peak': 0, 'save_peak': 0}
            trained = []
            gc.collect()   # the last run's trainer is gone before ``base``
            base = torch.cuda.memory_allocated()

            def kept_fit(self, *args, **kw):
                trained.append(self)
                return patched['fit'](self, *args, **kw)

            def timed(name, key):
                def call(self, *args, **kw):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    out = patched[name](self, *args, **kw)
                    torch.cuda.synchronize()
                    if name == 'train_step':
                        record['step_ms'].append(
                            1e3 * (time.perf_counter() - t0))
                    record[key] = max(record[key],
                                      torch.cuda.max_memory_allocated()
                                      - base)
                    return out
                return call
            if run['memory']:
                Trainer.fit = kept_fit
                Trainer.train_step = timed('train_step', 'step_peak')
                Trainer._save = timed('_save', 'save_peak')
            if run.get('record') or run.get('force'):
                Trainer.train_step = branched(
                    Trainer.train_step, run.get('record'), run.get('force'),
                    f'.{parallel.rank()}' if parallel.distributed() else '')
            try:
                rc = rc or port_train.main(run['argv'])
            finally:
                os.environ.pop('W2L_LAUNCHES_JSON')
                for k, fn in patched.items():
                    setattr(Trainer, k, fn)
            if trained:
                suffix = (f'.{parallel.rank()}' if parallel.distributed()
                          else '')
                with open(run['memory'] + suffix, 'w') as f:
                    json.dump({**state_bytes(trained[0]), **record}, f)
                if run.get('outputs'):
                    eval_outputs(trained[0], **run['outputs'])
    if parallel.distributed():
        if probe and parallel.rank() == 0:
            with open(spec['probe'], 'w') as f:
                json.dump(probe, f)
        dist.destroy_process_group()
    return rc


def state_bytes(trainer) -> dict:
    """This process's bytes of the trainer's parameters, buffers and
    optimizer state, and of its conv weights (3-d parameters) and their
    optimizer state."""
    def nbytes(t):
        return t.numel() * t.element_size()
    conv = [p for p in trainer.model.parameters() if p.dim() == 3]
    state = trainer.optimizer.state
    return {
        'params': sum(nbytes(p) for p in trainer.model.parameters()),
        'buffers': sum(nbytes(b) for b in trainer.model.buffers()),
        'optimizer': sum(nbytes(t) for st in state.values()
                         for t in st.values() if torch.is_tensor(t)),
        'conv_weights_and_state': sum(
            nbytes(p) + sum(nbytes(t) for t in state.get(p, {}).values()
                            if torch.is_tensor(t)) for p in conv)}


def summed(ranks: list) -> dict:
    """Each kernel's launches summed over ``run_workers``' ranks of one
    run."""
    total = {}
    for counts, _ in ranks:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def read_ranks(path: str, world: int, here: bool = False) -> list:
    """The JSON each rank wrote to ``path`` (suffixed ``.rank`` under a
    process group)."""
    out = []
    for r in range(world):
        with open(path if here else f'{path}.{r}') as f:
            out.append(json.load(f))
    return out


def run_workers(root: str, name: str, argvs: list, world: int = 1,
                backend: str | None = None, here: bool = False,
                record: bool = False, extras=None) -> tuple:
    """One ``train_worker`` process under ``torch.distributed.run
    --nproc-per-node 1`` (``world`` 1) running ``train.main`` on each of
    ``argvs``, or (``here``) ``train_worker`` in this process, with no
    process group, or ``world`` of them started with torchrun's
    environment (all on ``cuda:0``, over ``backend``). Returns (for each
    run, each rank's (kernel launches, its ``state_bytes`` with step ms
    and peak memory when ``record``, else None), wall seconds, gloo's
    probe or None). ``extras``: each run's further keys (``record`` /
    ``force``: ``branched``; ``outputs``: ``eval_outputs``), or None."""
    spec = os.path.join(root, f'{name}_spec.json')
    counts = [os.path.join(root, f'{name}_launches_{i}.json')
              for i in range(len(argvs))]
    memory = [os.path.join(root, f'{name}_memory_{i}.json') if record
              else None for i in range(len(argvs))]
    probe = os.path.join(root, f'{name}_probe.json')
    with open(spec, 'w') as f:
        json.dump({'runs': [{'argv': a, 'launches': c, 'memory': m, **b}
                            for a, c, m, b in zip(argvs, counts, memory,
                                                  extras or [{}] * len(
                                                      argvs))],
                   'probe': probe, 'backend': backend,
                   'device': str(DEVICE)}, f)
    me = [os.path.abspath(__file__), '--train-worker', spec]
    t0 = time.perf_counter()
    if here:
        check(train_worker(spec) == 0, f'{name}: train.main in this '
              'process returned 0')
    elif world == 1:
        launched_run([sys.executable, '-m', 'torch.distributed.run',
                      '--nproc-per-node', '1', '--master-addr', '127.0.0.1',
                      '--master-port', str(free_port())] + me,
                     dict(os.environ), f'{name}: torchrun --nproc-per-node '
                     '1, train.main')
    else:
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable] + me, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=dict(
                os.environ, RANK=str(r), LOCAL_RANK='0',
                WORLD_SIZE=str(world), MASTER_ADDR='127.0.0.1',
                MASTER_PORT=port)) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f'{name}: rank {r} rc {p.returncode}'
                  + ('' if p.returncode == 0 else '\n' + out[-4000:]))
    wall = time.perf_counter() - t0
    launches = [list(zip(read_ranks(path, world, here),
                         read_ranks(mem, world, here) if mem
                         else [None] * world))
                for path, mem in zip(counts, memory)]
    found = None
    if os.path.exists(probe):
        with open(probe) as f:
            found = json.load(f)
    return launches, wall, found


def dp_argv(manifest: str, run: str, overrides, epochs: int) -> list:
    """``epochs`` epochs of the corpus in one length bucket (B=BATCH: 2
    steps an epoch), no validation, one checkpoint at the end."""
    return [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', *overrides,
            f'data.batch_size={BATCH}', 'data.num_length_buckets=1',
            'trainer.log_every_n_steps=1', f'trainer.max_epochs={epochs}',
            'trainer.val_every_n_epochs=1000',
            f'trainer.checkpoint.every_n_epochs={epochs}',
            'trainer.string_metrics_interval=0',
            f'trainer.default_root_dir={run}', '--device', str(DEVICE)]


def no_dropout(overrides) -> list:
    """Overrides that turn dropout off in every layer of the model
    ``overrides`` name (QuartzNet's config has none)."""
    model = train_config(*overrides)['model']
    if model['name'] == 'wav2letter':
        return [f'model.layers.{i}.dropout=-1.0'
                for i in range(int(model['mid_layers']))]
    return [f'model.jasper_blocks.{i}.dropout=0.0'
            for i, b in enumerate(model['jasper_blocks']) if b.get('dropout')
            ] + (['model.dropout_default=0.0']
                 if model.get('dropout_default') else [])


def run_metrics(run_dir: str) -> dict:
    out = {}
    with open(os.path.join(run_dir, 'metrics.csv')) as f:
        for line in f.read().splitlines()[1:]:
            _, step, metric, value = line.split(',')
            out.setdefault(metric, {})[int(step)] = float(value)
    return out


def state_rel(a: dict, b: dict) -> tuple:
    """(||a - b|| / ||b|| over every floating tensor of two state dicts
    together, the largest such ratio of one tensor)."""
    num = den = worst = 0.0
    for k, v in b.items():
        if v.is_floating_point():
            d2 = float(((a[k].double() - v.double()) ** 2).sum())
            v2 = float((v.double() ** 2).sum())
            num, den = num + d2, den + v2
            worst = max(worst, math.sqrt(d2 / v2) if v2 else math.sqrt(d2))
    return math.sqrt(num / den), worst


def launched_run(cmd, env, what: str, timeout: int = 600) -> str:
    """A subprocess of this phase; its output, which must end in rc 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=os.path.dirname(
        os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=timeout)
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0, f'{what}: rc {proc.returncode} in '
          f'{time.perf_counter() - t0:.1f} s' + (
              '' if proc.returncode == 0 else '\n' + out[-4000:]))
    return out


def phase_dp_world1(manifest: str, root: str, card: str) -> list:
    """(a) Wav2Letter-20 and (b) QuartzNet-15x5: ``train.main`` ungrouped
    in this process, then both under one ``torch.distributed.run
    --nproc-per-node 1`` process (NCCL, world 1), with cuDNN's
    deterministic algorithms: losses and final weights within
    DP_WORLD1_RTOL, the same kernel launches; each run's step ms from its
    logged utterances a second (steps 2 on, host clock), and the gap.
    Returns the world-1 runs' launches."""
    cases = [('Wav2Letter-20', [f'model.mid_layers={MID_LAYERS}',
                                *no_dropout([])], DP_EPOCHS,
              TRAIN_COUNTERS[:3]),
             ('QuartzNet-15x5', [*QN, 'optimizer=novograd',
                                 *no_dropout(QN)], DP_QN_EPOCHS,
              TRAIN_COUNTERS)]
    runs = {(what, kind): os.path.join(root, f'dp_{what}_{kind}')
            for what, *_ in cases for kind in ('one', 'nccl')}
    one = {}
    with cudnn_deterministic():
        for what, over, epochs, counters in cases:
            torch.cuda.empty_cache()
            one[what] = run_counted(
                port_train.main, dp_argv(manifest, runs[what, 'one'], over,
                                         epochs), counters,
                f'train.main ({what}, ungrouped, this process)')[3]
    torch.cuda.empty_cache()
    nccl, wall, _ = run_workers(root, 'world1', [
        dp_argv(manifest, runs[what, 'nccl'], over, epochs)
        for what, over, epochs, _ in cases])
    nccl = [summed(ranks) for ranks in nccl]
    for (what, _, epochs, counters), got_n in zip(cases, nccl):
        steps = 2 * epochs
        got_n = {fn.__name__: got_n[fn.__name__] for fn in counters}
        got = run_metrics(runs[what, 'nccl'])
        want = run_metrics(runs[what, 'one'])
        losses = [(want['train_loss'][s], got['train_loss'].get(s))
                  for s in range(1, steps + 1)]
        loss_rel = max(abs(g - w) / max(abs(w), 1e-30) for w, g in losses)
        a = Checkpointer(os.path.join(runs[what, 'nccl'],
                                      'checkpoints')).restore()
        b = Checkpointer(os.path.join(runs[what, 'one'],
                                      'checkpoints')).restore()
        rel, worst = state_rel(a['model'], b['model'])
        check(a['step'] == b['step'] == steps
              and loss_rel <= DP_WORLD1_RTOL and rel <= DP_WORLD1_RTOL,
              f'{what} under torchrun, world 1 over NCCL vs ungrouped, '
              f'{steps} steps: losses {[round(w, 6) for w, _ in losses]}, '
              f'max rel {loss_rel:.2e}; weights and BN statistics rel '
              f'{rel:.2e}, worst tensor {worst:.2e} (gate '
              f'{DP_WORLD1_RTOL:g})')
        check(got_n == one[what] and all(got_n.values()),
              f'{what} world-1 launches {got_n} = the ungrouped run\'s '
              f'{one[what]}')
        ms = {k: 1e3 * BATCH / m['utterances_per_sec'][steps]
              for k, m in (('one', want), ('nccl', got))}
        print(f'{what} train step (cuDNN deterministic), B={BATCH}: '
              f'ungrouped {ms["one"]:.3f} ms, world 1 over NCCL '
              f'{ms["nccl"]:.3f} ms, gap {ms["nccl"] - ms["one"]:.3f} ms '
              f'({100 * (ms["nccl"] / ms["one"] - 1):.2f} %), steps '
              f'2-{steps} from utterances_per_sec [{card}]')
    print(f'torchrun world-1 process (both models): {wall:.1f} s wall')
    return nccl


def dp_two_ranks_argv(manifest: str, root: str) -> dict:
    """(c)'s ``train.main`` argv by side, 'one' and 'gloo'."""
    small = head_manifest(manifest, root, DP2_UTTS)
    runs = {k: os.path.join(root, f'dp2_{k}') for k in ('one', 'gloo')}
    return {k: [f'data.train_manifest={small}', f'data.val_manifest={small}',
                f'model.mid_layers={DP2_LAYERS}',
                f'data.batch_size={DP2_BATCH}', 'data.num_length_buckets=1',
                'trainer.log_every_n_steps=1',
                f'trainer.max_epochs={DP2_STEPS}',
                f'trainer.checkpoint.every_n_epochs={DP2_STEPS}',
                f'trainer.default_root_dir={r}', '--device', str(DEVICE)]
            for k, r in runs.items()}


def dp_two_ranks_launch(manifest: str, root: str) -> tuple:
    """(c)'s two gloo ranks (``run_workers``' result). A full run starts
    them in a thread beside phase 21 and waits for them before (a) and
    (b) time their steps: (c) checks equality and times nothing, and
    phase 21 prints only its tools' wall seconds (which share the host
    with them)."""
    return run_workers(root, 'dp2', [dp_two_ranks_argv(manifest,
                                                       root)['gloo']],
                       world=2, backend='gloo')


def phase_dp_two_ranks(manifest: str, root: str, card: str,
                       ranks_run=None) -> dict:
    """(c) Two ranks on the one card over gloo (``train_worker``): W2L
    with DP2_LAYERS layers at full width, global B=8 as 4 + 4 over
    DP2_UTTS utterances (rank 1's last row a masked repeat), DP2_STEPS
    steps with the config's dither and dropout, against one process (this
    one), both with cuDNN's deterministic algorithms. ``ranks_run``: the
    result of ``dp_two_ranks_launch`` run earlier, else the ranks run here
    after the one process."""
    argv = dp_two_ranks_argv(manifest, root)
    runs = {k: os.path.join(root, f'dp2_{k}') for k in ('one', 'gloo')}
    torch.cuda.empty_cache()
    with cudnn_deterministic():
        run_counted(port_train.main, argv['one'], TRAIN_COUNTERS[:3],
                    f'train.main (W2L-{DP2_LAYERS}, B={DP2_BATCH}, one '
                    'process)')
    torch.cuda.empty_cache()
    (ranks,), wall, probe = (ranks_run if ranks_run is not None
                             else dp_two_ranks_launch(manifest, root))
    launches = summed(ranks)
    check(probe is not None and all(v == 'takes CUDA tensors'
                                    for v in probe.values()),
          f'gloo on CUDA tensors, the collectives the trainer uses: {probe}')
    got, want = run_metrics(runs['gloo']), run_metrics(runs['one'])
    losses = [(want['train_loss'][s], got['train_loss'].get(s))
              for s in range(1, DP2_STEPS + 1)]
    loss_rel = max(abs(g - w) / max(abs(w), 1e-30) for w, g in losses)
    a = Checkpointer(os.path.join(runs['gloo'], 'checkpoints')).restore()
    b = Checkpointer(os.path.join(runs['one'], 'checkpoints')).restore()
    excess = max(allclose_excess(a['model'][k].double(), v.double(),
                                 DP2_PARAM_ATOL, DP2_PARAM_RTOL)
                 for k, v in b['model'].items() if v.is_floating_point())
    check(a['step'] == b['step'] == DP2_STEPS and loss_rel <= DP2_LOSS_RTOL
          and excess <= 0,
          f'W2L-{DP2_LAYERS} full width, B={DP2_BATCH} as 4 + 4 (rank 1 '
          f'holds the masked row), 2 ranks over gloo on one card vs one '
          f'process: losses {[round(w, 6) for w, _ in losses]}, max rel '
          f'{loss_rel:.2e} (gate {DP2_LOSS_RTOL:g}); weights within rtol '
          f'{DP2_PARAM_RTOL:g} atol {DP2_PARAM_ATOL:g} (worst excess '
          f'{excess:.2e}); {wall:.1f} s wall [{card}]')
    check(all(launches[fn.__name__] > 0 for fn in TRAIN_COUNTERS[:3]),
          f'K1-K3 launched on both ranks: {launches}')
    return launches


def tcp_finals(srv, utts) -> list:
    """Each of ``utts``' FINAL from ``srv``, one client at a time."""
    stop = serve_in_thread(srv)
    try:
        texts = []
        for _, a in utts:
            c = StreamClient('127.0.0.1', srv.port, timeout=300)
            piece = int(16000 * TCP_PIECE_S)
            for j in range(0, len(a), piece):
                c.send(a[j:j + piece])
            texts.append(c.finish())
    finally:
        stop()
    return texts


def phase_dp_serving(manifest: str, arts: dict, root: str,
                     card: str) -> dict:
    """(d) Serving over ``make_mesh()`` (every visible GPU; [cuda:0]
    here) and over a mesh of two entries of the one card, on which the
    row split, a launch a part, the concatenation and the per-device
    copies (a frontend copy a part; a streamer built from the artifact a
    part) all run: MeshInference f32 and int8_full and the long-form
    windows over both, ``transcribe_long --mesh`` and ``serve_tcp
    --mesh`` over ``make_mesh()``, a ``StreamingServer`` over the pair;
    each the bits of its mesh=None path. Returns K1's launches on the
    mesh paths."""
    from wav2letter_pytorch_tpu_torch import parallel
    from wav2letter_pytorch_tpu_torch.serving import LongFormTranscriber
    from wav2letter_pytorch_tpu_torch.serving.net import StreamingServer
    meshes = {'make_mesh()': parallel.make_mesh(),
              'pair': parallel.Mesh([DEVICE, DEVICE])}
    print(f'make_mesh(): {meshes["make_mesh()"]}; the pair: '
          f'{meshes["pair"]}')
    k1 = {}
    loaded = {'f32': load_serving(arts['f32']),
              'int8_full': load_serving(arts['int8'])}
    meta = loaded['f32'][0]
    utts = corpus_audio(manifest, meta['labels'])[:DP_SERVE_UTTS]
    T = max(len(a) for _, a in utts)
    audio = np.zeros((len(utts), T), np.float32)
    for i, (_, a) in enumerate(utts):
        audio[i, :len(a)] = a
    lens = np.array([len(a) for _, a in utts], np.int32)
    for mode, (m_meta, folded, stats) in loaded.items():
        outs = {}
        for name, m in (('none', None), *meshes.items()):
            mi = MeshInference(m_meta['layers'], folded,
                               artifact_frontend(m_meta, stats,
                                                 device=DEVICE),
                               mesh=m, mode=mode,
                               act_scales=m_meta.get('act_scales'),
                               device=DEVICE)
            stft_mel_log.launches = 0
            outs[name] = mi.logprobs(audio, lens)
            if m is None:
                continue
            what = f'MeshInference {mode} over {name}'
            k1[what] = stft_mel_log.launches
            check(all(np.array_equal(a, b) for a, b in zip(outs[name],
                                                           outs['none']))
                  and k1[what] == m.size
                  and len({id(fe) for fe, _ in mi._parts}) == m.size,
                  f'{what} = {m} (B={len(utts)}): the bits of mesh=None; '
                  f'K1 {k1[what]} launch(es), a frontend a part')
    # long form: the windows of a concatenation of the corpus
    long = np.concatenate([a for _, a in utts])[
        :int(DP_LONG_MINUTES * 60 * 16000)]
    got = {}
    for name, m in (('none', None), *meshes.items()):
        lf = LongFormTranscriber(meta['layers'], loaded['f32'][1],
                                 artifact_frontend(meta, None, device=DEVICE),
                                 port_eval.GreedyDecoder(meta['labels']),
                                 mesh=m, device=DEVICE)
        stft_mel_log.launches = 0
        got[name] = lf.logprobs(long)
        if m is None:
            continue
        k1[f'LongFormTranscriber over {name}'] = stft_mel_log.launches
        check(np.array_equal(got[name][0], got['none'][0])
              and got[name][1] == got['none'][1],
              f'long form over {name} = {m}, {len(long) / 16000:.1f} s: '
              'the bits of mesh=None')
    lines = {}
    for name, flag in (('mesh', ['--mesh']), ('none', [])):
        out, _, _ = run_quiet(port_long.main, [
            '--artifact', arts['f32'], '--concat-manifest', manifest,
            '--minutes', str(DP_LONG_MINUTES), '--device', str(DEVICE),
            *flag], k1 if name == 'mesh' else None,
            'transcribe_long ' + ' '.join(flag), 2)   # warm-up, timed
        line = json.loads(out[0])
        for key in ('wall_seconds', 'x_realtime', 'device'):
            line.pop(key)
        lines[name] = line
    check(lines['mesh'] == lines['none'],
          f'transcribe_long --mesh prints what it prints without: '
          f'{lines["mesh"]}')
    # serve_tcp --mesh: two clients' FINALs, with and without the mesh
    finals = {}
    for name, flag in (('mesh', ['--mesh']), ('none', [])):
        srv, _ = port_serve.build_server(port_serve.parse_args(
            ['--artifact', arts['f32'], '--host', '127.0.0.1', '--port', '0',
             '--slots', str(DP_TCP_SLOTS), '--chunk-frames',
             str(STREAM_CHUNK), '--device', str(DEVICE), *flag]))
        check((srv.mux.mesh is not None) == (name == 'mesh'),
              f'serve_tcp {" ".join(flag) or "(no --mesh)"}: mesh '
              f'{srv.mux.mesh}')
        stft_mel_log.launches = 0
        finals[name] = tcp_finals(srv, utts[:2])
        if name == 'mesh':
            k1['serve_tcp --mesh'] = stft_mel_log.launches
    check(finals['mesh'] == finals['none'] and all(finals['mesh']),
          f'serve_tcp --mesh: two clients\' FINALs equal the server\'s '
          f'without --mesh [{card}]')
    # a StreamingServer over the pair: a streamer built on each entry
    pair = meshes['pair']
    streamers = [streaming_from_artifact(arts['f32'],
                                         chunk_frames=STREAM_CHUNK,
                                         device=d)[0]
                 for d in pair.devices]
    srv = StreamingServer(streamers, meta['labels'], slots=DP_TCP_SLOTS,
                          host='127.0.0.1', port=0, mesh=pair)
    stft_mel_log.launches = 0
    got = tcp_finals(srv, utts[:2])
    k1['StreamingServer over pair'] = stft_mel_log.launches
    check(got == finals['none']
          and [p[0] for p in srv.mux._parts] == streamers,
          f'StreamingServer over {pair}, a streamer built on each entry: '
          f'two clients\' FINALs equal serve_tcp\'s without --mesh; K1 '
          f'{k1["StreamingServer over pair"]} launches [{card}]')
    print(f'mesh serving: K1 launches {json.dumps(k1)}')
    return k1


def phase_data_parallel(manifest: str, arts: dict, root: str,
                        card: str, two_ranks=None) -> dict:
    """Phase 22: (a) Wav2Letter-20 and (b) QuartzNet-15x5 under torchrun
    at world 1 over NCCL against ungrouped runs, (c) two ranks on the card
    over gloo against one process (``two_ranks``: the future of
    ``dp_two_ranks_launch``, done before (a) and (b) start), (d) serving
    over ``make_mesh()``. Returns each kernel's launches on the
    data-parallel paths."""
    t0 = time.time()
    ranks_run = two_ranks.result() if two_ranks is not None else None
    w2l, qn = phase_dp_world1(manifest, root, card)
    two = phase_dp_two_ranks(manifest, root, card, ranks_run)
    serve_k1 = phase_dp_serving(manifest, arts, root, card)
    launches = {fn.__name__: qn[fn.__name__] for fn in TRAIN_COUNTERS}
    for name in ('stft_mel_log', 'ctc_alpha', 'ctc_beta'):
        launches[name] += w2l[name] + two[name]
    launches['stft_mel_log'] += sum(serve_k1.values())
    print(f'data-parallel phase: {time.time() - t0:.1f} s; launches '
          f'{json.dumps(launches)}')
    return launches


# ---------------------------------------------------- tensor parallelism

TP_BATCH = 8                 # (a), (b): a global B=8 of ~8 s utterances
TP_W2L_STEPS = 3             # (a) Wav2Letter-20
TP_QN_STEPS = 2              # (b) QuartzNet-15x5
TP4_LAYERS = 4               # (c) Wav2Letter depth on 4 ranks
TP4_UTTS = 7                 # (c) a global B=8 as 4 + 4: row 7 is padding
TP4_STEPS = 3
TP4_CLIP = 1.0               # (c) gradient_clip_val
TP_LOSS_RTOL = 1e-5          # TP vs one process: losses
TP_PARAM_RTOL, TP_PARAM_ATOL = 2e-4, 2e-6   # JAX's TP bars: the state
                             # after the first update ((c): every update)
# An update from a state both sides share (the first, from the init; the
# last, one process resumed from the TP run's checkpoint before it),
# for each group of the state (weights, BN statistics, each optimizer
# moment): the TP run's against the one process's, relative distance
# beyond float32 rounding (``update_rel``), at most this. Sound runs read
# at most 5.3e-5 on an H100, a wrong update ~1 (skipped or doubled ~1,
# flipped ~2; the control, the run without its update, read 0.97-1.0
# and must exceed it). Not on the free-running trajectories:
# their later updates drift 1e-2 to 0.26 apart there from rounding alone.
TP_UPDATE_RTOL = 1e-3
TP_EVAL_LOGP_ATOL = 1e-4     # (c): the TP and the one-process checkpoints
                             # evaluated alike, log p apart
TP_QN_REPEAT = 2             # (b): QuartzNet's repeats a block (5 in
                             # QuartzNet-15x5), cut for the time limit
TP_STATE_SHARE = 0.55        # a rank's conv weights + their optimizer state
                             # at model=2, of the one process's


def tp_argv(manifest: str, run: str, overrides, steps: int,
            batch: int = TP_BATCH) -> list:
    """``steps`` epochs of one batch each (``manifest`` holds ``batch``
    utterances or one fewer), one length bucket, no validation, a
    checkpoint after every step."""
    return [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', *overrides,
            f'data.batch_size={batch}', 'data.num_length_buckets=1',
            'trainer.log_every_n_steps=1', f'trainer.max_epochs={steps}',
            'trainer.val_every_n_epochs=1000',
            'trainer.checkpoint.every_n_epochs=1',
            f'trainer.checkpoint.keep_last={steps}',
            'trainer.string_metrics_interval=0',
            f'trainer.default_root_dir={run}', '--device', str(DEVICE)]


def restored(run: str, step: int | None = None) -> dict:
    return Checkpointer(os.path.join(run, 'checkpoints')).restore(step)


def state_excess(a: dict, b: dict) -> tuple:
    """(worst allclose excess at the TP bars over the floating tensors of
    two state dicts, the tensor it is in)."""
    excess = {k: allclose_excess(a[k].double(), v.double(), TP_PARAM_ATOL,
                                 TP_PARAM_RTOL)
              for k, v in b.items() if v.is_floating_point()}
    worst = max(excess, key=excess.get)
    return excess[worst], worst


def state_groups(state: dict) -> dict:
    """A checkpoint's floating tensors by group, {group: {name: tensor}}:
    'weights', 'BN statistics' and each optimizer moment ('optimizer
    momentum_buffer', 'optimizer exp_avg', ...)."""
    out = {}
    for k, v in state['model'].items():
        if v.is_floating_point():
            g = ('BN statistics' if k.endswith(('running_mean',
                                                'running_var'))
                 else 'weights')
            out.setdefault(g, {})[k] = v
    for i, st in state['optimizer']['state'].items():
        for k, v in st.items():
            if torch.is_tensor(v) and v.is_floating_point():
                out.setdefault(f'optimizer {k}', {})[i] = v
    return out


def update_rel(prev_a: dict, a: dict, prev_b: dict, b: dict) -> dict:
    """For each group of ``b`` (``state_groups``), the TP run's update
    against the one process's: ||max(|(a - prev_a) - (b - prev_b)| -
    ulp(b), 0)|| / ||b - prev_b|| over the group's tensors, in float64 on
    the card. ulp(b), the float32 spacing at each stored value of ``b``,
    allows for the rounding of the last add into the two stored states
    (an SGD update at lr 1e-5 is ~100 such spacings of a weight). A group
    missing from a ``prev`` is zeros (an optimizer's state before its
    first step). Returns {group: (ratio, (the largest ratio of one
    tensor, its name))}: 0 where neither moved, inf where only ``a``
    did."""
    out = {}
    for g, tb in b.items():
        num = den = 0.0
        worst = (0.0, '')
        for k, vb in tb.items():
            def moved(prev, v):
                v = v.to(DEVICE, torch.float64)
                p = prev.get(g, {}).get(k)
                return v if p is None else v - p.to(DEVICE, torch.float64)
            ub = moved(prev_b, vb)
            x = vb.to(DEVICE, torch.float32).abs()
            ulp = torch.nextafter(x, torch.full_like(x, math.inf)) - x
            d = torch.clamp((moved(prev_a, a[g][k]) - ub).abs()
                            - ulp.double(), min=0)
            d2, u2 = float((d * d).sum()), float((ub * ub).sum())
            num, den = num + d2, den + u2
            if u2:
                worst = max(worst, (math.sqrt(d2 / u2), str(k)))
        out[g] = (math.sqrt(num / den) if den else
                  (0.0 if num == 0 else math.inf), worst)
    return out


def tp_compare(what: str, runs: dict, steps: int, one: tuple, ranks: list,
               counters, card: str, bars_to: int = 1,
               batch: int = TP_BATCH, label: str = 'TP',
               state_share: float | None = TP_STATE_SHARE,
               first: str = 'one', free_losses: bool = True) -> dict:
    """The gates of one phase-23 (``label`` TP) or phase-24 (SP) case,
    the parallel run (``runs['tp']``) against the one process's: every
    step's loss (``free_losses``; else the first step's and, against
    ``runs['resume']``, the last's); the weights and BN statistics at
    JAX's TP bars after each of the first ``bars_to`` updates and the
    first update of each optimizer moment (from the init both share),
    against ``runs[first]``; the last update of each group of the state
    (against ``runs['resume']``, one process resumed from the parallel
    run's checkpoint before it) within TP_UPDATE_RTOL, and the control
    (the parallel run without its last update) outside it; each rank's
    launches of ``counters`` equal to the one process's and, with
    ``state_share``, its conv weights and their optimizer state at most
    that share of the one process's. Prints each rank's state bytes and
    peak memory (a train step's, a checkpoint save's) beside the one
    process's, and the ms of steps 2 on of both (host clock around each
    train step, synchronised). Returns the launches summed over the
    ranks."""
    got, want = run_metrics(runs['tp']), run_metrics(runs['one'])
    refs = ([(s, want) for s in range(1, steps + 1)] if free_losses else
            [(1, want), (steps, run_metrics(runs['resume']))])
    losses = [(ref['train_loss'][s], got['train_loss'].get(s))
              for s, ref in refs]
    loss_rel = max(abs(g - w) / max(abs(w), 1e-30) for w, g in losses)
    check(loss_rel <= TP_LOSS_RTOL,
          f'{what}: {label} on {len(ranks)} ranks over gloo vs one process, '
          f'steps {[s for s, _ in refs]}: losses '
          f'{[round(w, 6) for w, _ in losses]}, max rel {loss_rel:.2e} '
          f'(gate {TP_LOSS_RTOL:g}) [{card}]')

    def updates(name, rel):
        check(all(r <= TP_UPDATE_RTOL for r, _ in rel.values()),
              f'{what}: {name}, {label} against one process, each group '
              f'within {TP_UPDATE_RTOL:g}: ' + '; '.join(
                  f'{g} {r:.3e} (worst tensor {t:.3e}, {k})'
                  for g, (r, (t, k)) in rel.items()))

    for s in range(1, bars_to + 1):
        a, b = restored(runs['tp'], s), restored(runs[first], s)
        check(a['step'] == b['step'] == s
              and a['model'].keys() == b['model'].keys(),
              f'{what}: both runs saved step {s}, the same keys')
        excess, worst = state_excess(a['model'], b['model'])
        check(excess <= 0,
              f'{what}: weights and BN statistics after step {s} within '
              f'rtol {TP_PARAM_RTOL:g} atol {TP_PARAM_ATOL:g} (worst excess '
              f'{excess:.2e}, {worst})')
        if s == 1:   # the weights' first update would need the init
            updates('update 1 of the optimizer moments', {
                g: v for g, v in update_rel({}, state_groups(a), {},
                                            state_groups(b)).items()
                if g.startswith('optimizer')})
    start = state_groups(restored(runs['tp'], steps - 1))
    a, b = restored(runs['tp']), restored(runs['resume'])
    check(a['step'] == b['step'] == steps,
          f'{what}: the {label} run and one process resumed from its step '
          f'{steps - 1} saved step {steps}')
    last = state_groups(b)
    updates(f'update {steps} from the {label} run\'s step {steps - 1}',
            update_rel(start, state_groups(a), start, last))
    control = update_rel(start, start, start, last)
    moving = {g: r for g, (r, _) in control.items()
              if any(float(v.abs().max()) for v in last[g].values())}
    check(all(r > TP_UPDATE_RTOL for r in moving.values()),
          f'{what}: control, the {label} run without its update {steps}, '
          f'each group outside {TP_UPDATE_RTOL:g}: '
          + '; '.join(f'{g} {r:.3e}' for g, r in moving.items()))
    one_counts, one_bytes = one
    names = [fn.__name__ for fn in counters]
    want_n = {k: one_counts[k] for k in names}
    for r, (counts, _) in enumerate(ranks):
        got_n = {k: counts[k] for k in names}
        check(got_n == want_n and all(got_n.values()),
              f'{what}: rank {r} launches {got_n} = the one process\'s '
              f'{want_n}')
    for r, (_, nbytes) in enumerate(ranks):
        share = (nbytes['conv_weights_and_state']
                 / one_bytes['conv_weights_and_state'])
        peak = nbytes['step_peak'] / one_bytes['step_peak']
        print(f'{what} rank {r}: {memory_line(nbytes)}; peak in a step '
              f'{peak:.3f}x the one process\'s (cuDNN\'s deterministic '
              f'algorithms) [{card}]')
        if state_share is not None:
            check(share <= state_share,
                  f'{what} rank {r}: conv weights + their optimizer state '
                  f'{share:.4f} of the one process\'s (gate {state_share})')
    print(f'{what} one process: {memory_line(one_bytes)} [{card}]')
    ms = {'one': one_bytes['step_ms'][1:],
          'tp': [max(r[1]['step_ms'][s] for r in ranks)
                 for s in range(1, steps)]}
    print(f'{what} train step, B={batch}, steps 2-{steps}: one process '
          f'{", ".join(f"{t:.3f}" for t in ms["one"])} ms, {label} over '
          f'gloo {", ".join(f"{t:.3f}" for t in ms["tp"])} ms (the slowest '
          f'rank; host clock, synchronised) [{card}]')
    total = {}
    for counts, _ in ranks:
        for k in names:
            total[k] = total.get(k, 0) + counts[k]
    return total


def memory_line(nbytes: dict) -> str:
    return (f'parameters {nbytes["params"]:,} B, buffers '
            f'{nbytes["buffers"]:,} B, optimizer state '
            f'{nbytes["optimizer"]:,} B, conv weights + their state '
            f'{nbytes["conv_weights_and_state"]:,} B; peak allocated in a '
            f'train step {nbytes["step_peak"]:,} B, in a checkpoint save '
            f'{nbytes["save_peak"]:,} B')


def tp_sep_timing(card: str) -> None:
    """K6 and K7 a launch at QuartzNet's unit shapes and B=TP_BATCH with
    the whole ``wpw`` (model=1) and with its Cout/2 columns (a model=2
    rank's)."""
    for B, T, Cin, Cout, K, d in SEP_MAIN:
        times = {}
        for cout in (Cout, Cout // 2):
            (x, wdw, wpw, g), l1, l2, p = sep_inputs(TP_BATCH, T, Cin, cout,
                                                     K, d, 7, DEVICE)
            times[cout] = (
                cuda_ms(lambda: sep_fwd(x, l1, l2, wdw, wpw, d, p)),
                cuda_ms(lambda: sep_bwd(x, l1, l2, wdw, wpw, g, d, p)))
        full, half = times[Cout], times[Cout // 2]
        print(f'K6/K7 at B={TP_BATCH}, T={T}, Cin={Cin}, K={K}, d={d}: '
              f'Cout={Cout} (model=1) {full[0]:.4f} / {full[1]:.4f} ms, '
              f'Cout={Cout // 2} (a model=2 rank) {half[0]:.4f} / '
              f'{half[1]:.4f} ms a launch [{card}]')


def full_width_cases(head8: str) -> dict:
    """Phases 23's and 24's full-width cases on the ``head8`` batch:
    {key: (what, manifest, overrides, steps)}: (a) Wav2Letter-20, (b)
    QuartzNet-15x2 with NovoGrad, dropout off in both; and each in
    model.compute_dtype=bf16 (PAR_BF16_CASES: ``a16``, ``b16``
    PAR_BF16_STEPS steps at the phases' depth, ``a16s``, ``b16s`` one step
    at the CPU tests' depth, 3 layers / 2 blocks)."""
    w2l = [f'model.mid_layers={MID_LAYERS}', *no_dropout([])]
    qn = [*QN, 'optimizer=novograd', *no_dropout(QN)] + [
        f'model.jasper_blocks.{i}.repeat={TP_QN_REPEAT}'
        for i, blk in enumerate(train_config(*QN)['model']['jasper_blocks'])
        if int(blk.get('repeat', 1)) > 1]
    bf16 = ['model.compute_dtype=bf16']
    qn_what = f'(b) QuartzNet-15x{TP_QN_REPEAT}'
    return {'a': ('(a) Wav2Letter-20', head8, w2l, TP_W2L_STEPS),
            'b': (qn_what, head8, qn, TP_QN_STEPS),
            'a16': ('(a) Wav2Letter-20 bf16', head8, w2l + bf16,
                    PAR_BF16_STEPS),
            'b16': (f'{qn_what} bf16', head8, qn + bf16, PAR_BF16_STEPS),
            'a16s': ('(a) Wav2Letter-3 bf16', head8,
                     w2l + ['model.mid_layers=3'] + bf16, 1),
            'b16s': (f'{qn_what} at 2 blocks bf16', head8,
                     qn + ['model.mid_layers=2'] + bf16, 1)}


def resume_start(src: str, dst: str, step: int, moved: bool = False):
    """``dst``'s checkpoints directory holding run ``src``'s step-``step``
    checkpoint (hard links), from which ``train.main --resume`` goes on;
    ``moved``: a copy with each floating parameter moved one float32 ulp
    toward +inf (PAR_BF16_WITNESS)."""
    src, dst = (os.path.join(r, 'checkpoints') for r in (src, dst))
    os.makedirs(dst)
    ckpt = f'ckpt_{step}.pt'
    os.link(os.path.join(src, f'meta_{step}.json'),
            os.path.join(dst, f'meta_{step}.json'))
    if not moved:
        os.link(os.path.join(src, ckpt), os.path.join(dst, ckpt))
        return
    state = torch.load(os.path.join(src, ckpt))
    state['model'] = ulp_moved(state['model'])
    torch.save(state, os.path.join(dst, ckpt))


def ulp_moved(model_state: dict) -> dict:
    """``model_state`` with each floating parameter (not the BatchNorm
    statistics) moved one float32 ulp toward +inf."""
    return {k: torch.nextafter(v, torch.full_like(v, math.inf))
            if v.is_floating_point() and not k.endswith(('running_mean',
                                                         'running_var'))
            else v for k, v in model_state.items()}


def phase_tensor_parallel(manifest: str, root: str, card: str) -> tuple:
    """Phase 23: (a) Wav2Letter-20 and (b) QuartzNet-15x2 at full width
    with trainer.mesh.model=2 on two ranks sharing the card over gloo, in
    float32 and in bf16 (``full_width_cases``), (c) Wav2Letter-4 on four
    ranks, data=2 x model=2, with a gradient clip; each through
    ``train.main`` against one process on the same global batch, all with
    cuDNN's deterministic algorithms and dropout off; (c)'s checkpoint
    loaded strict into one process and evaluated; the bf16 cases at
    ``bf16_par_compare``'s gates; K4-K7 on bf16 x at a rank's shapes.
    Returns (each kernel's launches on the float32 TP paths, summed over
    the ranks; the same on the full-depth bf16 ones; each kernel's max
    abs error at the bf16 ranks' shapes; for (a), (b) and the bf16 cases,
    the one-process run's directory and its (launches, state bytes),
    which phase 24 holds its runs against)."""
    t0 = time.time()
    head8 = head_manifest(manifest, root, TP_BATCH)
    head7 = head_manifest(manifest, root, TP4_UTTS)
    w2l4 = [f'model.mid_layers={TP4_LAYERS}', *no_dropout([]),
            f'trainer.gradient_clip_val={TP4_CLIP}']
    cases = {**full_width_cases(head8),
             'c': (f'(c) Wav2Letter-{TP4_LAYERS}, data=2 x model=2, clip '
                   f'{TP4_CLIP:g}', head7, w2l4, TP4_STEPS)}
    runs = {k: {side: os.path.join(root, f'tp_{k}_{side}')
                for side in ('one', 'tp', 'resume', 'witness')}
            for k in cases}
    grid = {k: ['trainer.mesh.data=1', 'trainer.mesh.model=2']
            for k in cases}
    grid['c'] = ['trainer.mesh.data=2', 'trainer.mesh.model=2']
    batch = bf16_batch(head8, root)

    def argv(k, side):
        _, m, over, steps = cases[k]
        return tp_argv(m, runs[k][side], over + (grid[k] if side == 'tp'
                                                 else []), steps) + (
            ['--resume'] if side in ('resume', 'witness') else [])
    two_keys = [k for k in cases if k != 'c']
    torch.cuda.empty_cache()
    # (c)'s four ranks start beside the two ranks' runs (the phase's time;
    # their steps' ms share the card and the host)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        started = pool.submit(run_workers, root, 'tp4', [argv('c', 'tp')],
                              world=4, backend='gloo', record=True)
        two, wall, probe = run_workers(
            root, 'tp2', [argv(k, 'tp') for k in two_keys], world=2,
            backend='gloo', record=True,
            extras=[bf16_extras(k, runs[k], batch) for k in two_keys])
        (four,), wall4, _ = started.result()
    ranks = {**dict(zip(two_keys, two)), 'c': four}
    check(probe is not None and all(v == 'takes CUDA tensors'
                                    for v in probe.values()),
          f'gloo on CUDA tensors, the collectives TP uses: {probe}')
    print(f'[{time.time() - t0:.1f} s] phase 23: {", ".join(two_keys)} on '
          f'2 ranks {wall:.1f} s wall, beside (c) on 4 ranks {wall4:.1f} s '
          f'wall')
    sides = prepared_sides(cases, runs, ('one',))
    torch.cuda.empty_cache()
    ones, wall, _ = run_workers(root, 'tp_one',
                                [argv(k, side) for k, side in sides],
                                here=True, record=True)
    one = {ks: r[0] for ks, r in zip(sides, ones)}
    print(f'[{time.time() - t0:.1f} s] phase 23: the one-process runs, '
          f'fresh and resumed from the TP checkpoints, {wall:.1f} s wall')
    launches = {fn.__name__: 0 for fn in TRAIN_COUNTERS}
    for k in 'abc':
        what, _, _, steps = cases[k]
        counters = TRAIN_COUNTERS if k == 'b' else TRAIN_COUNTERS[:3]
        got = tp_compare(what, runs[k], steps, one[k, 'one'], ranks[k],
                         counters, card, bars_to=steps if k == 'c' else 1)
        for name, n in got.items():
            launches[name] += n
    bf16_launches = {fn.__name__: 0 for fn in TRAIN_COUNTERS}
    for k in PAR_BF16_CASES:
        got = bf16_par_compare(cases[k], runs[k], one[k, 'one'], ranks[k],
                               card, 'TP model=2', batch)
        if k in PAR_BF16_FULL:
            for name, n in got.items():
                bf16_launches[name] += n
    # (c): the checkpoint in one process
    tp_run = runs['c']['tp']
    state = restored(tp_run)
    cfg = run_config(tp_run)
    check(cfg['trainer']['mesh'] == {'data': 2, 'seq': 1, 'model': 2},
          f'(c) run config mesh {cfg["trainer"]["mesh"]}')
    model = build_model(cfg['model'], len(build_labels(cfg['model'])))
    model.load_state_dict(state['model'], strict=True)
    result, _, _, _, _ = run_cli(['--model-path', tp_run, '--test-manifest',
                                  head7, '--device', str(DEVICE)])
    _, _, _, outs, by_hand = run_model_outputs(tp_run, head7, 1)
    _, _, _, one_outs, one_loss = run_model_outputs(runs['c']['one'],
                                                    head7, 1)
    logp_diff = max(float(np.abs(outs[k] - one_outs[k]).max())
                    for k in outs)
    loss_rel = abs(by_hand - one_loss) / abs(one_loss)
    check(result['loss'] == by_hand and loss_rel <= TP_LOSS_RTOL
          and logp_diff <= TP_EVAL_LOGP_ATOL,
          f'(c) the TP checkpoint loads strict=True into one process; '
          f'evaluate.main --model-path on the TP run (mesh 2 x 2 in its '
          f'config) gives the loss of that model evaluated by hand, bit for '
          f'bit: {result["loss"]!r} = {by_hand!r}; against the one-process '
          f'run\'s checkpoint evaluated alike: loss {one_loss!r} (rel '
          f'{loss_rel:.2e}, gate {TP_LOSS_RTOL:g}), max |log p| difference '
          f'{logp_diff:.2e} (gate {TP_EVAL_LOGP_ATOL:g})')
    tp_sep_timing(card)
    bf16_errs = bf16_rank_kernels(card, 'tp')
    print(f'tensor-parallel phase: {time.time() - t0:.1f} s; launches '
          f'{json.dumps(launches)}, bf16 {json.dumps(bf16_launches)}')
    return launches, bf16_launches, bf16_errs, {
        k: (runs[k]['one'], one[k, 'one']) for k in two_keys}


SP_GRID = ['trainer.mesh.data=1', 'trainer.mesh.seq=2']   # phase 24
SP_RANKS = 2
SP_MAIN_MAX = 404            # frames after C1 at the corpus's 808


def sp_dw_case() -> tuple:
    """K4 / K5 at phase 24's C1 shape: QuartzNet's C1 over the second
    rank's haloed half (stride 2, padding 0, zeros past the end): the
    shape (B, T, C, K, s, d) and (x, w, g)."""
    outs = sp.time_partition(SP_MAIN_MAX, SP_RANKS)[-1]
    B, T, C, K, s, d = DW_MAIN
    p = get_same_padding(K, s, d)
    wants, _ = sp.conv_wants(T, SP_RANKS, K, s, d, p, p)
    lo, hi = wants[-1]
    shape = (TP_BATCH, hi - lo, C, K, s, d)
    (x, w, g), _ = dw_inputs(*shape, 124, DEVICE)
    x[:, T - lo:] = 0.0          # past the sequence: the halo's zeros
    return shape, (x, w, g[:, :outs[1] - outs[0]].contiguous())


def sp_sep_cases():
    """K6 / K7 at phase 24's shapes: each of QuartzNet's unit shapes over
    the second rank's haloed half (padding 0, the masks' lengths shifted
    to its ranges); yields ((Cin, Cout, K, d), (x, len1, len2, wdw, wpw,
    g))."""
    for i, (_, T, Cin, Cout, K, d) in enumerate(SEP_MAIN):
        p = get_same_padding(K, 1, d)
        (lo_o, hi_o) = sp.time_partition(T, SP_RANKS)[-1]
        (x, wdw, wpw, g), l1, l2, _ = sep_inputs(
            TP_BATCH, T, Cin, Cout, K, d, 140 + i, DEVICE)
        # rank 1's haloed input: frames lo_o - p .. hi_o - p + d(K-1)
        t_in = hi_o - lo_o + d * (K - 1)
        xh = torch.zeros(TP_BATCH, t_in, Cin, device=DEVICE)
        a, b = lo_o - p, min(T, hi_o - p + d * (K - 1))
        xh[:, :b - a] = x[:, a:b]
        l1, l2 = shifted_lengths(l1, l2, a, t_in, lo_o, hi_o - lo_o)
        yield (Cin, Cout, K, d), (xh, l1, l2, wdw, wpw,
                                  g[:, lo_o:hi_o].contiguous())


def sp_kernel_checks(card: str) -> dict:
    """K1-K7 against their plain versions (and K4-K7 against the float64
    oracle) at the shapes phase 24's seq ranks give them, with phases
    1-5's gates: K1 on a rank's whole rows (B=TP_BATCH, every seq rank
    runs the frontend), K2 / K3 on the gathered log-probs, K4 / K5 on
    QuartzNet's C1 over the second rank's haloed half (stride 2, padding
    0, zeros past the end), K6 / K7 on each of QuartzNet's unit shapes
    over the second rank's haloed half (padding 0, the masks' lengths
    shifted to its ranges). Returns each kernel's max abs error."""
    errs = {}
    rng = np.random.default_rng(24)
    lens = rng.integers(LEN_LO, LEN_HI + 1, size=TP_BATCH)
    fe, padded, lens_t, nf = k1_inputs(AudioConfig(), TP_BATCH, LEN_HI,
                                       lens, 24, DEVICE)
    errs['stft_mel_log'] = k1_compare('SP rank rows', fe, padded, lens_t,
                                      nf)
    args = k2_inputs(TP_BATCH, SP_MAIN_MAX, 29, 160, 24, DEVICE, tl_lo=80,
                     ll_lo=395)
    errs['ctc_alpha'] = k2_compare('SP gathered log-probs', args)
    errs['ctc_beta'] = k3_compare('SP gathered log-probs', args)
    shape, (x, w, g) = sp_dw_case()
    s, d = shape[4:]
    got = dw_kernel(x, w, g, s, d, 0)
    plain = dw_plain(x, w, g, s, d, 0)
    oracle = dw_plain(x.double(), w.double(), g.double(), s, d, 0)
    torch.cuda.synchronize()
    r = [rel_err(a, b) for a, b in zip(got, plain)]
    o = [rel_err(a, b) for a, b in zip(got, oracle)]
    ab = [(a - b).abs().max().item() for a, b in zip(got, plain)]
    errs['depthwise_fwd'], errs['depthwise_wgrad'] = max(ab[:2]), ab[2]
    check(max(r) < SEP_DW_RTOL and max(o) < DW_ORACLE_RTOL
          and all(bool(torch.isfinite(t).all()) for t in got),
          f'K4/K5 SP C1, rank {SP_RANKS - 1}\'s haloed input {shape}, '
          f'padding 0: y, dx, dw vs plain {r[0]:.2e} {r[1]:.2e} {r[2]:.2e} '
          f'(gate {SEP_DW_RTOL}); vs float64 oracle {o[0]:.2e} {o[1]:.2e} '
          f'{o[2]:.2e} (gate {DW_ORACLE_RTOL})')
    errs['sep_fwd'] = errs['sep_bwd'] = 0.0
    for (Cin, Cout, K, d), (xh, l1, l2, wdw, wpw, g) in sp_sep_cases():
        got = (sep_fwd(xh, l1, l2, wdw, wpw, d, 0),
               *sep_bwd(xh, l1, l2, wdw, wpw, g, d, 0))
        plain = (sep_fwd_reference(xh, l1, l2, wdw, wpw, d, 0),
                 *sep_bwd_reference(xh, l1, l2, wdw, wpw, g, d, 0))
        oracle = sep_plain(xh.double(), l1, l2, wdw.double(), wpw.double(),
                           g.double(), d, 0)
        torch.cuda.synchronize()
        r = [rel_err(a, b) for a, b in zip(got, plain)]
        o = [rel_err(a, b) for a, b in zip(got, oracle)]
        ab = [(a - b).abs().max().item() for a, b in zip(got, plain)]
        errs['sep_fwd'] = max(errs['sep_fwd'], ab[0])
        errs['sep_bwd'] = max(errs['sep_bwd'], *ab[1:])
        check(max(r) < SEP_DW_RTOL and max(o) < SEP_ORACLE_RTOL
              and all(bool(torch.isfinite(t).all()) for t in got),
              f'K6/K7 SP unit (Cin, Cout, K, d)={(Cin, Cout, K, d)}, rank '
              f'{SP_RANKS - 1}\'s haloed input {tuple(xh.shape)}, padding 0, '
              f'shifted masks: y, dx, dwdw, dwpw vs plain '
              + ' '.join(f'{v:.2e}' for v in r) + f' (gate {SEP_DW_RTOL}); '
              'vs float64 oracle ' + ' '.join(f'{v:.2e}' for v in o)
              + f' (gate {SEP_ORACLE_RTOL}) [{card}]')
    return errs


def sp_launch(manifest: str, root: str) -> dict:
    """Phase 24's SP ranks: the cases of ``full_width_cases`` at SP_GRID
    on SP_RANKS ranks sharing the card over gloo, each float32 run's
    ranks recording their activations' branches at the first and last
    step (``branched``), each bf16 run's writing its trained model's eval
    log-probs (``eval_outputs``); under ``root/sp``, so that it can run
    beside phase 23. Returns what ``phase_sequence_parallel`` reads: the
    cases, the runs' directories, the branch records' prefixes, the
    batch, each run's ranks (``run_workers``), the wall seconds and
    gloo's probe."""
    t0 = time.time()
    root = os.path.join(root, 'sp')
    os.makedirs(root, exist_ok=True)
    head8 = head_manifest(manifest, root, TP_BATCH)
    cases = full_width_cases(head8)
    batch = bf16_batch(head8, root)
    runs = {k: {side: os.path.join(root, f'sp_{k}_{side}')
                for side in ('one', 'tp', 'first', 'resume', 'witness')}
            for k in cases}
    tapes = {k: os.path.join(root, f'sp_{k}_branches') for k in cases}
    ranks, wall, probe = run_workers(
        root, 'sp2', [sp_argv(cases, runs, k, 'tp') for k in cases],
        world=SP_RANKS, backend='gloo', record=True,
        extras=[bf16_extras(k, runs[k], batch) if k in PAR_BF16_CASES else
                {'record': {'path': tapes[k], 'steps': [0, steps - 1]}}
                for k, (_, _, _, steps) in cases.items()])
    print(f'[{time.time() - t0:.1f} s] phase 24: {", ".join(cases)} on '
          f'{SP_RANKS} ranks {wall:.1f} s wall')
    return dict(cases=cases, runs=runs, tapes=tapes, ranks=ranks,
                wall=wall, probe=probe, root=root, batch=batch)


def sp_argv(cases: dict, runs: dict, k: str, side: str) -> list:
    """``train.main``'s argv for case ``k``'s ``side``: 'tp' the SP run,
    'one' / 'first' one process (all steps / the first), 'resume' /
    'witness' one process resumed from the SP run's checkpoint before its
    last step (``resume_start``)."""
    _, m, over, steps = cases[k]
    return tp_argv(m, runs[k][side], over + (SP_GRID if side == 'tp'
                                             else []),
                   1 if side == 'first' else steps) + (
        ['--resume'] if side in ('resume', 'witness') else [])


def phase_sequence_parallel(manifest: str, root: str, card: str,
                            shared: dict | None = None,
                            launched: dict | None = None) -> tuple:
    """Phase 24: (a) Wav2Letter-20 and (b) QuartzNet-15x2 at full width,
    in float32 and in bf16 (``full_width_cases``), with
    trainer.mesh.seq=2 on two ranks sharing the card over gloo
    (activations sharded over time, halo-exchanged convs), against one
    process on the same head8 batch at phase 23's gates: the first step's
    loss, each rank's launches, peak memory (printed, not a gate) and
    step ms against phase 23's one-process run (``shared``; None: run
    here, as ``tools/sp_check.py`` does); the state and the optimizer
    moments after the first update against one process's first step, and
    the last update (and its loss) against one process resumed from the
    SP run's checkpoint before it.

    The SP run rounds differently from one process (each conv over its
    haloed half, BN statistics combined), and at this depth a float32
    pre-activation within rounding of a clamp(0, 20) or ReLU kink then
    takes the other branch now and then; one such unit moves a float32
    update by ~1 % through BatchNorm (phase 9). So the two one-process
    steps held to the updates take the SP run's branches, recorded by its
    ranks at those steps (``branched``), as phase 9 holds the card's step
    to a float64 step on the card's branches. All run with cuDNN's
    deterministic algorithms, as phases 22-23 do (with the default ones
    the comparisons pick up their run-to-run noise: NovoGrad's last
    second-moment update read 2.4e-4 to 1.2e-3 over six runs), whose
    workspaces at a rank's halved lengths count in its peak (up to 8.7
    GB for QuartzNet-15x2 at 404 frames against 0.39 GB with the default
    algorithms: ``tools/cudnn_workspace.py``; ``tools/sp_memory.py``
    measures SP's memory with the default ones). Also K1-K7 against
    their plain versions at the SP path's shapes. The bf16 cases are held
    at ``bf16_par_compare``'s gates, with no branches forced. Returns
    (each kernel's launches on the float32 SP runs, summed over the
    ranks; each kernel's max abs error there; the launches on the
    full-depth bf16 SP runs; each kernel's max abs error at the bf16
    ranks' shapes)."""
    t0 = time.time()
    if launched is None:
        launched = sp_launch(manifest, root)
    cases, runs, tapes = (launched[k] for k in ('cases', 'runs', 'tapes'))
    ranks, probe, root = (launched[k] for k in ('ranks', 'probe', 'root'))
    ranks = dict(zip(cases, ranks))
    torch.cuda.empty_cache()
    if shared is None:
        ones, wall, _ = run_workers(root, 'sp_one',
                                    [sp_argv(cases, runs, k, 'one')
                                     for k in cases],
                                    here=True, record=True)
        shared = {k: (runs[k]['one'], ones[i][0])
                  for i, k in enumerate(cases)}
        print(f'[{time.time() - t0:.1f} s] phase 24: the one-process runs '
              f'{wall:.1f} s wall')
    for k in cases:
        runs[k]['one'] = shared[k][0]
    check(probe is not None and all(v == 'takes CUDA tensors'
                                    for v in probe.values()),
          f'gloo on CUDA tensors, the collectives SP uses: {probe}')
    f32 = [k for k in cases if k not in PAR_BF16_CASES]
    sides = ([(k, 'first') for k in f32]
             + prepared_sides(cases, runs))
    torch.cuda.empty_cache()
    _, wall, _ = run_workers(
        root, 'sp_forced', [sp_argv(cases, runs, k, side)
                            for k, side in sides], here=True,
        extras=[{} if k in PAR_BF16_CASES else {'force': {
            'path': joined_branches(tapes[k], step, SP_RANKS), 'step': step}}
            for k, side in sides
            for step in [0 if side == 'first' else cases[k][3] - 1]])
    print(f'[{time.time() - t0:.1f} s] phase 24: one process on the SP '
          f'runs\' branches (float32), a first step and a step resumed from '
          f'the SP checkpoints, {wall:.1f} s wall')
    launches = {fn.__name__: 0 for fn in TRAIN_COUNTERS}
    for k in f32:
        what, _, _, steps = cases[k]
        counters = TRAIN_COUNTERS if k == 'b' else TRAIN_COUNTERS[:3]
        got = tp_compare(f'{what}, seq={SP_RANKS}', runs[k], steps,
                         shared[k][1], ranks[k], counters, card,
                         label='SP', state_share=None, first='first',
                         free_losses=False)
        for name, n in got.items():
            launches[name] += n
    for name, n in launches.items():
        check(n > 0, f'phase 24: {name} launched on the SP runs ({n})')
    bf16_launches = {fn.__name__: 0 for fn in TRAIN_COUNTERS}
    for k in PAR_BF16_CASES:
        got = bf16_par_compare(cases[k], runs[k], shared[k][1], ranks[k],
                               card, f'SP seq={SP_RANKS}', launched['batch'])
        if k in PAR_BF16_FULL:
            for name, n in got.items():
                bf16_launches[name] += n
    errs = sp_kernel_checks(card)
    bf16_errs = bf16_rank_kernels(card, 'sp')
    print(f'sequence-parallel phase: {time.time() - t0:.1f} s; launches '
          f'{json.dumps(launches)}, bf16 {json.dumps(bf16_launches)}')
    return launches, errs, bf16_launches, bf16_errs


# ------------------------------------------------------------ phase 25

BF16 = torch.bfloat16
BF16_STEPS = 6               # repeated-batch bf16 train steps: the loss falls
# Card vs CPU bf16 step on phase_cpu_reference's two utterances, at the
# bars tests/test_torch_bf16.py holds the port to JAX with on the CPU:
# losses, the update's relative distance (pre-BN conv biases, whose
# gradient is rounding noise, left out), the outputs.
BF16_LOSS_RTOL = 1e-3
BF16_UPDATE_RTOL = 2e-2
BF16_OUT_ATOL = 2e-2
# bf16 against f32 log-probs from the same weights on the card. bf16's
# drift from f32 grows with depth: at tests/test_bf16.py's depth (2
# layers, or 2 blocks) JAX's bar is a max of 0.15; at full depth JAX's
# own bf16 drifts from its f32 by a mean of 0.149 (Wav2Letter-20) and
# 0.766 (QuartzNet-15x5), maxima 0.81 and 4.1 (tests/test_torch_bf16.py,
# at 1/8 width), so the full-depth gate is twice that mean.
BF16_VS_F32_ATOL = 0.15
BF16_DRIFT_MEAN = {'Wav2Letter-20': 0.3, 'QuartzNet-15x5': 1.5}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bfloat16 ulps, elementwise, of two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def bf16_gate(got: torch.Tensor, ref: torch.Tensor, rtol: float) -> tuple:
    """A bf16 output against ``ref`` (the float64 oracle or the plain
    version): (its elements more than one bf16 ulp from ``ref`` rounded to
    bf16 and farther from ``ref`` than the float32 gate's rtol * max|ref|,
    the most ulps of any element). An output is its float32 sum rounded
    once; where that sum cancels to near zero, the float32 error is more
    than a bf16 ulp of the result, and the float32 gate covers it."""
    ref = ref.detach()
    ulps = bf16_ulps(got, ref.to(BF16))
    far = ((got.double() - ref.double()).abs()
           > rtol * ref.double().abs().max())
    return int(((ulps > 1) & far).sum()), int(ulps.max())


def bf16_dw_check(name: str, shape, x, w, g, s, d, p) -> tuple:
    """K4 (y, dx: bf16) and K5 (dw: float32) on the bf16 roundings of
    x, w and g against their plain versions and the float64 oracle on the
    same bf16 values. Returns the max abs errors against the plain
    version (K4, K5)."""
    x, w, g = (t.to(BF16) for t in (x, w, g))
    got = dw_kernel(x, w, g, s, d, p)
    y, dx, _ = dw_plain(x, w, g, s, d, p)
    plain = (y, dx, depthwise_wgrad_reference(x, g, w.shape[0], s, d, p))
    oracle = dw_plain(x.double(), w.double(), g.double(), s, d, p)
    torch.cuda.synchronize()
    gates = [bf16_gate(got[i], plain[i], SEP_DW_RTOL) for i in (0, 1)]
    gates += [bf16_gate(got[i], oracle[i], DW_ORACLE_RTOL) for i in (0, 1)]
    r, o = rel_err(got[2], plain[2]), rel_err(got[2], oracle[2])
    check(got[0].dtype == got[1].dtype == BF16
          and got[2].dtype == torch.float32
          and all(bad == 0 for bad, _ in gates)
          and r < SEP_DW_RTOL and o < DW_ORACLE_RTOL
          and all(bool(torch.isfinite(t).all()) for t in got),
          f'bf16 K4/K5 {name} (B,T,C,K,s,d)={shape}: y, dx (bf16) more '
          'than 1 ulp from plain / float64 oracle and past their f32 gates: '
          + ' '.join(str(bad) for bad, _ in gates) + ' (most ulps '
          + ' '.join(str(u) for _, u in gates) + f'); dw (f32) vs plain '
          f'{r:.2e} (gate {SEP_DW_RTOL}), vs oracle {o:.2e} (gate '
          f'{DW_ORACLE_RTOL})')
    ab = [(a.float() - b.float()).abs().max().item()
          for a, b in zip(got, plain)]
    return max(ab[:2]), ab[2]


def bf16_sep_check(name: str, shape, x, l1, l2, wdw, wpw, g, d, p) -> tuple:
    """K6 (y: float32) and K7 (dx: bf16; dwdw, dwpw: float32) on the bf16
    rounding of x against their plain versions and the float64 oracle on
    the same bf16 values. Returns the max abs errors against the plain
    version (K6, K7)."""
    x = x.to(BF16)
    got = (sep_fwd(x, l1, l2, wdw, wpw, d, p),
           *sep_bwd(x, l1, l2, wdw, wpw, g, d, p))
    plain = (sep_fwd_reference(x, l1, l2, wdw, wpw, d, p),
             *sep_bwd_reference(x, l1, l2, wdw, wpw, g, d, p))
    oracle = sep_plain(x.double(), l1, l2, wdw.double(), wpw.double(),
                       g.double(), d, p)
    torch.cuda.synchronize()
    gates = [bf16_gate(got[1], plain[1], SEP_DW_RTOL),
             bf16_gate(got[1], oracle[1], SEP_ORACLE_RTOL)]
    f32 = (0, 2, 3)
    r = [rel_err(got[i], plain[i]) for i in f32]
    o = [rel_err(got[i], oracle[i]) for i in f32]
    check(got[1].dtype == BF16
          and all(got[i].dtype == torch.float32 for i in f32)
          and all(bad == 0 for bad, _ in gates)
          and max(r) < SEP_DW_RTOL and max(o) < SEP_ORACLE_RTOL
          and all(bool(torch.isfinite(t).all()) for t in got),
          f'bf16 K6/K7 {name} (B,T,Cin,Cout,K,d)={shape} masks '
          f'{"off" if l1 is None else "on"}: dx (bf16) more than 1 ulp from '
          'plain / float64 oracle and past their f32 gates: '
          + ' '.join(str(bad) for bad, _ in gates) + ' (most ulps '
          + ' '.join(str(u) for _, u in gates) + '); y, dwdw, dwpw (f32) vs '
          'plain ' + ' '.join(f'{v:.2e}' for v in r) + f' (gate '
          f'{SEP_DW_RTOL}), vs oracle ' + ' '.join(f'{v:.2e}' for v in o)
          + f' (gate {SEP_ORACLE_RTOL})')
    ab = [(a.float() - b.float()).abs().max().item()
          for a, b in zip(got, plain)]
    return ab[0], max(ab[1:])


def bf16_kernel_checks(card: str) -> dict:
    """K4-K7 on bf16 x at phases 4-5's (11's) shapes and phase 24's SP
    shapes, against their plain versions and the float64 oracle; the same
    bits from two calls. Returns each kernel's max abs error against its
    plain version."""
    errs = dict.fromkeys(('depthwise_fwd', 'depthwise_wgrad', 'sep_fwd',
                          'sep_bwd'), 0.0)

    def keep(k4, k5, names=('depthwise_fwd', 'depthwise_wgrad')):
        for n, v in zip(names, (k4, k5)):
            errs[n] = max(errs[n], v)
    for i, shape in enumerate(DW_GRID + [DW_MAIN] + DW_EDGE):
        B, T, C, K, s, d = shape
        (x, w, g), p = dw_inputs(*shape, 220 + i, DEVICE)
        name = ('main path' if shape == DW_MAIN else
                'edge' if shape in DW_EDGE else f'grid{i}')
        keep(*bf16_dw_check(name, shape, x, w, g, s, d, p))
    shape, (x, w, g) = sp_dw_case()
    keep(*bf16_dw_check('SP C1', shape, x, w, g, *shape[4:], 0))
    cases = ([(sh, m) for sh in SEP_GRID for m in (True, False)]
             + [(sh, True) for sh in SEP_MAIN + SEP_EDGE + SEP_BWD_EDGE])
    sep = ('sep_fwd', 'sep_bwd')
    for i, (shape, masked) in enumerate(cases):
        (x, wdw, wpw, g), l1, l2, p = sep_inputs(*shape, 240 + i, DEVICE,
                                                 masked)
        name = ('main path' if shape in SEP_MAIN else
                'edge' if shape in SEP_EDGE else
                'K7 edge' if shape in SEP_BWD_EDGE else f'grid{i // 2}')
        keep(*bf16_sep_check(name, shape, x, l1, l2, wdw, wpw, g, shape[5],
                             p), names=sep)
    for unit, (xh, l1, l2, wdw, wpw, g) in sp_sep_cases():
        keep(*bf16_sep_check('SP unit', (TP_BATCH, xh.shape[1], *unit), xh,
                             l1, l2, wdw, wpw, g, unit[3], 0), names=sep)
    # No float atomics: two calls give the same bits.
    B, T, C, K, s, d = DW_MAIN
    (x, w, g), p = dw_inputs(*DW_MAIN, 298, DEVICE)
    x, w, g = (t.to(BF16) for t in (x, w, g))
    shape = SEP_MAIN[2]
    (xs, wdw, wpw, gs), l1, l2, ps = sep_inputs(*shape, 299, DEVICE)
    xs = xs.to(BF16)

    def calls():
        return (depthwise_fwd(x, w, s, d, p),
                depthwise_dgrad(g, w, T, s, d, p),
                depthwise_wgrad(x, g, K, s, d, p),
                sep_fwd(xs, l1, l2, wdw, wpw, shape[5], ps),
                *sep_bwd(xs, l1, l2, wdw, wpw, gs, shape[5], ps))
    first, again = calls(), calls()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f'bf16 K4, K5 at {DW_MAIN} and K6, K7 at {shape}: two calls give '
          f'the same bits [{card}]')
    return errs


def conv_flops(model, B: int, T: int) -> int:
    """Operations of the convs of one forward at B x T feature frames
    (2 a multiply-add): Wav2Letter's blocks and head, or every Jasper
    conv (depthwise, pointwise, residual, the head)."""
    total = 0
    if hasattr(model, 'conv1ds'):
        for block in model.conv1ds:
            w = block.conv1.weight
            T = block.out_time(T)
            total += 2 * B * T * w.numel()
        return total
    for block in model.jasper_encoder:
        t_block = T
        for slots in block.layout:
            for i in slots['convs']:
                conv = block.mconv[i]
                T = conv.out_time(T)
                total += 2 * B * T * conv.conv.weight.numel()
        for conv, _ in block.res:
            total += 2 * B * conv.out_time(t_block) * conv.conv.weight.numel()
    return total + 2 * B * T * model.final_layer[0].weight.numel()


def bf16_corpus_batch(manifest: str, overrides) -> dict:
    """The corpus's first training batch (B=32 of ~8 s), on the card."""
    cfg = train_config(f'data.train_manifest={manifest}',
                       f'data.val_manifest={manifest}',
                       f'data.batch_size={BATCH}', *overrides)
    loader, _ = port_train.get_data_loaders(build_labels(cfg['model']),
                                            cfg['data'])
    return port_eval.to_device(next(iter(loader)), DEVICE)


def bf16_entry_points(manifest: str, root: str, overrides, what: str):
    """train.main on a model.compute_dtype=bf16 run (1 epoch, 2 steps, a
    validation), then evaluate.main --model-path on it: both return 0, the
    losses are finite, the checkpoint holds float32 tensors only."""
    run_dir = os.path.join(root, f'bf16_run_{len(os.listdir(root))}')
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_train.main([
            f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', f'data.batch_size={BATCH}',
            *depth_overrides(overrides), *overrides,
            'model.compute_dtype=bf16', 'trainer.log_every_n_steps=1',
            'trainer.max_epochs=1', 'trainer.max_steps=2',
            f'trainer.default_root_dir={run_dir}', '--device', str(DEVICE)])
    torch.cuda.synchronize()
    losses = read_losses(run_dir)
    state = Checkpointer(os.path.join(run_dir, 'checkpoints')).restore()
    check(rc == 0 and sorted(losses) == [1, 2]
          and all(math.isfinite(v) for v in losses.values())
          and all(v.dtype in (torch.float32, torch.int64)
                  for v in state['model'].values()),
          f'train.main ({what}, compute_dtype=bf16): 2 steps, losses '
          f'{losses}, a float32 checkpoint at step {state["step"]}')
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_eval.main(['--model-path', run_dir, '--test-manifest',
                             manifest, '--device', str(DEVICE),
                             '--batch-size', str(BATCH)])
    torch.cuda.synchronize()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rc == 0 and result['num_utterances'] == N_UTTS
          and all(math.isfinite(result[k]) for k in ('loss', 'cer', 'wer')),
          f'evaluate.main --model-path on the bf16 {what} run: {result}')
    return run_dir


def bf16_drift(batch: dict, overrides) -> tuple:
    """(max, mean) |bf16 - f32| of the log-probs of ``batch``'s valid
    frames, from the same seeded weights (train mode on the batch's
    statistics, frozen; dropout off)."""
    logp = {}
    for dtype in ('bf16', 'f32'):
        extra = ['model.compute_dtype=bf16'] if dtype == 'bf16' else []
        cfg = train_config(*overrides, *extra, no_dropout=True)
        model = build_model(cfg['model'], len(build_labels(cfg['model'])),
                            seed=0).to(DEVICE)
        fe = build_frontend(cfg['model'], dither=0.0, device=DEVICE)
        model.train()
        with torch.no_grad(), frozen_statistics(model):
            logp[dtype], lens = model(*fe(batch['audio'],
                                          batch['audio_lengths']))
        del model
    valid = (torch.arange(logp['f32'].shape[1], device=DEVICE)[None, :]
             < lens[:, None])
    diff = (logp['bf16'] - logp['f32']).abs()[valid]
    torch.cuda.empty_cache()
    return float(diff.max()), float(diff.mean())


def bf16_steps(batch: dict, root: str, overrides, what: str, lr: float,
               card: str) -> dict:
    """From the same seeded weights, in bf16 then float32: AdamW train
    steps on one repeated B=32 batch (dropout and dither off); bf16's
    first BF16_STEPS must lower the loss (the counted main path). Then
    each dtype's train and eval step ms (3 steps after the warm-up), peak
    memory and conv TFLOP/s (the convs' operations over the step's
    time). Returns the bf16 launches of K4-K7 in those BF16_STEPS."""
    for dtype in ('bf16', 'f32'):
        extra = ['model.compute_dtype=bf16'] if dtype == 'bf16' else []
        cfg = train_config(*overrides, *extra, no_dropout=True)
        tr = make_trainer(cfg, os.path.join(root, f'bf16_{what}_{dtype}'),
                          DEVICE, dither=0.0,
                          optimizer=lambda p: torch.optim.AdamW(
                              p, lr=lr, weight_decay=0.0))
        model, fe = tr.model, tr.frontend
        frames = fe(batch['audio'], batch['audio_lengths'])[0].shape[1]
        if dtype == 'bf16':
            counters = (depthwise_fwd, depthwise_wgrad, sep_fwd, sep_bwd)
            for fn in counters:
                fn.bf16_launches = 0
            losses = [float(tr.train_step(batch)[0])
                      for _ in range(BF16_STEPS)]
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.bf16_launches for fn in counters}
            print(f'{what} bf16 losses, AdamW lr {lr}: '
                  + ' '.join(f'{v:.4f}' for v in losses))
            check(all(math.isfinite(v) for v in losses)
                  and losses[-1] < losses[0],
                  f'{what} trains in bf16: loss {losses[0]:.4f} -> '
                  f'{losses[-1]:.4f} over {BF16_STEPS} steps on one B={BATCH}'
                  f' batch')
        else:
            tr.train_step(batch)   # warm-up (cuDNN plans, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            loss = tr.train_step(batch)[0]
        float(loss)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        model.eval()
        port_eval.eval_step(model, fe, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            out = port_eval.eval_step(model, fe, batch)[1]
        out.cpu()
        eval_ms = (time.perf_counter() - t0) / 3 * 1e3
        eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        flops = conv_flops(model, BATCH, frames)
        print(f'{what} {dtype}: train step {step_ms:.3f} ms, peak '
              f'{train_peak:.3f} GiB, convs {3 * flops / step_ms / 1e9:.1f} '
              f'TFLOP/s over the step; eval step {eval_ms:.3f} ms, peak '
              f'{eval_peak:.3f} GiB, convs {flops / eval_ms / 1e9:.1f} '
              f'TFLOP/s over the step ({flops / 1e12:.3f} TFLOP a forward; '
              f'B={BATCH}, {tuple(batch["audio"].shape)} audio) [{card}]')
        del tr, model
        torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def activation_branches(model, branches: dict, force: bool):
    """Wav2Letter's clamps (block index -> mask of 0 <= z <= 20 on the
    BatchNorm output z) or Jasper's ReLUs (module name -> mask of input >
    0): record each one's branch into ``branches``, or with ``force`` take
    the recorded branches in the backward (the gradient passes where the
    mask says)."""
    from wav2letter_pytorch_tpu_torch.models import wav2letter as w2l
    hooks, plain_clamp = [], w2l.hardtanh_0_20
    if hasattr(model, 'conv1ds'):
        if force:
            masks = iter([branches[i] for i in sorted(branches)])
            w2l.hardtanh_0_20 = lambda x: BranchClamp.apply(
                x, next(masks).to(x.device, x.dtype))
        else:
            def record(i):
                def hook(module, inputs, z):
                    branches[i] = ((z >= 0) & (z <= 20)).cpu()
                return hook
            hooks = [blk.batch_norm.register_forward_hook(record(i))
                     for i, blk in enumerate(model.conv1ds)
                     if blk.batch_norm is not None and blk.use_activation]
    else:
        def hook_for(name):
            def hook(module, inputs, out):
                if force:
                    x = inputs[0]
                    return BranchRelu.apply(
                        x, branches[name].to(x.device, x.dtype))
                branches[name] = (inputs[0] > 0).cpu()
            return hook
        hooks = [m.register_forward_hook(hook_for(n))
                 for n, m in activations(model).items()]
    try:
        yield branches
    finally:
        w2l.hardtanh_0_20 = plain_clamp
        for h in hooks:
            h.remove()


def bf16_card_vs_cpu(root: str, overrides, train: bool = True) -> tuple:
    """One bf16 eval step and one bf16 train step (the model's optimizer;
    dither and dropout off) at full width on the card and on the CPU,
    phase_cpu_reference's two utterances, from the same weights, the CPU's
    train step on the card's clamp / ReLU branches (a pre-activation at
    0 takes either branch under another rounding, and through BatchNorm a
    flip moves the gradients of the blocks below by ~1 %; phase 8): (eval
    loss rel, outputs max abs, and with ``train`` the train losses, the
    update's relative distance over the parameters but the pre-BN conv
    biases and the branches the CPU took otherwise)."""
    cfg = train_config(*overrides, 'model.compute_dtype=bf16',
                       no_dropout=True)
    rng = np.random.default_rng(5)
    T = 16000
    audio = (0.1 * rng.standard_normal((2, T))).astype(np.float32)
    batch = dict(audio=audio, audio_lengths=np.array([T, 12000], np.int32),
                 targets=rng.integers(1, 29, (2, 16)).astype(np.int32),
                 target_lengths=np.array([16, 9], np.int32),
                 batch_mask=np.ones(2, np.float32))
    res, card_branches, flips = {}, {}, 0
    for dev in (DEVICE, torch.device('cpu')):
        tr = make_trainer(cfg, os.path.join(root, f'bf16_cpu_{dev.type}'),
                          dev, dither=0.0)
        b = port_eval.to_device(batch, dev)
        tr.model.eval()
        eloss, out, _ = port_eval.eval_step(tr.model, tr.frontend, b,
                                            output='model')
        res[dev.type] = (float(eloss), out.float().cpu())
        if not train:
            continue
        before = {k: v.detach().cpu().clone()
                  for k, v in tr.model.state_dict().items()}
        tr.model.train()
        if dev == DEVICE:
            with activation_branches(tr.model, card_branches, False):
                loss = tr.train_step(b)[0]
        else:
            own = {}
            with activation_branches(tr.model, own, False):
                with torch.no_grad():   # the CPU's own branches, counted
                    tr.model(*tr.frontend(b['audio'], b['audio_lengths']))
            flips = sum(int((own[k] != card_branches[k]).sum())
                        for k in own)
            tr.model.load_state_dict(before)   # the statistics moved
            with activation_branches(tr.model, card_branches, True):
                loss = tr.train_step(b)[0]
        after = {k: v.detach().cpu().clone()
                 for k, v in tr.model.state_dict().items()}
        res[dev.type] += (float(loss), before, after)
        del tr
    (ec, oc, *card), (er, or_, *cpu) = res[DEVICE.type], res['cpu']
    evals = (abs(ec - er) / abs(er), float((oc - or_).abs().max()))
    if not train:
        return evals
    (lc, bc, ac), (lr_, br, ar) = card, cpu
    pre_bn = {k for k in ac if k.endswith('conv1.bias')
              and k.replace('conv1.bias', 'batch_norm.weight') in ac}
    params = [k for k in ac if k.endswith(('.weight', '.bias'))
              and k not in pre_bn]
    num = sum(float(((ac[k] - bc[k] - ar[k] + br[k]).double() ** 2).sum())
              for k in params)
    den = sum(float(((ar[k] - br[k]).double() ** 2).sum()) for k in params)
    return (*evals, (lc, lr_), math.sqrt(num / den), flips)


def bf16_cpu_reference(root: str, overrides, what: str, shallow: str):
    """The card's bf16 eval and train steps against the CPU's
    (``bf16_card_vs_cpu``) at tests/test_torch_bf16.py's bars: at full
    depth the eval step's loss and outputs; the train step's loss and
    update at the depth of those tests (``shallow``, a model.mid_layers
    override). In train mode, at full depth, a bf16 conv output that
    rounds the other way on the card (another float32 summation order)
    grows through the blocks' BatchNorms as bf16's own drift from float32
    does (phase 25's drift gates; PERF.md, PR 20)."""
    erel, err = bf16_card_vs_cpu(root, overrides, train=False)
    check(erel < BF16_LOSS_RTOL and err < BF16_OUT_ATOL,
          f'{what} bf16, full width, B=2 x 1 s, card vs CPU eval step: loss '
          f'rel {erel:.2e}, outputs max {err:.2e} (gates {BF16_LOSS_RTOL}, '
          f'{BF16_OUT_ATOL})')
    erel, err, (lc, lr_), update, flips = bf16_card_vs_cpu(
        root, [*overrides, shallow])
    lrel = abs(lc - lr_) / abs(lr_)
    check(erel < BF16_LOSS_RTOL and lrel < BF16_LOSS_RTOL
          and err < BF16_OUT_ATOL and update < BF16_UPDATE_RTOL,
          f'{what} bf16 at {shallow}, full width, B=2 x 1 s, card vs CPU: '
          f'eval loss rel {erel:.2e}, outputs max {err:.2e}, train loss rel '
          f'{lrel:.2e}, update rel distance on the card\'s branches '
          f'{update:.2e} ({flips} flipped) (gates {BF16_LOSS_RTOL}, '
          f'{BF16_OUT_ATOL}, {BF16_LOSS_RTOL}, {BF16_UPDATE_RTOL})')


def phase_bf16(manifest: str, root: str, card: str) -> tuple:
    """Phase 25: model.compute_dtype=bf16. K4-K7 on bf16 x against their
    plain versions and the float64 oracle; then Wav2Letter-20 and
    QuartzNet-15x5 at full width in bf16: train.main and evaluate.main on
    a bf16 run and BF16_STEPS steps on a repeated batch (the counted main
    path: K4-K7's bf16 launches pinned), the steps' ms, memory and conv
    rates beside float32's, bf16 vs f32 log-probs, the card's bf16 steps
    against the CPU's. Returns (bf16 launches, max abs errors)."""
    errs = bf16_kernel_checks(card)
    counters = (depthwise_fwd, depthwise_wgrad, sep_fwd, sep_bwd)
    launches = dict.fromkeys((fn.__name__ for fn in counters), 0)
    for overrides, what, lr, shallow in (
            ([], 'Wav2Letter-20', OVERFIT_LR, 'model.mid_layers=3'),
            (QN + ['optimizer=novograd'], 'QuartzNet-15x5', 1e-3,
             'model.mid_layers=2')):
        for fn in counters:
            fn.bf16_launches = 0
        bf16_entry_points(manifest, root, overrides, what)
        counted = {fn.__name__: fn.bf16_launches for fn in counters}
        batch = bf16_corpus_batch(manifest, overrides)
        top, mean = bf16_drift(batch, overrides)
        check(mean < BF16_DRIFT_MEAN[what],
              f'{what} bf16 vs f32 log-probs, same weights, B={BATCH}: mean '
              f'{mean:.4f} (gate {BF16_DRIFT_MEAN[what]}), max {top:.4f}')
        # at tests/test_bf16.py's depth: 2 layers, or 2 blocks
        top, mean = bf16_drift(batch, [*overrides, 'model.mid_layers=2'])
        check(top < BF16_VS_F32_ATOL,
              f'{what} at model.mid_layers=2 (full width) bf16 vs f32 '
              f'log-probs, same weights, B={BATCH}: max {top:.4f} (gate '
              f'{BF16_VS_F32_ATOL}), mean {mean:.2e}')
        steps = bf16_steps(batch, root, overrides, what, lr, card)
        counted = {k: counted[k] + steps[k] for k in counted}
        n_batches = N_UTTS // BATCH
        # train.main: 2 steps and a validation of n_batches; evaluate.main:
        # n_batches; then BF16_STEPS steps. A QuartzNet forward launches K4
        # once and K6 QN_UNITS times, a backward K5 once and K7 QN_UNITS
        # times (the features need no gradient: no K4 input gradient).
        fwd = 2 + 2 * n_batches + BF16_STEPS
        bwd = 2 + BF16_STEPS
        want = ({'depthwise_fwd': fwd, 'depthwise_wgrad': bwd,
                 'sep_fwd': QN_UNITS * fwd, 'sep_bwd': QN_UNITS * bwd}
                if overrides else dict.fromkeys(counted, 0))
        check(counted == want,
              f'{what} bf16 path: K4-K7 bf16 launches {counted} (want '
              f'{want})')
        for k in launches:
            launches[k] += counted[k]
        bf16_cpu_reference(root, overrides, what, shallow)
        torch.cuda.empty_cache()
    return launches, errs



# ------------------------------------------- phases 23-24: bf16 cases

# (a) Wav2Letter-20 and (b) QuartzNet-15x2 of ``full_width_cases`` in
# model.compute_dtype=bf16 through ``train.main`` at model=2 (phase 23)
# and at seq=2 (phase 24) on two ranks sharing the card over gloo,
# against one process's ``train.main`` in bf16 from the same seeded
# weights on the same head8 batch. The checkpoint holds float32 only and
# loads strict=True into one process. Each step's loss from a state both
# sides share (step 1 from the init, the last from the parallel run's
# checkpoint before it) within BF16_LOSS_RTOL; the BN statistics within
# BF16_UPDATE_RTOL. At the CPU tests' depth (3 layers / 2 blocks:
# ``a16s``, ``b16s``, one step) their gates
# (tests/test_torch_bf16.py::assert_parallel_bf16): the trained model's
# eval log-probs on its grid within one bf16 ulp of its checkpoint's in
# one process, the update within BF16_UPDATE_RTOL. At full depth a
# rank's convs over half the channels or frames (other cuDNN algorithms)
# and its BN statistics sum in other orders; a float32 difference that
# moves a conv input across a bf16 rounding boundary grows about tenfold
# a normalised conv in train mode, and the ranks' partial input
# gradients are rounded to bf16 apiece (one process rounds each sum
# once). There the last update is held to a witness of rounding alone,
# one process resumed from the same checkpoint with every weight moved
# one float32 ulp (``resume_start``): within PAR_BF16_WITNESS_RATIO of
# the witness's distance (or BF16_UPDATE_RTOL, were that more) and
# nearer one process's than the control (the parallel run without that
# update, 1.0 by construction: a skipped, doubled or flipped update
# reads 1 or more). In eval mode the same other orders through
# Wav2Letter-20's 20 bf16 roundings move its log-probs apart too
# (QuartzNet's K6 units compute a column as one process does: its stay
# equal): their mean distance must be below PAR_BF16_DRIFT_SHARE of
# bf16's own from float32 on the same checkpoint.
PAR_BF16_STEPS = 2
PAR_BF16_CASES = ('a16', 'b16', 'a16s', 'b16s')
PAR_BF16_FULL = ('a16', 'b16')
PAR_BF16_WITNESS_RATIO = 2.0
PAR_BF16_DRIFT_SHARE = 0.5


def bf16_batch(head8: str, root: str) -> str:
    """The loader's batch of ``head8`` (the one batch every phase-23 and
    -24 step trains on) saved under ``root``; returns its path."""
    cfg = train_config(f'data.train_manifest={head8}',
                       f'data.val_manifest={head8}',
                       f'data.batch_size={TP_BATCH}',
                       'data.num_length_buckets=1')
    loader, _ = port_train.get_data_loaders(build_labels(cfg['model']),
                                            cfg['data'])
    batch = next(iter(loader))
    path = os.path.join(root, 'bf16_batch.pt')
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()
                if isinstance(v, np.ndarray)}, path)
    return path


def bf16_extras(k: str, sides: dict, batch: str) -> dict:
    """``run_workers``' extra keys of case ``k``'s parallel run: a bf16
    case writes its eval log-probs next to the run's directory."""
    return ({'outputs': {'batch': batch, 'path': sides['tp'] + '_logp.pt'}}
            if k in PAR_BF16_CASES else {})


def log_p(model, out: torch.Tensor) -> torch.Tensor:
    """Eval outputs as float32 log-probs (Jasper emits probabilities)."""
    if getattr(model, 'eval_emits_probs', False):
        out = torch.log(torch.clamp(out.float(), min=1e-30))
    return out.float().cpu()


def eval_outputs(tr, batch: str, path: str) -> None:
    """Trainer ``tr``'s model as it stands, on its grid, in eval mode:
    the log-probs of the batch saved at ``batch`` (``bf16_batch``), which
    the first rank writes to ``path``."""
    from wav2letter_pytorch_tpu_torch import parallel
    b = {k: v.to(DEVICE) for k, v in torch.load(batch).items()}
    tr.model.eval()
    with torch.no_grad():
        feats, flens = tr.frontend(b['audio'], b['audio_lengths'])
        out, _ = seq_forward(tr.model, feats, flens)
    if parallel.rank() == 0:
        torch.save(log_p(tr.model, out), path)


def one_process_outputs(run: str, state: dict, batch: str,
                        f32: bool = False) -> tuple:
    """Run ``run``'s model state ``state`` (its last checkpoint's)
    loaded strict=True into one process built from the run's config (its
    mesh unused): the eval-mode log-probs of the batch at ``batch`` and,
    with ``f32``, those of the same modules in float32 (their
    ``compute_dtype`` None) or None."""
    cfg = run_config(run)
    model = build_model(cfg['model'], len(build_labels(cfg['model'])))
    model.load_state_dict(state, strict=True)
    model.to(DEVICE).eval()
    fe = build_frontend(cfg['model'], dither=0.0, device=DEVICE)
    b = {k: v.to(DEVICE) for k, v in torch.load(batch).items()}
    outs = []
    with torch.no_grad(), cudnn_deterministic():
        feats = fe(b['audio'], b['audio_lengths'])
        outs.append(log_p(model, model(*feats)[0]))
        if f32:
            for m in model.modules():
                if getattr(m, 'compute_dtype', None) is not None:
                    m.compute_dtype = None
            outs.append(log_p(model, model(*feats)[0]))
    return outs[0], outs[1] if f32 else None


def seeded_init(run: str) -> dict:
    """The initial weights ``train.main`` builds for run ``run`` (its
    config's model and seed), on the CPU."""
    cfg = run_config(run)
    model = build_model(cfg['model'], len(build_labels(cfg['model'])),
                        seed=int(cfg['trainer'].get('seed', 0)))
    return model.state_dict()


def prepared_sides(cases: dict, runs: dict, fresh=()) -> list:
    """The one-process runs held against the parallel ones: [(case,
    side)] for each side in ``fresh`` of every case, then for each case
    of more than one step 'resume' and, for PAR_BF16_FULL, 'witness'
    (their start checkpoints written here, ``resume_start``)."""
    sides = [(k, side) for side in fresh for k in cases]
    for k, (_, _, _, steps) in cases.items():
        if steps > 1:
            resume_start(runs[k]['tp'], runs[k]['resume'], steps - 1)
            sides.append((k, 'resume'))
        if k in PAR_BF16_FULL:
            resume_start(runs[k]['tp'], runs[k]['witness'], steps - 1,
                         moved=True)
            sides.append((k, 'witness'))
    return sides


def within_bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: float32 ``a`` within one bf16 ulp (the spacing at the
    larger magnitude) of ``b``."""
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    return (a - b).abs() <= torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_update_rel(a: dict, b: dict, init: dict,
                    init_a: dict | None = None) -> tuple:
    """(the relative distance of ``a``'s update (from ``init_a``, else
    ``init``) to ``b``'s (from ``init``) over the weights (pre-BatchNorm
    conv biases, whose exact gradient is zero, left out), that of the BN
    statistics)."""
    init_a = init if init_a is None else init_a
    pre_bn = {k for k in b if k.endswith('conv1.bias')
              and k.replace('conv1.bias', 'batch_norm.weight') in b}
    params = [k for k in b if k.endswith(('.weight', '.bias'))
              and k not in pre_bn]
    stats = [k for k in b if k.endswith(('running_mean', 'running_var'))]

    def rel(keys, da, db):
        num = sum(float(((da[k] - db[k]).double() ** 2).sum()) for k in keys)
        den = sum(float((db[k].double() ** 2).sum()) for k in keys)
        return math.sqrt(num / den) if den else 0.0
    return (rel(params, {k: a[k] - init_a[k] for k in params},
                {k: b[k] - init[k] for k in params}),
            rel(stats, a, b))


def bf16_par_compare(case: tuple, runs: dict, one: tuple, ranks: list,
                     card: str, label: str, batch: str) -> dict:
    """One bf16 case of phase 23 or 24 (``case``: ``full_width_cases``'
    entry; ``runs``: its directories; ``one``: the one-process run's
    (launches, state bytes); ``ranks``: ``run_workers``' record of the
    parallel run) at the gates above; each rank's launches of the path's
    kernels equal to the one process's and not zero; ms and peak memory
    of a step printed beside one process's. Returns the launches summed
    over the ranks."""
    what, _, _, steps = case
    what = f'{what}, {label}'
    got, want = run_metrics(runs['tp']), run_metrics(runs['one'])
    refs = [(1, want)] + ([(steps, run_metrics(runs['resume']))]
                          if steps > 1 else [])
    losses = [(ref['train_loss'][s], got['train_loss'].get(s))
              for s, ref in refs]
    loss_rel = max(abs(g - w) / abs(w) for w, g in losses)
    final = restored(runs['tp'])['model']
    if steps > 1:
        start = restored(runs['tp'], steps - 1)['model']
        resumed = restored(runs['resume'])['model']
        update, stats = bf16_update_rel(final, resumed, start)
        witness, _ = bf16_update_rel(restored(runs['witness'])['model'],
                                     resumed, start, ulp_moved(start))
        control, _ = bf16_update_rel(start, resumed, start)
        bar = min(control, max(BF16_UPDATE_RTOL,
                               PAR_BF16_WITNESS_RATIO * witness))
        where = (f'update {steps} from the parallel run\'s step '
                 f'{steps - 1}: {update:.3e}, the witness (one process '
                 f'from that state moved one float32 ulp) {witness:.3e}, '
                 f'the control {control:.3e} (gate {bar:.3e})')
    else:
        update, stats = bf16_update_rel(
            final, restored(runs['one'])['model'], seeded_init(runs['tp']))
        bar = BF16_UPDATE_RTOL
        where = f'update 1 from the init {update:.3e} (gate {bar:g})'
    dtypes = {v.dtype for v in final.values()}
    logp = torch.load(runs['tp'] + '_logp.pt')
    ref, f32 = one_process_outputs(runs['tp'], final, batch, steps > 1)
    ok = within_bf16_ulp(logp, ref)
    apart = float((logp - ref).abs().mean())
    if steps > 1:
        drift = float((ref - f32).abs().mean())
        near = apart < PAR_BF16_DRIFT_SHARE * drift
        logp_gate = (f'mean |diff| {apart:.3e}, bf16\'s from float32 '
                     f'{drift:.3e} (gate {PAR_BF16_DRIFT_SHARE:g} of it)')
    else:
        near = bool(ok.all())
        logp_gate = f'mean |diff| {apart:.3e} (gate: none past one ulp)'
    check(dtypes <= {torch.float32, torch.int64} and near
          and loss_rel < BF16_LOSS_RTOL and stats < BF16_UPDATE_RTOL
          and update < bar,
          f'{what}, {len(ranks)} ranks over gloo, train.main vs one '
          f'process in bf16, B={TP_BATCH}: the checkpoint '
          f'({sorted(map(str, dtypes))}) loads strict=True into one '
          f'process, whose eval log-probs are {int((~ok).sum())} of '
          f'{ok.numel()} more than one bf16 ulp from the trained model\'s '
          f'on its grid (max |diff| {float((logp - ref).abs().max()):.3e}, '
          f'{logp_gate}); losses at steps '
          f'{[s for s, _ in refs]} rel {loss_rel:.2e} (gate '
          f'{BF16_LOSS_RTOL}); BN statistics {stats:.3e} (gate '
          f'{BF16_UPDATE_RTOL}); {where} [{card}]')
    one_counts, one_bytes = one
    names = [fn.__name__ for fn in (TRAIN_COUNTERS if 'QuartzNet' in what
                                    else TRAIN_COUNTERS[:3])]
    want_n = {k: one_counts[k] for k in names}
    total = dict.fromkeys(names, 0)
    for r, (counts, _) in enumerate(ranks):
        have = {k: counts[k] for k in names}
        check(have == want_n and all(have.values()),
              f'{what}: rank {r} launches {have} = the one process\'s '
              f'{want_n}')
        for k in names:
            total[k] += have[k]
    ms = [max(r[1]['step_ms'][s] for r in ranks) for s in range(steps)]
    print(f'{what}: train steps {", ".join(f"{t:.3f}" for t in ms)} ms (the '
          f'slowest rank; contended: other ranks share the card) against '
          f'one process {", ".join(f"{t:.3f}" for t in one_bytes["step_ms"])} '
          f'ms; peak allocated in a step, each rank '
          + ', '.join(f'{r[1]["step_peak"]:,} B' for r in ranks)
          + f', one process {one_bytes["step_peak"]:,} B (cuDNN\'s '
          f'deterministic algorithms) [{card}]')
    return total


def bf16_rank_kernels(card: str, which: str) -> dict:
    """K4-K7 on bf16 x at the shapes a model=2 rank (``which`` 'tp': K4 /
    K5 on QuartzNet's C1 over half its channels; K6 / K7 on the whole x
    with half of each unit's pointwise columns) or a seq=2 rank ('sp':
    phase 24's haloed halves) gives them, against their plain versions
    and the float64 oracle (``bf16_dw_check``, ``bf16_sep_check``).
    Returns each kernel's max abs error against its plain version."""
    errs = dict.fromkeys(('depthwise_fwd', 'depthwise_wgrad', 'sep_fwd',
                          'sep_bwd'), 0.0)

    def keep(pair, names):
        for n, v in zip(names, pair):
            errs[n] = max(errs[n], v)
    dw, sep = ('depthwise_fwd', 'depthwise_wgrad'), ('sep_fwd', 'sep_bwd')
    if which == 'tp':
        _, T, C, K, s, d = DW_MAIN
        shape = (TP_BATCH, T, C // 2, K, s, d)
        (x, w, g), p = dw_inputs(*shape, 320, DEVICE)
        keep(bf16_dw_check('TP rank C1', shape, x, w, g, s, d, p), dw)
        for i, (_, T, cin, cout, K, d) in enumerate(SEP_MAIN):
            shape = (TP_BATCH, T, cin, cout // 2, K, d)
            (x, wdw, wpw, g), l1, l2, p = sep_inputs(*shape, 330 + i,
                                                     DEVICE)
            keep(bf16_sep_check('TP rank unit', shape, x, l1, l2, wdw, wpw,
                                g, d, p), sep)
    else:
        shape, (x, w, g) = sp_dw_case()
        keep(bf16_dw_check('SP rank C1', shape, x, w, g, *shape[4:], 0), dw)
        for unit, (xh, l1, l2, wdw, wpw, g) in sp_sep_cases():
            keep(bf16_sep_check('SP rank unit',
                                (TP_BATCH, xh.shape[1], *unit), xh, l1, l2,
                                wdw, wpw, g, unit[3], 0), sep)
    print(f'bf16 K4-K7 at the {which.upper()} ranks\' shapes: max abs error '
          f'vs plain {json.dumps(errs)} [{card}]')
    return errs


# ------------------------------------------------------------ phase 26

KNOB_FEAT_ATOL = 1e-3        # the plain frontend vs K1's, normalised
KNOB_LOSS_RTOL = 1e-4        # the plain CTC vs K2 / K3, a step's loss
BEAM_VAL_K = 16
# Validation with each decoder by a seeded Wav2Letter-20 made peaky
# (``peaky_w2l``): its BatchNorm statistics those of a corpus batch and
# its head scaled so that its log-probs spread BEAM_VAL_SPREAD nats
# across the labels (the mean over frames), frame by frame as a trained
# model's vary. Under its initial statistics a random Wav2Letter-20's
# activations fade through the 20 layers and its log-probs are nearly
# the same at every frame and across labels (a spread of ~5e-4 nats):
# the beam then favours long strings (their alignments outnumber the
# blank path's), the host search keeps every label past the prune
# (~2-30 s an 8 s utterance) and near-ties decide between hypotheses. At
# a 4-nat spread the top two labels are ~2 nats apart, both past the
# prune, and the host search still took ~6 s an utterance on the card's
# host; at 12 one label a frame passes it.
# Over the corpus's first B=32 batch on the card (timed), and over its
# first BEAM_VAL_CPU_ROWS utterances on the card and on the CPU: the
# metrics equal, the loss within BEAM_VAL_LOSS_RTOL (float32 convs
# summed in other orders, as phase 7's card vs CPU eval).
BEAM_VAL_SPREAD = 12.0
BEAM_VAL_CPU_ROWS = 1
BEAM_VAL_LOSS_RTOL = 1e-3
BEAM_VAL_METRICS = ('val_cer', 'val_wer', 'val_len_ratio')


def knob_step(batch: dict, root: str, model, stft: str, ctc: str) -> dict:
    """One eval step and one SGD train step of a copy of ``model``
    (Wav2Letter-20, full width, dropout off) in a Trainer built from a
    config with ``model.stft_method=stft`` and ``trainer.ctc_impl=ctc``:
    the features, both losses and K1-K3's launches over the two steps."""
    cfg = train_config(f'model.stft_method={stft}',
                       f'trainer.ctc_impl={ctc}', no_dropout=True)
    model = copy.deepcopy(model).to(DEVICE)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    tr = Trainer(cfg, model, build_frontend(cfg['model'], dither=0.0,
                                            device=DEVICE),
                 opt, constant_lr(1e-3), port_eval.GreedyDecoder(
                     build_labels(cfg['model'])), device=DEVICE,
                 run_dir=os.path.join(root, f'knob_{stft}_{ctc}'))
    counters = TRAIN_COUNTERS[:3]
    for fn in counters:
        fn.launches = 0
    with torch.no_grad():
        feats, _ = tr.frontend(batch['audio'], batch['audio_lengths'])
    tr.model.eval()
    eval_loss = float(port_eval.eval_step(tr.model, tr.frontend, batch,
                                          ctc=tr.ctc)[0])
    loss = float(tr.train_step(batch)[0])
    torch.cuda.synchronize()
    out = {'feats': feats, 'eval_loss': eval_loss, 'loss': loss,
           'launches': {fn.__name__: fn.launches for fn in counters}}
    tr.close()
    del tr
    torch.cuda.empty_cache()
    return out


def phase_knobs(batch: dict, root: str, card: str) -> dict:
    """Phase 26, the kernel-selection knobs: an eval step and a train step
    of Wav2Letter-20 at full width on the corpus's first B=32 batch with
    ``model.stft_method=conv trainer.ctc_impl=scan`` (no K1, K2 or K3
    may launch), with ``pallas`` for both (each must launch: K1 once a
    step and once for the features, K2 once a step, K3 once a backward)
    and with ``auto`` (the default
    path): the plain path's features within KNOB_FEAT_ATOL and losses
    within KNOB_LOSS_RTOL of the default's, ``pallas`` the default's to
    the bit. Returns ``pallas``'s launches."""
    cfg = train_config(no_dropout=True)
    model = build_model(cfg['model'], len(build_labels(cfg['model'])))
    steps = {knob: knob_step(batch, root, model, *knob) for knob in (
        ('auto', 'auto'), ('conv', 'scan'), ('pallas', 'pallas'))}
    ref, plain = steps[('auto', 'auto')], steps[('conv', 'scan')]
    kernel = steps[('pallas', 'pallas')]
    feat = float((plain['feats'] - ref['feats']).abs().max())
    rels = [abs(plain[k] - ref[k]) / abs(ref[k]) for k in ('eval_loss',
                                                          'loss')]
    # K1: the features, the eval step, the train step; K2: both steps
    want = {'stft_mel_log': 3, 'ctc_alpha': 2, 'ctc_beta': 1}
    check(plain['launches'] == dict.fromkeys(want, 0)
          and kernel['launches'] == want == ref['launches']
          and feat < KNOB_FEAT_ATOL and max(rels) < KNOB_LOSS_RTOL
          and torch.equal(kernel['feats'], ref['feats'])
          and (kernel['eval_loss'], kernel['loss']) == (ref['eval_loss'],
                                                        ref['loss']),
          f'Wav2Letter-20 eval + train step, B={BATCH}: stft_method=conv '
          f'ctc_impl=scan launches {plain["launches"]}, features max |diff| '
          f'{feat:.2e} (gate {KNOB_FEAT_ATOL}), eval / train loss rel '
          f'{rels[0]:.2e} / {rels[1]:.2e} (gate {KNOB_LOSS_RTOL}) against '
          f'auto; pallas launches {kernel["launches"]} (want {want}), auto\'s '
          f'bits [{card}]')
    return kernel['launches']


def peaky_w2l(cfg, batch: dict) -> torch.nn.Module:
    """The seed-0 Wav2Letter of ``cfg`` on the card, its BatchNorm
    statistics ``batch``'s (one train-mode forward at momentum 1) and its
    head scaled so that its eval log-probs of ``batch`` spread
    BEAM_VAL_SPREAD nats across the labels."""
    model = build_model(cfg['model'], len(build_labels(cfg['model'])),
                        seed=0).to(DEVICE)
    fe = build_frontend(cfg['model'], dither=0.0, device=DEVICE)
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm1d)]
    momenta = [m.momentum for m in norms]
    with torch.no_grad():
        feats = fe(batch['audio'], batch['audio_lengths'])
        for m in norms:
            m.momentum = 1.0
        model.train()
        model(*feats)
        for m, v in zip(norms, momenta):
            m.momentum = v
        model.eval()
        spread = float(model(*feats)[0].std(-1).mean())
        head = model.conv1ds[-1].conv1
        head.weight.mul_(BEAM_VAL_SPREAD / spread)
        head.bias.mul_(BEAM_VAL_SPREAD / spread)
    return model


def phase_beam_validation(manifest: str, root: str, batch: dict,
                          card: str) -> dict:
    """Phase 26, validation with a beam ``model.decoder``: ``Trainer.
    validate`` of a peaky Wav2Letter-20 (``peaky_w2l`` on ``batch``) with
    the greedy decoder, the host ``PrefixBeamSearchLMDecoder``
    (k=BEAM_VAL_K, no LM) and the ``DeviceBeamDecoder`` (k=BEAM_VAL_K),
    each built by
    ``build_decoder`` from the config. Over the corpus's first B=32
    batch on the card: finite metrics, one val_loss, K1 and K2 launched,
    the host and the device search's metrics equal, each validation's ms.
    Over its first BEAM_VAL_CPU_ROWS utterances on the card and on the
    CPU (greedy and the host search; the device search op by op on the
    CPU takes ~4 s an utterance, and it is held to the host search's
    metrics there): each decoder's metrics equal (BEAM_VAL_METRICS), its
    loss within BEAM_VAL_LOSS_RTOL (the device search's against the CPU's
    host search). Returns K1's and K2's launches over the card's
    beam validations."""
    jax_name = 'wav2letter_pytorch_tpu.decoding.'
    decoders = {
        'greedy': [],
        'host beam': [f'model.decoder._target_={jax_name}'
                      'PrefixBeamSearchLMDecoder',
                      '+model.decoder.lm_path=',
                      f'+model.decoder.k={BEAM_VAL_K}'],
        'device beam': [f'model.decoder._target_={jax_name}'
                        'DeviceBeamDecoder',
                        f'+model.decoder.k={BEAM_VAL_K}']}
    heads = {BATCH: head_manifest(manifest, root, BATCH),
             BEAM_VAL_CPU_ROWS: head_manifest(manifest, root,
                                              BEAM_VAL_CPU_ROWS)}
    model = peaky_w2l(train_config(no_dropout=True), batch)
    counters = (stft_mel_log, ctc_alpha)
    launches = dict.fromkeys((fn.__name__ for fn in counters), 0)
    res = {}
    cpu = torch.device('cpu')
    for side, dev, rows in (('card', DEVICE, BATCH),
                            ('card', DEVICE, BEAM_VAL_CPU_ROWS),
                            ('cpu', cpu, BEAM_VAL_CPU_ROWS)):
        on = copy.deepcopy(model).to(dev)
        for name, over in decoders.items():
            if side == 'cpu' and name == 'device beam':
                continue
            cfg = train_config(f'data.train_manifest={heads[rows]}',
                               f'data.val_manifest={heads[rows]}',
                               f'data.batch_size={BATCH}', *over,
                               no_dropout=True)
            labels = build_labels(cfg['model'])
            dec = build_decoder(cfg['model'], labels, device=dev)
            tr = Trainer(cfg, on, build_frontend(cfg['model'], dither=0.0,
                                                 device=dev),
                         None, None, dec, device=dev,
                         run_dir=os.path.join(root, f'beam_val_{len(res)}'))
            _, val = port_train.get_data_loaders(labels, cfg['data'])
            if dev == DEVICE and rows == BATCH and not over:
                tr.validate(val)   # warm-up: cuDNN's plans for these shapes
            for fn in counters:
                fn.launches = 0
            if dev == DEVICE:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tr.validate(val)
            if dev == DEVICE:
                torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counted = {fn.__name__: fn.launches for fn in counters}
            tr.close()
            res[side, rows, name] = out
            want = over[0].rsplit('.', 1)[-1] if over else 'GreedyDecoder'
            check(all(math.isfinite(v) for v in out.values())
                  and type(dec).__name__ == want
                  and (dev == cpu or all(counted.values())),
                  f'Trainer.validate on {dev.type} with the {name} decoder '
                  f'({type(dec).__name__}), {rows} utterances of ~8 s: '
                  f'{out}, launches {counted}, {ms:.1f} ms'
                  + (f' [{card}]' if dev == DEVICE else ' (host clock)'))
            if over and dev == DEVICE:
                for k in launches:
                    launches[k] += counted[k]
            del tr
        del on
        torch.cuda.empty_cache()
    full = [res['card', BATCH, name] for name in decoders]
    check(len({v['val_loss'] for v in full}) == 1
          and all(full[1][k] == full[2][k] for k in BEAM_VAL_METRICS),
          f'B={BATCH} on the card: the three validations\' val_loss '
          f'{[v["val_loss"] for v in full]} agree; the host and the device '
          f'search\'s metrics equal: '
          + '; '.join(f'{k} {full[1][k]!r} / {full[2][k]!r}'
                      for k in BEAM_VAL_METRICS))
    for name, ref in (('greedy', 'greedy'), ('host beam', 'host beam'),
                      ('device beam', 'host beam')):
        a = res['card', BEAM_VAL_CPU_ROWS, name]
        b = res['cpu', BEAM_VAL_CPU_ROWS, ref]
        rel = abs(a['val_loss'] - b['val_loss']) / abs(b['val_loss'])
        check(all(a[k] == b[k] for k in BEAM_VAL_METRICS)
              and rel < BEAM_VAL_LOSS_RTOL,
              f'{name} validation of {BEAM_VAL_CPU_ROWS} utterances on the '
              f'card vs the {ref} one on the CPU: '
              + '; '.join(f'{k} {a[k]!r} / {b[k]!r}'
                          for k in BEAM_VAL_METRICS)
              + f'; val_loss rel {rel:.2e} (gate {BEAM_VAL_LOSS_RTOL})')
    return launches


def serving_t_out(layers, T: int) -> list:
    """Output frames of each layer (and the head) of the stack at input
    length T."""
    out = []
    for k, s, d in serving_infer._layer_geometry(layers):
        T = -(-T // s)
        out.append(T)
    return out + [T]


def kernel_entry(name, source, replaces, launches, err, numbers):
    ms, plain_ms, library_ms, nbytes, ops = numbers
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': int(launches),
            'max_abs_err': float(err), 'ms': float(ms),
            'plain_ms': float(plain_ms), 'bound_ms': float(max(t_bytes, t_ops)),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': float(library_ms)}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == '--train-worker':
        return train_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False: this needs '
              'an NVIDIA GPU', file=sys.stderr)
        return 1
    t_start = time.time()
    port_eval.resolve_device(DEVICE)  # TF32 off for the checks too
    phase_environment()
    card = card_line()

    laps = []   # (what, seconds since the start), printed again at the end

    def lap(what: str) -> None:
        torch.cuda.empty_cache()
        laps.append((what, round(time.time() - t_start, 1)))
        print(f'[{laps[-1][1]} s] {what}: done', flush=True)
    phase_build()
    k1_err, k1_main = phase_k1()
    k4_err, k5_err = phase_k4_k5()
    k6_err, k7_err = phase_k6_k7()
    lap('phases 1-5 and 11: build and kernel checks')
    with tempfile.TemporaryDirectory() as root:
        manifest, longest = write_corpus(root)
        s_main = -(-longest // 16) * 16  # the loader's target padding
        k2_err, k2_main, k2_long = phase_k2(s_main)
        k3_err = phase_k3(k2_main, k2_long)
        # Wav2Letter-20
        phase_main_path(manifest)
        phase_cpu_reference()
        phase_timing(manifest, card)
        launches, w2l_run = phase_train_main(manifest, root)
        torch.cuda.empty_cache()
        phase_train_cpu_reference(root)
        phase_overfit(root)
        torch.cuda.empty_cache()
        phase_train_timing(manifest, root, card)
        lap('phases 6-10: Wav2Letter-20 eval and training')
        # QuartzNet-15x5
        qn = dict(overrides=QN, what='QuartzNet-15x5')
        ev = phase_main_path(manifest, **qn)
        n_batches = N_UTTS // BATCH
        check(ev['depthwise_fwd'] == n_batches
              and ev['sep_fwd'] == QN_UNITS * n_batches,
              f'QuartzNet forward launches K4 once and K6 {QN_UNITS} times: '
              f'{ev["depthwise_fwd"]} and {ev["sep_fwd"]} over {n_batches} '
              'batches')
        phase_cpu_reference(**qn)
        phase_timing(manifest, card, **qn)
        qn_launches, qn_run = phase_train_main(
            manifest, root, overrides=QN + ['optimizer=novograd'],
            what='QuartzNet-15x5', kernels=tuple(
                fn.__name__ for fn in TRAIN_COUNTERS))
        torch.cuda.empty_cache()
        phase_jasper_train_cpu_reference(root, QN + ['optimizer=novograd'],
                                         'QuartzNet-15x5')
        phase_overfit(root, **qn, lr=1e-3, steps=60)
        torch.cuda.empty_cache()
        phase_train_timing(manifest, root, card,
                           overrides=QN + ['optimizer=novograd'],
                           what='QuartzNet-15x5')
        lap('phases 12-14: QuartzNet-15x5 eval and training')
        # Decoding: the training phases' runs, beam search and an LM
        lm_path = phase_lm(manifest, root)
        phase_decoding_peaky(lm_path)
        head = head_manifest(manifest, root, DECODE_CLI_UTTS)
        cli, w2l_avg2 = phase_decoding_w2l(head, w2l_run, lm_path, root,
                                           card)
        phase_decoding_qn(head, qn_run, card)
        phase_decoding_timing(manifest, w2l_avg2, lm_path, card, cli)
        del w2l_avg2
        lap('phase 15: decoding')
        # Serving: artifacts of the Wav2Letter-20 run
        serve_k1, arts = phase_serving(manifest, w2l_run, lm_path, root,
                                       card)
        lap('phase 16: serving')
        # Streaming: the Wav2Letter-20 run and its artifacts, QuartzNet's
        stream = phase_streaming(manifest, w2l_run, qn_run, arts, root, card)
        lap('phase 17: streaming')
        # Streaming QuartzNet-15x5: its run and an artifact of it
        qn_stream = phase_streaming_jasper(manifest, qn_run, root, card)
        lap('phase 18: QuartzNet streaming')
        # The data layer: a FLAC corpus, the full-depth pipeline
        data_k1 = phase_data(root, card)
        lap('phase 19: the data layer')
        # QAT of the Wav2Letter-20 run against its int8 artifact
        qat_launches = phase_qat(manifest, w2l_run, arts, root, card)
        lap('phase 20: QAT')
        # The serving tools on a model that trains; beside them phase
        # 22's two gloo ranks of (c), which time nothing
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            two_ranks = pool.submit(dp_two_ranks_launch, manifest, root)
            tools_qat = phase_tools(root, card)
            lap('phase 21: the serving tools')
            # Data parallelism: torchrun at world 1, two ranks, mesh
            # serving
            mesh_launches = phase_data_parallel(manifest, arts, root, card,
                                                two_ranks)
        lap('phase 22: data parallelism')
        # Tensor parallelism: 2 and 4 ranks sharing the card over gloo;
        # beside them phase 24's two sequence-parallel ranks, held after it
        # against phase 23's one-process runs
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            sp_ranks = pool.submit(sp_launch, manifest, root)
            tp_launches, tp_bf16, tp_bf16_errs, shared = \
                phase_tensor_parallel(manifest, root, card)
            lap('phase 23: tensor parallelism (phase 24\'s ranks beside)')
            sp_launches, sp_errs, sp_bf16, sp_bf16_errs = \
                phase_sequence_parallel(manifest, root, card, shared,
                                        sp_ranks.result())
        lap('phase 24: sequence parallelism')
        # bf16 compute: K4-K7 on bf16 x, both models trained in bf16
        bf16_launches, bf16_errs = phase_bf16(manifest, root, card)
        lap('phase 25: bf16 compute')
        # the kernel-selection knobs; validation with the beam decoders
        batch = bf16_corpus_batch(manifest, [])
        knob_launches = phase_knobs(batch, root, card)
        beam_launches = phase_beam_validation(manifest, root, batch, card)
        del batch
        lap('phase 26: the knobs and the beam validation decoders')
    k6_numbers, k7_numbers = k6_k7_numbers()
    src = 'wav2letter_pytorch_tpu_torch/csrc/'
    tpu = 'wav2letter_pytorch_tpu/ops/'
    kernels = [
        kernel_entry('stft_mel_log', src + 'stft_mel.cu',
                     tpu + 'stft_pallas.py:44',
                     launches['stft_mel_log'], k1_err,
                     k1_numbers(*k1_main)),
        kernel_entry('ctc_alpha', src + 'ctc_alpha.cu',
                     tpu + 'ctc_pallas.py:62', launches['ctc_alpha'], k2_err,
                     k2_numbers(k2_main)),
        kernel_entry('ctc_beta', src + 'ctc_beta.cu',
                     tpu + 'ctc_pallas.py:86', launches['ctc_beta'], k3_err,
                     k3_numbers(k2_main)),
        kernel_entry('depthwise_fwd', src + 'depthwise.cu',
                     tpu + 'depthwise_pallas.py:76',
                     qn_launches['depthwise_fwd'], k4_err, k4_numbers()),
        kernel_entry('depthwise_wgrad', src + 'depthwise.cu',
                     tpu + 'depthwise_pallas.py:94',
                     qn_launches['depthwise_wgrad'], k5_err, k5_numbers()),
        kernel_entry('sep_fwd', src + 'sep_conv.cu',
                     tpu + 'sep_conv_pallas.py:69', qn_launches['sep_fwd'],
                     k6_err, k6_numbers),
        kernel_entry('sep_bwd', src + 'sep_conv.cu',
                     tpu + 'sep_conv_pallas.py:93', qn_launches['sep_bwd'],
                     k7_err, k7_numbers),
    ]
    # K1's launches on the serving and streaming paths, apart from the
    # training path's; K4's on the QuartzNet lookahead and exact streams,
    # K6's on the lookahead
    kernels[0]['serving_launches'] = sum(serve_k1.values())
    kernels[0]['streaming_launches'] = sum(stream['k1'].values()) + sum(
        qn_stream['k1'].values())
    kernels[0]['data_launches'] = sum(data_k1.values())
    for entry in kernels[:3]:   # K1-K3: phase 20's and phase 21's QAT
        entry['qat_launches'] = qat_launches[entry['name']] \
            + tools_qat[entry['name']]
    kernels[0]['max_abs_err'] = max(kernels[0]['max_abs_err'],
                                    stream['k1_err'], qn_stream['k1_err'])
    kernels[3]['streaming_launches'] = stream['qn']['depthwise_fwd'] + sum(
        qn_stream['k4'].values())
    kernels[3]['max_abs_err'] = max(kernels[3]['max_abs_err'],
                                    qn_stream['k4_err'])
    kernels[5]['streaming_launches'] = stream['qn']['sep_fwd']
    for entry in kernels:       # phases 22's, 23's and 24's parallel paths
        entry['mesh_launches'] = mesh_launches[entry['name']]
        entry['tp_launches'] = tp_launches[entry['name']]
        entry['sp_launches'] = sp_launches[entry['name']]
        entry['max_abs_err'] = max(entry['max_abs_err'],
                                   sp_errs[entry['name']])
    # K4-K7 on bf16 x: their launches on phase 25's path, and a row each
    bf16_numbers = {'depthwise_fwd': k4_numbers(BF16),
                    'depthwise_wgrad': k5_numbers(BF16)}
    bf16_numbers['sep_fwd'], bf16_numbers['sep_bwd'] = k6_k7_numbers(BF16)
    for entry in kernels[3:7]:
        name = entry['name']
        entry['bf16_launches'] = bf16_launches[name]
        kernels.append(kernel_entry(
            name + '_bf16', entry['source'], entry['replaces'],
            bf16_launches[name], max(bf16_errs[name], tp_bf16_errs[name],
                                     sp_bf16_errs[name]),
            bf16_numbers[name]))
    # phases 23's and 24's bf16 cases; phase 26's knob and validation paths
    for entry in kernels[:7]:
        name = entry['name']
        entry['tp_bf16_launches'] = tp_bf16[name]
        entry['sp_bf16_launches'] = sp_bf16[name]
    for entry in kernels[:3]:
        entry['knob_launches'] = knob_launches[entry['name']]
    for entry in kernels[:2]:
        entry['beam_validation_launches'] = beam_launches[entry['name']]
    long = {}
    for name, fn in (('ctc_alpha', k2_numbers), ('ctc_beta', k3_numbers)):
        ms, _, library_ms, nbytes, ops = fn(k2_long, 'long', plain=False)
        long[name] = {'ms': ms, 'library_ms': library_ms,
                      'bound_ms': ctc_bound_ms(nbytes, ops)}
    print(json.dumps({'ctc_long_shape': list(CTC_LONG), **long}))
    print(json.dumps({'laps_s': dict(laps)}))
    print(f'total {time.time() - t_start:.1f} s [{card}]')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
