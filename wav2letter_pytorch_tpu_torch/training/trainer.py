"""The training loop (PyTorch, CUDA): train step, fit, validation.

The counterpart of ``wav2letter_pytorch_tpu.training.trainer``:

* ``trainer.ctc_impl`` picks the CTC (``CTC_IMPLS``: K2/K3 or the
  plain recursion) and ``model.decoder`` the validation's decoding
  (argmax ids on the device for a ``GreedyDecoder``, else
  ``decoder.decode`` on the outputs' probabilities);
* ``Trainer.train_step`` is ``_train_step``: the log-mel frontend with
  dither (kernel K1), optional SpecAugment/SpecCutout, the model
  (Wav2Letter, or Jasper with kernels K4-K7) in train mode (dropout,
  BatchNorm batch statistics), ``masked_ctc_mean`` (K2 forward, K3
  backward), backward, and the optimizer update;
* the random draws of step ``n`` (dither, augmentation, dropout) come
  from three generators seeded by ``np.random.SeedSequence([seed, n])``,
  the analogue of ``fold_in(rng, step)``: a resumed run replays them;
* ``trainer.gradient_clip_val`` clips the global gradient norm with
  optax's ``clip_by_global_norm`` formula and
  ``trainer.accumulate_grad_batches`` = k averages k micro-batches'
  gradients before one update (optax ``MultiSteps``): the clip applies to
  the averaged gradient, the learning-rate schedule counts updates, and
  BatchNorm statistics move on every micro-batch;
* ``fit`` runs epochs up to ``max_epochs`` / ``max_steps``, logs
  ``train_loss``, ``learning_rate`` and ``utterances_per_sec`` every
  ``log_every_n_steps`` (and at step 1), raises ``FloatingPointError`` on a
  non-finite logged loss, computes train WER/CER every
  ``string_metrics_interval`` steps from argmax ids fetched in one host
  sync per ``string_metrics_flush`` steps (with a beam ``model.decoder``,
  from the log-probs' exp, ROADMAP C.6), validates every
  ``val_every_n_epochs`` and checkpoints every ``checkpoint.every_n_epochs``
  with ``{'epoch'}``; ``resume`` replays the checkpointed epoch's shuffle;
* the preemption signal (``trainer.preempt_signal``, SIGTERM) stops at the
  next step boundary with a checkpoint carrying ``{'epoch', 'epoch_step',
  'preempted'}`` and sets ``stopped_reason = 'signal'``; ``resume`` then
  skips the batches already applied, so every batch is applied exactly
  once across the preemption.

Data parallelism (``parallel/mesh.py``): under a process group each rank
trains on its rows of every global batch (``BucketBatchLoader``'s
``row_shard``) and the update is the one-process update of the global
batch:

* each rank's masked CTC sum is divided by the global ``sum(batch_mask)``
  (a short last batch may put all its masked rows on the last ranks, so
  an average of the ranks' means would be wrong), and the gradients are
  summed over the ranks once an update, before the accumulation division
  and the clip; BatchNorm normalises with the global batch's statistics;
* the draws of dither, SpecAugment and dropout are made for the global
  batch and each rank keeps its rows (``RowGenerator``);
* parameters are broadcast from rank 0 when ``fit`` starts (after a
  resume); the logged loss, train WER/CER and validation metrics are
  reduced over the ranks; only rank 0 writes ``config.json``,
  ``metrics.csv`` and checkpoints (the others wait at a barrier);
* with more than one rank the signal is agreed: every
  ``trainer.preempt_sync_every`` steps the ranks take the max of their
  flags, so all stop at the same step with one checkpoint.

Tensor parallelism (``trainer.mesh.model`` = m > 1, ``parallel/tp.py``):
the world is ``world // m`` replicas of m ranks. The model is built whole
from the seed, as model=1 builds it, and each rank keeps its channel
shards (``tp.shard_module``); the m ranks of a replica hold the same
rows and draw alike, so "the ranks" above are the replicas: gradients
(sharded and replicated leaves alike), row counts, losses and metric sums
are reduced over the data group only (over the world, each row would
count m times). The global gradient norm of
``gradient_clip_val`` and NovoGrad's per-tensor norms add the squares of
a sharded leaf over the model group and count a replicated leaf once
(``tp.sq_sums``). Checkpoints gather every sharded leaf (parameters,
BatchNorm statistics, optimizer moments, accumulated gradients, the last
reduced over the replica group first), so rank 0 writes the model=1 layout
and any topology restores it (a restore slices).

Sequence parallelism (``trainer.mesh.seq`` = q > 1, ``parallel/sp.py``):
each replica's q ranks (its seq group) hold the same rows; the frontend
(K1) and SpecAugment run whole on each of them with the same draws, then
each keeps its range of the frames (``sp.shard_time``, JAX's
``P('data', 'seq')`` constraint) and the model computes its range of
every activation from halo-exchanged inputs. The log-probs are gathered
whole (``sp.gather_time``, JAX's reshard to ``P('data')``) before the
loss (K2/K3) and the argmax, so every seq rank computes the same loss.
Each rank's weight gradients then hold its frames' share: they are
summed over the replica group (every data and seq index of a model
index), as BatchNorm's statistics are combined over it; the row counts,
losses and metric sums stay on the data group (one rank a data index),
or each row would count q times.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import time

import numpy as np
import torch

from ..data.augmentations import build_augment_fn
from ..decoding.decoder import GreedyDecoder
from ..ops.ctc import ctc_loss
from ..ops.ctc_kernel import ctc_loss_kernel
from ..parallel import mesh, sp, tp
from ..runtime import resolve_device
from .checkpoint import Checkpointer
from .logging import MetricLogger
from .metrics import RatioAccumulator, string_sums


# ``trainer.ctc_impl``: 'pallas' (and 'auto') the kernels K2 / K3 (their
# plain versions on a CPU tensor), 'scan' the plain CTC on any device, as
# the JAX package's 'scan' runs its lax.scan recursion on a TPU too
CTC_IMPLS = {'auto': ctc_loss_kernel, 'pallas': ctc_loss_kernel,
             'scan': ctc_loss}


def masked_ctc_mean(log_probs, out_lens, targets, target_lengths,
                    batch_mask, mask_sum=None, ctc=ctc_loss_kernel):
    """torch 'mean' CTC reduction restricted to real (unmasked) rows.
    ``mask_sum``: the denominator, when the batch is a rank's rows of a
    global batch (its ``sum(batch_mask)``); this batch's own by default.
    ``ctc``: one of ``CTC_IMPLS``."""
    per = ctc(log_probs, out_lens, targets, target_lengths,
              reduction='none')
    tl = torch.clamp(target_lengths, min=1).to(torch.float32)
    weighted = per / tl * batch_mask
    if mask_sum is None:
        mask_sum = torch.sum(batch_mask)
    return torch.sum(weighted) / torch.clamp(mask_sum, min=1.0)


def global_mask_sum(batch_mask):
    """``sum(batch_mask)`` over every replica's rows (None outside a
    process group: the batch is the whole batch)."""
    if not mesh.distributed():
        return None
    return mesh.all_reduce_sum(torch.sum(batch_mask).reshape(1),
                               mesh.data_group())[0]


@torch.no_grad()
def eval_step(model, frontend, batch, output: str = 'ids', mask_sum=None,
              ctc=ctc_loss_kernel):
    """One batch of tensors on the device -> (loss, out, out_lens [B]).
    ``output='ids'``: ``out`` is the argmax ids [B, T'] int32 (greedy
    decoding: only they cross to the host); ``'model'``: the model's own
    output [B, T', V] (Wav2Letter's log-probabilities, Jasper's eval-mode
    probabilities), for beam decoding. One forward either way. The caller
    puts the model in eval mode. A model that emits probabilities in eval
    mode (Jasper) is scored on log(max(probs, 1e-30)), as the JAX trainer
    does. ``mask_sum`` and ``ctc`` as ``masked_ctc_mean`` takes them."""
    if output not in ('ids', 'model'):
        raise ValueError(f"output must be 'ids' or 'model', got {output!r}")
    feats, flens = frontend(batch['audio'], batch['audio_lengths'])
    out, out_lens = seq_forward(model, feats, flens)
    log_probs = (torch.log(torch.clamp(out, min=1e-30))
                 if getattr(model, 'eval_emits_probs', False) else out)
    loss = masked_ctc_mean(log_probs, out_lens, batch['targets'],
                           batch['target_lengths'], batch['batch_mask'],
                           mask_sum, ctc)
    if output == 'ids':
        out = torch.argmax(out, dim=-1).to(torch.int32)
    return loss, out, out_lens


def seq_forward(model, feats, flens, generator=None):
    """``model(feats, flens, generator=...)``; under sequence parallelism
    on this rank's range of the frames, with the output gathered whole
    (every seq rank holds the same features)."""
    if not sp.active():
        return model(feats, flens, generator=generator)
    T = feats.shape[1]
    out, out_lens = model(sp.shard_time(feats, 1), flens,
                          generator=generator, seq_len=T)
    return sp.gather_time(out, 1, model.out_time(T)), out_lens


def to_device(batch: dict, device: torch.device) -> dict:
    """The numpy arrays of a loader batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def step_generators(seed: int, step: int, device) -> tuple:
    """(dither, augment, dropout) generators of training step ``step``;
    with more than one replica, ``RowGenerator``s over the global
    batch."""
    seeds = np.random.SeedSequence([int(seed), int(step)]).generate_state(3)
    gens = tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in seeds)
    if mesh.data_world() > 1:
        gens = tuple(mesh.RowGenerator(g, mesh.data_rank(),
                                       mesh.data_world()) for g in gens)
    return gens


def clip_by_global_norm(grads, max_norm: float, params=None) -> None:
    """optax ``clip_by_global_norm``, in place: ``g / ||g|| * max_norm``
    for every gradient unless the global norm is below ``max_norm``.
    ``params`` (the gradients' parameters) count a tensor-parallel
    shard's squares over the model group (``tp.sq_sums``)."""
    sums = (tp.sq_sums(grads, params) if params is not None
            else [torch.sum(g * g) for g in grads])
    norm = torch.sqrt(sum(sums))
    trigger = norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, g / norm * max_norm))


class Trainer:
    def __init__(self, cfg, model, frontend, optimizer, schedule, decoder,
                 device='cuda', run_dir: str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.frontend = frontend.to(self.device)
        self.optimizer = optimizer
        self.schedule = schedule
        self.decoder = decoder
        # greedy decoding needs only the argmax ids, taken on the device;
        # any other decoder scores the outputs (JAX's ``greedy_metrics``)
        self.greedy = type(decoder) is GreedyDecoder
        tcfg = cfg['trainer']
        impl = tcfg.get('ctc_impl', 'auto') or 'auto'   # config.CHOICES
        self.ctc = CTC_IMPLS[impl]
        if mesh.is_main():
            print(f'trainer.ctc_impl={impl}: '
                  + ('the plain CTC (ops/ctc.py)' if impl == 'scan' else
                     'K2/K3 (ops/ctc_kernel.py)')
                  + f' on {self.device.type}', flush=True)
        self.clip = float(tcfg.get('gradient_clip_val') or 0.0)
        self.accum = int(tcfg.get('accumulate_grad_batches', 1) or 1)
        self.max_epochs = int(tcfg.get('max_epochs', 5))
        self.max_steps = tcfg.get('max_steps')
        self.seed = int(tcfg.get('seed', 0))
        self.log_every = int(tcfg.get('log_every_n_steps', 10))
        self.metrics_interval = int(tcfg.get('string_metrics_interval', 1)
                                    or 0)
        self.metrics_flush = max(int(tcfg.get('string_metrics_flush', 8)
                                     or 8), 1)
        self.val_every = int(tcfg.get('val_every_n_epochs', 1) or 1)
        self.preempt_signal = tcfg.get('preempt_signal', 'SIGTERM')
        self.preempt_sync = max(int(tcfg.get('preempt_sync_every', 25)
                                    or 25), 1)
        self.distributed = mesh.distributed()
        self.is_main = mesh.is_main()
        mesh_cfg = tcfg.get('mesh') or {}
        model_size = int(mesh_cfg.get('model', 1) or 1)
        seq_size = int(mesh_cfg.get('seq', 1) or 1)
        if (model_size, seq_size) != (mesh.model_world(), mesh.seq_world()):
            raise ValueError(
                f'trainer.mesh.model={model_size} trainer.mesh.seq='
                f'{seq_size} but the process group has model groups of '
                f'{mesh.model_world()} and seq groups of '
                f'{mesh.seq_world()}: launch with torchrun and join with '
                f'parallel.init_distributed(model={model_size}, seq='
                f'{seq_size}) (train.py does)')
        if mesh.model_world() > 1 and not tp.model_spec(self.model):
            tp.shard_module(self.model)   # built whole, as model=1
        # under a process group the gradients live in one flat buffer,
        # all-reduced once an update
        self._grads = (mesh.FlatGrads(self._params()) if self.distributed
                       else None)
        self.print_decoded_prob = float(
            cfg['model'].get('print_decoded_prob', 0) or 0)
        self.run_dir = run_dir or tcfg.get('default_root_dir', '.')
        ck = tcfg.get('checkpoint') or {}
        self.ckpt_every = int(ck.get('every_n_epochs', 1))
        self.ckpt = Checkpointer(os.path.join(self.run_dir, 'checkpoints'),
                                 keep_last=int(ck.get('keep_last', 3)),
                                 monitor=ck.get('monitor'),
                                 mode=ck.get('mode', 'min'))
        self.logger = MetricLogger(self.run_dir) if self.is_main else None
        self.augment_fn = build_augment_fn(
            (cfg.get('data') or {}).get('augment'))
        self.step = 0
        self._preempt_requested = False
        self._saved_step = None
        self.stopped_reason = None

    def close(self) -> None:
        """Close the metrics file."""
        if self.logger is not None:
            self.logger.close()

    def _log(self, step: int, metrics: dict) -> None:
        if self.logger is not None:
            self.logger.log(step, metrics)

    # ---------------------------------------------------------------- state
    def _params(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def state_dict(self) -> dict:
        """Everything a resume needs: step, weights and BN statistics,
        optimizer state, and gradients accumulated so far in a cycle
        (summed over the replica group: under a process group every rank
        calls this), in the model=1 layout (tensor-parallel shards
        gathered)."""
        params = self._params()
        grads = None
        if self.step % self.accum != 0:
            grads = [p.grad for p in params]
            if self.distributed:
                grads = [None if g is None else g.clone() for g in grads]
                mesh.all_reduce_flat([g for g in grads if g is not None],
                                     mesh.replica_group())
                idx = [i for i, g in enumerate(grads)
                       if g is not None and tp.is_sharded(params[i])]
                if idx:
                    whole = tp.gather_rows([grads[i] for i in idx],
                                           mesh.model_group())
                    for i, g in zip(idx, whole):
                        grads[i] = g
        model = self.model.state_dict()
        spec = tp.model_spec(self.model)
        if spec:
            model = tp.gather_state(model, spec)
        return {'step': self.step, 'model': model,
                'optimizer': tp.gather_optimizer_state(self.optimizer),
                'grad_accum': grads}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s layout (any topology's); a
        tensor-parallel rank keeps its shards of it."""
        self.step = int(state['step'])
        spec = tp.model_spec(self.model)
        self.model.load_state_dict(tp.shard_state(state['model'], spec)
                                   if spec else state['model'])
        self.optimizer.load_state_dict(
            tp.shard_optimizer_state(self.optimizer, state['optimizer']))
        grads = state.get('grad_accum') or [None] * len(self._params())
        if mesh.data_rank() or mesh.seq_rank():   # the sum counts once
            grads = [None] * len(grads)
        for p, g in zip(self._params(), grads):
            if g is not None and tp.is_sharded(p):
                g = tp.local_shard(g)
            p.grad = None if g is None else g.to(p.device)
        if self._grads is not None:
            self._grads.bind()

    def _save(self, step: int, metrics=None, extra=None) -> None:
        """Checkpoint ``step``, written by rank 0 (every rank calls this)."""
        state = self.state_dict()
        if self.is_main:
            self.ckpt.save(step, state, metrics=metrics, extra=extra)
        self._saved_step = step
        mesh.barrier()

    # ---------------------------------------------------------------- steps
    def train_step(self, batch: dict, reduce_loss: bool = True):
        """One micro-step on a batch of device tensors; returns (loss,
        argmax ids [B, T'] int32 (a greedy decoder) or the log-probs [B,
        T', V] (any other), out_lens [B]). Every
        ``accumulate_grad_batches``-th call applies the update. Under a
        process group the loss is the global batch's, or with
        ``reduce_loss=False`` this rank's share of it (the ranks' shares
        sum to it; ``fit`` reduces only the losses it logs)."""
        g_dither, g_aug, g_drop = step_generators(self.seed, self.step,
                                                  self.device)
        with torch.no_grad():
            feats, flens = self.frontend(batch['audio'],
                                         batch['audio_lengths'],
                                         generator=g_dither)
            if self.augment_fn is not None:
                feats = self.augment_fn(g_aug, feats)
        self.model.train()
        log_probs, out_lens = seq_forward(self.model, feats, flens, g_drop)
        loss = masked_ctc_mean(log_probs, out_lens, batch['targets'],
                               batch['target_lengths'], batch['batch_mask'],
                               global_mask_sum(batch['batch_mask']), self.ctc)
        loss.backward()
        self.step += 1
        if self.step % self.accum == 0:
            self._update()
        out = log_probs.detach()
        if self.greedy:
            out = torch.argmax(out, dim=-1).to(torch.int32)
        loss = loss.detach()
        if self.distributed and reduce_loss:
            loss = mesh.all_reduce_sum(loss.reshape(1), mesh.data_group())[0]
        return loss, out, out_lens

    def _update(self) -> None:
        if self._grads is not None:
            self._grads.all_reduce(mesh.replica_group())
        params = [p for p in self._params() if p.grad is not None]
        grads = [p.grad for p in params]
        with torch.no_grad():
            if self.accum > 1:
                for g in grads:
                    g.div_(self.accum)
            if self.clip:
                clip_by_global_norm(grads, self.clip, params)
        lr = self.schedule(self.step // self.accum - 1)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        # the flat buffer's views are zeroed in place
        self.optimizer.zero_grad(set_to_none=self._grads is None)

    # ------------------------------------------------------------------ fit
    def _flush_metrics(self, pending: list) -> None:
        """WER/CER of the pending steps, from one device-to-host copy of
        their ids (a greedy decoder; else of each step's log-probs, scored
        as probabilities) and, under a process group, one reduction of
        their sums."""
        if not pending:
            return
        accs = []
        if self.greedy:
            flat = torch.cat([t.reshape(-1).to(torch.int32) for p in pending
                              for t in (p[1], p[2])]).cpu().numpy()
            off = 0
            for m_step, ids, lens, texts, mask in pending:
                n_ids, n_lens = ids.numel(), lens.numel()
                ids_np = flat[off:off + n_ids].reshape(ids.shape)
                lens_np = flat[off + n_ids:off + n_ids + n_lens]
                off += n_ids + n_lens
                accs.append(string_sums(
                    self.decoder, ids_np, lens_np, texts, 'train',
                    batch_mask=mask,
                    print_decoded_prob=self.print_decoded_prob))
        else:
            for m_step, out, lens, texts, mask in pending:
                accs.append(string_sums(
                    self.decoder, self.probabilities(out, log=True),
                    lens.cpu().numpy(), texts, 'train', batch_mask=mask,
                    print_decoded_prob=self.print_decoded_prob))
        self._reduce_sums(accs)
        for (m_step, *_), acc in zip(pending, accs):
            self._log(m_step, acc.ratios(floor=1))
        pending.clear()

    def _reduce_sums(self, accs: list) -> None:
        """Sum the accumulators' numerators and denominators over the
        replicas (float64, one collective over the data group)."""
        if not self.distributed:
            return
        keys = [(a, k) for a in accs for k in sorted(a.sums)]
        vec = torch.tensor([v for a, k in keys
                            for v in (a.sums[k], a.denoms[k])],
                           dtype=torch.float64, device=self.device)
        vec = mesh.all_reduce_sum(vec, mesh.data_group()).tolist()
        for i, (a, k) in enumerate(keys):
            a.sums[k], a.denoms[k] = vec[2 * i], vec[2 * i + 1]

    def _install_signal(self):
        sig = getattr(signal, str(self.preempt_signal), None) \
            if self.preempt_signal else None
        if sig is None:
            return None, None

        def on_preempt(signum, frame):
            self._preempt_requested = True
            print(f'{self.preempt_signal} received: checkpointing at the '
                  'next step boundary', flush=True)
        try:
            return sig, signal.signal(sig, on_preempt)
        except ValueError:  # not the main thread
            return None, None

    def fit(self, train_loader, val_loader=None, resume: bool = False):
        if train_loader.peek_batch() is None:
            raise ValueError('empty training loader')
        os.makedirs(self.run_dir, exist_ok=True)
        if self.is_main:
            with open(os.path.join(self.run_dir, 'config.json'), 'w') as f:
                json.dump(self.cfg, f, indent=2)
        start_epoch, resume_skip = 0, 0
        if resume and self.ckpt.latest_step() is not None:
            self.load_state_dict(self.ckpt.restore())
            self._saved_step = self.step
            print(f'Resumed from step {self.step}')
            extra = self.ckpt.load_extra()
            if 'epoch' in extra:
                start_epoch = int(extra['epoch'])
                if extra.get('preempted'):
                    resume_skip = int(extra.get('epoch_step', 0))
            elif len(train_loader):
                start_epoch = self.step // len(train_loader)
            train_loader.epoch = start_epoch
        if self.distributed:   # each rank's shards from the first's
            mesh.broadcast_module(self.model, src=mesh.replica_root(),
                                  group=mesh.replica_group())

        self._preempt_requested = False
        self.stopped_reason = None
        sig, prev_handler = self._install_signal()
        t0, utts, pending = None, 0, []
        preempt_stop = False
        n_steps = 0
        try:
            for epoch in range(start_epoch, self.max_epochs):
                skip = resume_skip if epoch == start_epoch else 0
                epoch_start_step = self.step - skip
                with contextlib.closing(iter(train_loader)) as batches:
                    for batch in batches:
                        if skip > 0:
                            skip -= 1
                            continue
                        if (self.max_steps is not None
                                and self.step >= int(self.max_steps)):
                            break
                        loss, ids, out_lens = self.train_step(
                            to_device(batch, self.device), reduce_loss=False)
                        if t0 is None:
                            float(loss)  # the first step ends before timing
                            t0 = time.time()
                        else:
                            utts += int(batch['batch_mask'].sum())
                        self._after_step(loss, ids, out_lens, batch, t0,
                                         utts, pending)
                        n_steps += 1
                        if self._stop_agreed(n_steps):
                            preempt_stop = True
                            self.stopped_reason = 'signal'
                            break
                self._flush_metrics(pending)
                if preempt_stop:
                    if self.step != self._saved_step:
                        self._save(self.step, extra={
                            'epoch': epoch,
                            'epoch_step': self.step - epoch_start_step,
                            'preempted': True})
                    print(f'preempted: checkpoint saved at step {self.step}; '
                          f'epoch {epoch} replays on --resume', flush=True)
                    break
                val = None
                if val_loader is not None and (epoch + 1) % self.val_every == 0:
                    val = self.validate(val_loader)
                    self._log(self.step, val)
                    if self.is_main:
                        print(f'epoch {epoch}: ' + ' '.join(
                            f'{k}={v:.4f}' for k, v in val.items()))
                if (epoch + 1) % self.ckpt_every == 0:
                    self._save(self.step, metrics=val,
                               extra={'epoch': epoch + 1})
                if (self.max_steps is not None
                        and self.step >= int(self.max_steps)):
                    break
        finally:
            if sig is not None:
                signal.signal(sig, prev_handler)

    def _stop_agreed(self, n_steps: int) -> bool:
        """Whether to stop for the signal after this step. With more than
        one rank, the flags are reduced (max) every ``preempt_sync_every``
        steps, at the same step on every rank, and only there: a rank
        that stopped alone would leave the others waiting in a
        collective."""
        if mesh.world() == 1:
            return self._preempt_requested
        if n_steps % self.preempt_sync:
            return False
        flag = torch.tensor([float(self._preempt_requested)],
                            device=self.device)
        return bool(mesh.all_reduce_max(flag)[0] > 0)

    def _after_step(self, loss, ids, out_lens, batch, t0, utts, pending):
        step = self.step
        if self.metrics_interval and step % self.metrics_interval == 0:
            pending.append((step, ids, out_lens, batch['texts'],
                            batch['batch_mask']))
            if len(pending) >= self.metrics_flush:
                self._flush_metrics(pending)
        if step % self.log_every == 0 or step == 1:
            if self.distributed:   # the global batch's loss
                loss = mesh.all_reduce_sum(loss.reshape(1),
                                           mesh.data_group())[0]
            value = float(loss)
            if not math.isfinite(value):
                raise FloatingPointError(f'non-finite training loss at step '
                                         f'{step}: {value}')
            logs = {'train_loss': value,
                    'learning_rate': self.schedule((step - 1) // self.accum)}
            if self.distributed:
                utts = int(mesh.all_reduce_sum(torch.tensor(
                    [utts], dtype=torch.int64, device=self.device),
                    mesh.data_group())[0])
            if utts:
                logs['utterances_per_sec'] = utts / max(time.time() - t0,
                                                        1e-9)
            self._log(step, logs)

    # ------------------------------------------------------------- validate
    def probabilities(self, out: torch.Tensor, log: bool) -> np.ndarray:
        """A batch's outputs as the probabilities [B, T', V] a beam
        decoder takes, on the host: ``exp`` of log-probs (``log``:
        Wav2Letter's eval and every train-mode output). The JAX trainer
        hands log-probs to the decoder as they are, which its own
        ``test.py`` does not (ROADMAP C.6)."""
        out = out.float().cpu().numpy()
        return np.exp(out) if log else out

    def validate(self, val_loader) -> dict:
        """val_loss (the mean of the batches' losses), val_cer, val_wer and
        val_len_ratio over the loader; under a process group each rank
        scores its rows and the sums are reduced, so every rank returns
        the one-process numbers. A greedy decoder decodes the argmax ids
        taken on the device; any other scores the outputs
        (``probabilities``) with ``decoder.decode``."""
        self.model.eval()
        acc = RatioAccumulator()
        losses = []
        if self.distributed:   # every rank reduces the same keys
            for key in ('val_cer', 'val_wer', 'val_len_ratio'):
                acc.add(key, 0.0, 0.0)
        for batch in val_loader:
            b = to_device(batch, self.device)
            loss, out, out_lens = eval_step(
                self.model, self.frontend, b,
                'ids' if self.greedy else 'model',
                mask_sum=global_mask_sum(b['batch_mask']), ctc=self.ctc)
            losses.append(loss.reshape(1))
            sizes = out_lens.cpu().numpy()
            if self.greedy:
                decoded = self.decoder.decode_ids(out.cpu().numpy(), sizes)
            else:
                decoded = self.decoder.decode(self.probabilities(
                    out, not getattr(self.model, 'eval_emits_probs',
                                     False)), sizes)
            for j, expected in enumerate(batch['texts']):
                if not batch['batch_mask'][j]:
                    continue
                acc.add('val_cer', *self.decoder.cer_ratio(expected,
                                                           decoded[j]))
                acc.add('val_wer', *self.decoder.wer_ratio(expected,
                                                           decoded[j]))
                acc.add('val_len_ratio', len(decoded[j]), len(expected))
        if self.distributed:
            self._reduce_sums([acc])
            if losses:
                losses = list(mesh.all_reduce_sum(torch.cat(losses),
                                                  mesh.data_group()))
        losses = [float(v) for v in losses]
        out = {'val_loss': float(np.mean(losses)) if losses else 0.0}
        out.update(acc.ratios())
        return out
