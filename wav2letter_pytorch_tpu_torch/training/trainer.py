"""The training loop (PyTorch, CUDA): train step, fit, validation.

The counterpart of ``wav2letter_pytorch_tpu.training.trainer``:

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
  sync per ``string_metrics_flush`` steps, validates every
  ``val_every_n_epochs`` and checkpoints every ``checkpoint.every_n_epochs``
  with ``{'epoch'}``; ``resume`` replays the checkpointed epoch's shuffle;
* the preemption signal (``trainer.preempt_signal``, SIGTERM) stops at the
  next step boundary with a checkpoint carrying ``{'epoch', 'epoch_step',
  'preempted'}``; ``resume`` then skips the batches already applied, so
  every batch is applied exactly once across the preemption.
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
from ..ops.ctc_kernel import ctc_loss_kernel
from ..runtime import resolve_device
from .checkpoint import Checkpointer
from .logging import MetricLogger
from .metrics import RatioAccumulator, string_metrics


def masked_ctc_mean(log_probs, out_lens, targets, target_lengths,
                    batch_mask):
    """torch 'mean' CTC reduction restricted to real (unmasked) rows."""
    per = ctc_loss_kernel(log_probs, out_lens, targets, target_lengths,
                          reduction='none')
    tl = torch.clamp(target_lengths, min=1).to(torch.float32)
    weighted = per / tl * batch_mask
    return torch.sum(weighted) / torch.clamp(torch.sum(batch_mask), min=1.0)


@torch.no_grad()
def eval_step(model, frontend, batch, output: str = 'ids'):
    """One batch of tensors on the device -> (loss, out, out_lens [B]).
    ``output='ids'``: ``out`` is the argmax ids [B, T'] int32 (greedy
    decoding: only they cross to the host); ``'model'``: the model's own
    output [B, T', V] (Wav2Letter's log-probabilities, Jasper's eval-mode
    probabilities), for beam decoding. One forward either way. The caller
    puts the model in eval mode. A model that emits probabilities in eval
    mode (Jasper) is scored on log(max(probs, 1e-30)), as the JAX trainer
    does."""
    if output not in ('ids', 'model'):
        raise ValueError(f"output must be 'ids' or 'model', got {output!r}")
    feats, flens = frontend(batch['audio'], batch['audio_lengths'])
    out, out_lens = model(feats, flens)
    log_probs = (torch.log(torch.clamp(out, min=1e-30))
                 if getattr(model, 'eval_emits_probs', False) else out)
    loss = masked_ctc_mean(log_probs, out_lens, batch['targets'],
                           batch['target_lengths'], batch['batch_mask'])
    if output == 'ids':
        out = torch.argmax(out, dim=-1).to(torch.int32)
    return loss, out, out_lens


def to_device(batch: dict, device: torch.device) -> dict:
    """The numpy arrays of a loader batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def step_generators(seed: int, step: int, device) -> tuple:
    """(dither, augment, dropout) generators of training step ``step``."""
    seeds = np.random.SeedSequence([int(seed), int(step)]).generate_state(3)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in seeds)


def clip_by_global_norm(grads, max_norm: float) -> None:
    """optax ``clip_by_global_norm``, in place: ``g / ||g|| * max_norm``
    for every gradient unless the global norm is below ``max_norm``."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
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
        tcfg = cfg['trainer']
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
        self.print_decoded_prob = float(
            cfg['model'].get('print_decoded_prob', 0) or 0)
        self.run_dir = run_dir or tcfg.get('default_root_dir', '.')
        ck = tcfg.get('checkpoint') or {}
        self.ckpt_every = int(ck.get('every_n_epochs', 1))
        self.ckpt = Checkpointer(os.path.join(self.run_dir, 'checkpoints'),
                                 keep_last=int(ck.get('keep_last', 3)),
                                 monitor=ck.get('monitor'),
                                 mode=ck.get('mode', 'min'))
        self.logger = MetricLogger(self.run_dir)
        self.augment_fn = build_augment_fn(
            (cfg.get('data') or {}).get('augment'))
        self.step = 0
        self._preempt_requested = False

    def close(self) -> None:
        """Close the metrics file."""
        self.logger.close()

    # ---------------------------------------------------------------- state
    def _params(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def state_dict(self) -> dict:
        """Everything a resume needs: step, weights and BN statistics,
        optimizer state, and gradients accumulated so far in a cycle."""
        mid_cycle = self.step % self.accum != 0
        return {'step': self.step, 'model': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict(),
                'grad_accum': ([p.grad for p in self._params()]
                               if mid_cycle else None)}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state['step'])
        self.model.load_state_dict(state['model'])
        self.optimizer.load_state_dict(state['optimizer'])
        grads = state.get('grad_accum') or [None] * len(self._params())
        for p, g in zip(self._params(), grads):
            p.grad = None if g is None else g.to(p.device)

    # ---------------------------------------------------------------- steps
    def train_step(self, batch: dict):
        """One micro-step on a batch of device tensors; returns (loss,
        argmax ids [B, T'] int32, out_lens [B]). Every
        ``accumulate_grad_batches``-th call applies the update."""
        g_dither, g_aug, g_drop = step_generators(self.seed, self.step,
                                                  self.device)
        with torch.no_grad():
            feats, flens = self.frontend(batch['audio'],
                                         batch['audio_lengths'],
                                         generator=g_dither)
            if self.augment_fn is not None:
                feats = self.augment_fn(g_aug, feats)
        self.model.train()
        log_probs, out_lens = self.model(feats, flens, generator=g_drop)
        loss = masked_ctc_mean(log_probs, out_lens, batch['targets'],
                               batch['target_lengths'], batch['batch_mask'])
        loss.backward()
        self.step += 1
        if self.step % self.accum == 0:
            self._update()
        ids = torch.argmax(log_probs.detach(), dim=-1).to(torch.int32)
        return loss.detach(), ids, out_lens

    def _update(self) -> None:
        grads = [p.grad for p in self._params() if p.grad is not None]
        with torch.no_grad():
            if self.accum > 1:
                for g in grads:
                    g.div_(self.accum)
            if self.clip:
                clip_by_global_norm(grads, self.clip)
        lr = self.schedule(self.step // self.accum - 1)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    # ------------------------------------------------------------------ fit
    def _flush_metrics(self, pending: list) -> None:
        """WER/CER of the pending steps, from one device-to-host copy."""
        if not pending:
            return
        flat = torch.cat([t.reshape(-1).to(torch.int32) for p in pending
                          for t in (p[1], p[2])]).cpu().numpy()
        off = 0
        for m_step, ids, lens, texts, mask in pending:
            n_ids, n_lens = ids.numel(), lens.numel()
            ids_np = flat[off:off + n_ids].reshape(ids.shape)
            lens_np = flat[off + n_ids:off + n_ids + n_lens]
            off += n_ids + n_lens
            self.logger.log(m_step, string_metrics(
                self.decoder, ids_np, lens_np, texts, 'train',
                batch_mask=mask, print_decoded_prob=self.print_decoded_prob))
        pending.clear()

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
        with open(os.path.join(self.run_dir, 'config.json'), 'w') as f:
            json.dump(self.cfg, f, indent=2)
        start_epoch, resume_skip = 0, 0
        if resume and self.ckpt.latest_step() is not None:
            self.load_state_dict(self.ckpt.restore())
            print(f'Resumed from step {self.step}')
            extra = self.ckpt.load_extra()
            if 'epoch' in extra:
                start_epoch = int(extra['epoch'])
                if extra.get('preempted'):
                    resume_skip = int(extra.get('epoch_step', 0))
            elif len(train_loader):
                start_epoch = self.step // len(train_loader)
            train_loader.epoch = start_epoch

        self._preempt_requested = False
        sig, prev_handler = self._install_signal()
        t0, utts, pending = None, 0, []
        preempt_stop = False
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
                            to_device(batch, self.device))
                        if t0 is None:
                            float(loss)  # the first step ends before timing
                            t0 = time.time()
                        else:
                            utts += int(batch['batch_mask'].sum())
                        self._after_step(loss, ids, out_lens, batch, t0,
                                         utts, pending)
                        if self._preempt_requested:
                            preempt_stop = True
                            break
                self._flush_metrics(pending)
                if preempt_stop:
                    if self.step not in self.ckpt.all_steps():
                        self.ckpt.save(self.step, self.state_dict(), extra={
                            'epoch': epoch,
                            'epoch_step': self.step - epoch_start_step,
                            'preempted': True})
                    print(f'preempted: checkpoint saved at step {self.step}; '
                          f'epoch {epoch} replays on --resume', flush=True)
                    break
                val = None
                if val_loader is not None and (epoch + 1) % self.val_every == 0:
                    val = self.validate(val_loader)
                    self.logger.log(self.step, val)
                    print(f'epoch {epoch}: ' + ' '.join(
                        f'{k}={v:.4f}' for k, v in val.items()))
                if (epoch + 1) % self.ckpt_every == 0:
                    self.ckpt.save(self.step, self.state_dict(), metrics=val,
                                   extra={'epoch': epoch + 1})
                if (self.max_steps is not None
                        and self.step >= int(self.max_steps)):
                    break
        finally:
            if sig is not None:
                signal.signal(sig, prev_handler)

    def _after_step(self, loss, ids, out_lens, batch, t0, utts, pending):
        step = self.step
        if self.metrics_interval and step % self.metrics_interval == 0:
            pending.append((step, ids, out_lens, batch['texts'],
                            batch['batch_mask']))
            if len(pending) >= self.metrics_flush:
                self._flush_metrics(pending)
        if step % self.log_every == 0 or step == 1:
            value = float(loss)
            if not math.isfinite(value):
                raise FloatingPointError(f'non-finite training loss at step '
                                         f'{step}: {value}')
            logs = {'train_loss': value,
                    'learning_rate': self.schedule((step - 1) // self.accum)}
            if utts:
                logs['utterances_per_sec'] = utts / max(time.time() - t0,
                                                        1e-9)
            self.logger.log(step, logs)

    # ------------------------------------------------------------- validate
    def validate(self, val_loader) -> dict:
        self.model.eval()
        acc = RatioAccumulator()
        losses = []
        for batch in val_loader:
            loss, ids, out_lens = eval_step(self.model, self.frontend,
                                            to_device(batch, self.device))
            losses.append(float(loss))
            decoded = self.decoder.decode_ids(ids.cpu().numpy(),
                                              out_lens.cpu().numpy())
            for j, expected in enumerate(batch['texts']):
                if not batch['batch_mask'][j]:
                    continue
                acc.add('val_cer', *self.decoder.cer_ratio(expected,
                                                           decoded[j]))
                acc.add('val_wer', *self.decoder.wer_ratio(expected,
                                                           decoded[j]))
                acc.add('val_len_ratio', len(decoded[j]), len(expected))
        out = {'val_loss': float(np.mean(losses)) if losses else 0.0}
        out.update(acc.ratios())
        return out
