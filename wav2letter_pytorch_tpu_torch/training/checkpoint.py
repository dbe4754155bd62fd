"""Checkpoints with retention, over ``torch.save``.

Same behaviour as ``wav2letter_pytorch_tpu.training.checkpoint`` (orbax):

* ``ckpt_{step}.pt`` holds the full training state (a dict of tensors and
  state dicts); ``meta_{step}.json`` the small ``extra`` metadata saved
  with it (the epoch counter; the mid-epoch position of a preempted run);
* without ``monitor``, the newest ``keep_last`` checkpoints are kept;
  with one (e.g. ``'val_loss'``), the best ``keep_last`` by that metric
  under ``mode``, plus every checkpoint saved without the metric (such a
  save never ranks: it is neither evicted by, nor evicts, a ranked one);
* sidecars of deleted checkpoints are deleted with them;
* every file is written under a temporary name unique to the process and
  then renamed into place, so two processes writing one directory never
  rename each other's file and a reader never sees a partial one.
"""

from __future__ import annotations

import json
import os
import re
import uuid

import torch

_CKPT = re.compile(r'^ckpt_(\d+)\.pt$')


def _atomic_write(path: str, write) -> None:
    tmp = f'{path}.{os.getpid()}.{uuid.uuid4().hex}.tmp'
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_json(path: str, obj) -> None:
    def write(tmp):
        with open(tmp, 'w') as f:
            json.dump(obj, f)
    _atomic_write(path, write)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3,
                 monitor: str | None = None, mode: str = 'min'):
        if mode not in ('min', 'max'):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self._dir = os.path.abspath(directory)
        self.keep_last = int(keep_last)
        self.monitor = monitor
        self.mode = mode
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, kind: str, step: int) -> str:
        ext = 'pt' if kind == 'ckpt' else 'json'
        return os.path.join(self._dir, f'{kind}_{step}.{ext}')

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_CKPT.match,
                                                    os.listdir(self._dir))
                      if m)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, metrics: dict | None = None,
             extra: dict | None = None) -> None:
        """Write ``state`` as checkpoint ``step`` (with ``extra`` metadata
        and, when the monitored metric is among ``metrics``, the metrics
        that rank it), then apply retention."""
        _atomic_write(self._path('ckpt', step),
                      lambda tmp: torch.save(state, tmp))
        if self.monitor and metrics and self.monitor in metrics:
            _write_json(self._path('metrics', step),
                        {k: float(v) for k, v in metrics.items()})
        if extra is not None:
            _write_json(self._path('meta', step), extra)
        self._retain()

    def _metric(self, step: int):
        path = self._path('metrics', step)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f).get(self.monitor)

    def _retain(self) -> None:
        steps = self.all_steps()
        if len(steps) <= self.keep_last:
            keep = set(steps)
        elif not self.monitor:
            keep = set(steps[len(steps) - self.keep_last:])
        else:
            ranked = [(self._metric(s), s) for s in steps]
            unranked = {s for m, s in ranked if m is None}
            ranked = sorted((m, s) for m, s in ranked if m is not None)
            if self.mode == 'max':
                ranked.reverse()
            keep = unranked | {s for _, s in ranked[:self.keep_last]}
        for step in steps:
            if step not in keep:
                os.remove(self._path('ckpt', step))
        kept = set(self.all_steps())
        for name in os.listdir(self._dir):
            m = re.match(r'^(meta|metrics)_(\d+)\.json$', name)
            if m and int(m.group(2)) not in kept:
                os.remove(os.path.join(self._dir, name))

    def load_extra(self, step: int | None = None) -> dict:
        """The ``extra`` saved with ``step`` (default: the latest); ``{}``
        if there is none."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path('meta', step)):
            return {}
        with open(self._path('meta', step)) as f:
            return json.load(f)

    def restore(self, step: int | None = None, map_location='cpu'):
        """The state saved as ``step`` (default: the latest), or None."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path('ckpt', step), map_location=map_location,
                          weights_only=True)


def average_checkpoints(ckpt: Checkpointer, last_k: int):
    """The newest checkpoint's state with its ``'model'`` state dict
    replaced by the uniform average of the last ``last_k`` checkpoints':
    every floating tensor (conv weights and biases, BatchNorm affine
    parameters and running statistics) is averaged in float64; the rest
    (``num_batches_tracked``, the optimizer, the step) is the newest's."""
    steps = ckpt.all_steps()[-int(last_k):]
    if not steps:
        return None
    states = [ckpt.restore(s) for s in steps]
    newest = states[-1]
    model = {}
    for key, value in newest['model'].items():
        if torch.is_floating_point(value):
            model[key] = torch.stack([s['model'][key].double()
                                      for s in states]).mean(0).to(
                                          value.dtype)
        else:
            model[key] = value
    return dict(newest, model=model)
