"""Data parallelism over several devices, and the process groups of
tensor parallelism: a device list for serving, process groups for
training.

The counterpart of ``wav2letter_pytorch_tpu.parallel.mesh``. There, one
SPMD program runs over a ``data`` (and ``model``) mesh axis and XLA
inserts the collectives. PyTorch has no single-process SPMD, so the port
has one form for each use:

* Serving needs no collectives: ``Mesh`` is an explicit list of devices
  held by one process. ``shard_rows`` splits a batch's leading dimension
  over them; the caller holds its weights (a frontend, a streamer) once
  on each device, built there from their source, and launches every part
  before it fetches any result.
* Training runs one process a device under ``torch.distributed``
  (``torchrun``): ``init_distributed`` joins the group, and the trainer
  reduces gradients once an update, so the update is the one-process
  update of the global batch. BatchNorm takes its statistics over the
  global batch (``models/base.py::FlaxBatchNorm1d``), as the JAX step,
  written against the global batch, does.
* With ``model=m`` > 1 (tensor parallelism, ``parallel/tp.py``) the
  world is a data x model grid: rank ``r`` is data index ``r // m`` and
  model index ``r % m`` (the model index is the fast one, as JAX lays
  adjacent devices on the trailing axis). The ``m`` ranks of one data
  index hold one replica's channel shards and the same rows; the ranks
  of one model index hold the same shards of different rows. Every
  collective helper takes the ``group`` it runs over (None: the world).

The collective helpers run on NCCL, or on gloo (the CPU; several ranks
sharing one GPU), which takes CUDA tensors for the collectives used here
(all-reduce, broadcast, all-gather; ``chip_smoke.py`` phase 22 checks).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch import nn

NEXT_SLICE = ('is not ported: sequence parallelism comes in a later slice '
              '(ROADMAP A.9); trainer.mesh.data and trainer.mesh.model are '
              'taken')
# torchrun's environment, read by init_distributed
ENV_KEYS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')
# the tensor-parallel grid of the process group (init_distributed)
_GRID = {'model': 1, 'data_group': None, 'model_group': None}


class Mesh:
    """A ``data`` mesh, or a ``data`` x ``model`` grid: the devices in
    order, the model index the fast one (entry ``(d, j)`` is
    ``devices[d * model + j]``)."""

    def __init__(self, devices, model: int = 1):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        self.size = len(self.devices)
        model = int(model or 1)
        if self.size % model:
            raise ValueError(f'{self.size} devices do not form rows of '
                             f'model={model}')
        self.model = model
        self.shape = ({'data': self.size // model, 'model': model}
                      if model > 1 else {'data': self.size})
        self.axis_names = tuple(self.shape)

    def __repr__(self):
        grid = '' if self.model == 1 else f', model={self.model}'
        return f'Mesh({[str(d) for d in self.devices]}{grid})'


def data_extent(num_devices, model: int = 1, seq: int = 1,
                visible: int | None = None) -> int:
    """The ``data`` extent of a mesh of ``num_devices`` x ``model`` x
    ``seq`` entries (None / -1: ``visible // (model * seq)``), raising the
    JAX package's text when more than ``visible`` devices are asked for
    (``visible`` None: no limit)."""
    model, seq = int(model or 1), int(seq or 1)
    if seq > 1:
        raise ValueError(f'mesh seq={seq} {NEXT_SLICE}')
    if num_devices in (None, -1):
        n = (visible or model) // model
    else:
        n = int(num_devices)
    if model == 1:
        if visible is not None and n > visible:
            raise ValueError(f'Requested {n} devices, only {visible} '
                             'visible')
        if n < 1:
            raise ValueError(f'Requested {n} devices')
        return n
    if n < 1 or (visible is not None and n * model > visible):
        raise ValueError(f'Requested {n}x{model}x{seq} (data x model x seq) '
                         f'devices, only {visible} visible')
    return n


def make_mesh(num_devices: int | None = None, axis: str = 'data',
              model: int = 1, seq: int = 1, device='cuda') -> Mesh:
    """The first ``num_devices`` x ``model`` CUDA devices as a ``data``
    (x ``model``) mesh; ``num_devices`` None / -1 takes every visible
    one (``visible // model`` rows).

    ``device='cpu'`` gives a mesh of entries of the one CPU device (one
    row for None / -1), which stands in for the JAX package's virtual CPU
    devices in tests; nothing falls back to it. ``seq`` above 1 raises:
    sequence parallelism is not ported.
    """
    if axis != 'data':
        raise ValueError(f'the mesh axis is {"data"!r}, got {axis!r}')
    model = int(model or 1)
    kind = torch.device(device).type
    if kind == 'cpu':
        n = data_extent(num_devices, model, seq)
        return Mesh([torch.device('cpu')] * (n * model), model=model)
    if kind != 'cuda':
        raise ValueError(f'no mesh over {kind!r} devices')
    from ..runtime import resolve_device
    resolve_device('cuda')   # raises without a card
    n = data_extent(num_devices, model, seq, torch.cuda.device_count())
    return Mesh([torch.device('cuda', i) for i in range(n * model)],
                model=model)


def device_mesh(device='cuda') -> Mesh:
    """The mesh an entry point's ``--mesh`` serves on: every visible GPU
    for ``cuda``, the named device alone for ``cuda:N``, one CPU for
    ``cpu``."""
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        return make_mesh()
    return make_mesh(device='cpu') if dev.type == 'cpu' else Mesh([dev])


def check_divisible(rows: int, n: int, what: str = 'Batch dim') -> int:
    """``rows // n``; raises the JAX package's text when ``n`` does not
    divide ``rows``."""
    if rows % n:
        raise ValueError(
            f"{what} ({rows}) must be divisible by the 'data' mesh size "
            f'({n}); pick a batch_size that is a multiple of the device '
            'count (or set trainer.mesh.data)')
    return rows // n


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list:
    """``x`` split along its leading dimension into ``mesh.size`` equal
    parts, part ``i`` on ``mesh.devices[i]`` (copies are queued, not
    waited for)."""
    k = check_divisible(x.shape[0], mesh.size)
    return [x[i * k:(i + 1) * k].to(d, non_blocking=True)
            for i, d in enumerate(mesh.devices)]


def canonical(device) -> torch.device:
    """``device`` with its CUDA index filled in (the current CUDA device
    for a bare ``cuda``), so that two names of one device compare
    equal."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


# ----------------------------------------------------------- training

def init_distributed(device='cuda', backend: str | None = None,
                     model: int = 1):
    """Join the process group torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK`` on ``cuda`` (pinned as
    the current device), the CPU on ``cpu``. ``backend`` defaults to
    NCCL on ``cuda`` and gloo on ``cpu``; NCCL is never swapped for gloo
    unless asked (several ranks on one GPU need ``backend='gloo'``).
    ``model`` > 1 lays the world out as a data x model grid and builds
    its groups (``set_model_parallel``); a second call with another
    ``model`` builds them anew (every rank must make it)."""
    from ..runtime import resolve_device
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f'init_distributed: {missing} not set; launch '
                           'with torchrun --nproc-per-node N')
    dev = torch.device(device)
    if dev.type == 'cuda':
        resolve_device(dev)
        dev = torch.device('cuda', int(os.environ['LOCAL_RANK']))
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    if not dist.is_initialized():
        _GRID.update(model=1, data_group=None, model_group=None)
        kw = {'device_id': dev} if backend == 'nccl' else {}
        dist.init_process_group(
            backend, init_method='env://',
            world_size=int(os.environ['WORLD_SIZE']),
            rank=int(os.environ['RANK']),
            timeout=datetime.timedelta(minutes=10), **kw)
    set_model_parallel(model)
    return dev


def set_model_parallel(model: int = 1) -> None:
    """Lay the process group out as ``world // model`` data rows of
    ``model`` ranks and build the groups: one model group a data index
    (ranks ``d*m .. d*m + m - 1``), one data group a model index (ranks
    ``j, j + m, ...``), created on every rank in the same order. With
    ``model`` 1 the data group is the world and there is no model
    group."""
    model = int(model or 1)
    if model == _GRID['model'] and (model == 1
                                    or _GRID['model_group'] is not None):
        return
    w, r = dist.get_world_size(), dist.get_rank()
    if w % model:
        raise ValueError(f'trainer.mesh.model={model} does not divide the '
                         f'world size {w}')
    _GRID.update(model=1, data_group=None, model_group=None)
    if model == 1:
        return
    mine = {}
    for d in range(w // model):
        ranks = list(range(d * model, (d + 1) * model))
        g = dist.new_group(ranks)
        if r in ranks:
            mine['model_group'] = g
    for j in range(model):
        ranks = list(range(j, w, model))
        g = dist.new_group(ranks)
        if r in ranks:
            mine['data_group'] = g
    _GRID.update(model=model, **mine)


def distributed() -> bool:
    """Whether a process group is active (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def is_main() -> bool:
    return rank() == 0


def model_world() -> int:
    """Ranks that share one replica's channel shards (1 without tensor
    parallelism)."""
    return _GRID['model'] if distributed() else 1


def model_rank() -> int:
    """This rank's index in its model group: which channel shard it
    holds."""
    return rank() % model_world()


def data_world() -> int:
    """Replicas, each a model group, that split the global batch."""
    return world() // model_world()


def data_rank() -> int:
    """This rank's replica: which rows of the global batch it holds."""
    return rank() // model_world()


def data_group():
    """The group over which gradients, row counts and BatchNorm
    statistics are reduced (None: the world)."""
    return _GRID['data_group']


def model_group():
    """The group of this replica's channel shards (None without tensor
    parallelism)."""
    return _GRID['model_group']


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks of ``group`` (the world), in place; returns
    ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """Max over the ranks, in place; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of ``group``, in
    place."""
    dist.broadcast(t, src=src, group=group)
    return t


def all_reduce_flat(tensors, group=None) -> None:
    """Sum each of ``tensors`` over the ranks of ``group`` in one
    collective (their values are packed into one flat buffer and written
    back)."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum(flat, group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


class FlatGrads:
    """One flat buffer holding every parameter's gradient, each ``p.grad``
    a view into it: backward accumulates into the views in place, and the
    update's all-reduce is one collective on the buffer, with no copy in
    or out. Gradients are zeroed in place (``zero_grad(set_to_none=
    False)``), never set to None, or the views are lost."""

    def __init__(self, params):
        self.params = list(params)
        p0 = self.params[0]
        self.flat = torch.zeros(sum(p.numel() for p in self.params),
                                dtype=p0.dtype, device=p0.device)
        self.bind()

    def bind(self) -> None:
        """Make every ``p.grad`` its view again, keeping its values (a
        gradient set from outside, as a resume does, is copied in; None
        is zero)."""
        off = 0
        with torch.no_grad():
            for p in self.params:
                view = self.flat[off:off + p.numel()].view_as(p)
                off += p.numel()
                if p.grad is None:
                    view.zero_()
                elif p.grad.data_ptr() != view.data_ptr():
                    view.copy_(p.grad)
                p.grad = view

    def all_reduce(self, group=None) -> None:
        """Sum the gradients over the ranks of ``group`` (the world), in
        place."""
        self.bind()
        all_reduce_sum(self.flat, group)


def broadcast_module(module: nn.Module, src: int = 0, group=None) -> None:
    """Global rank ``src``'s parameters and buffers on every rank of
    ``group`` (the world)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, src, group)


def barrier() -> None:
    if distributed():
        dist.barrier()


class _AllGather(torch.autograd.Function):
    """Stack every rank's ``t`` (``[W, *t.shape]``, W the ranks of
    ``group``); the backward sums the gradient of the stack over those
    ranks and keeps this rank's slice, so each rank's ``t`` gets the
    gradient of the sum of all their losses."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_sum(grad.contiguous().clone(), ctx.group)
        return grad[dist.get_rank(ctx.group)], None


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-gather over ``group`` (the world):
    ``[W, *t.shape]``, rank order."""
    return _AllGather.apply(t, group)


class RowGenerator:
    """A step's random draws made for the GLOBAL batch, of which this
    replica keeps rows ``[rank * b, (rank + 1) * b)`` (``rank`` and
    ``world`` are the data index and extent: the model ranks of one
    replica draw alike): a W-replica step then draws the dither,
    SpecAugment and dropout masks of the one-process step. ``draw_rows``
    takes it wherever a ``torch.Generator`` is taken."""

    def __init__(self, generator: torch.Generator, rank: int, world: int):
        self.generator = generator
        self.rank = rank
        self.world = world

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state) -> None:
        self.generator.set_state(state)


def draw_rows(fn, shape, generator, **kw) -> torch.Tensor:
    """``fn(shape, generator=generator, **kw)`` (``torch.rand``,
    ``torch.randn``, ...); with a ``RowGenerator``, drawn for the global
    batch (``world`` x ``shape[0]`` rows) and sliced to this rank's
    rows."""
    if not isinstance(generator, RowGenerator):
        return fn(shape, generator=generator, **kw)
    b = shape[0]
    full = fn((b * generator.world, *shape[1:]),
              generator=generator.generator, **kw)
    return full[generator.rank * b:(generator.rank + 1) * b]
