"""Data parallelism over several devices, and the process groups of
tensor and sequence parallelism: a device list for serving, process
groups for training.

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
* With ``model=m`` > 1 (tensor parallelism, ``parallel/tp.py``) and / or
  ``seq=q`` > 1 (sequence parallelism, ``parallel/sp.py``) the world is a
  data x model x seq grid in JAX's device order: rank ``(d*m + j)*q + s``
  is data index ``d``, model index ``j`` and seq index ``s`` (adjacent
  ranks on the trailing axes, as JAX lays adjacent devices). The groups
  (``set_grid``): a **model** group (same d and s) holds one replica's
  channel shards; a **seq** group (same d and j) the time slices of one
  replica's activations; a **data** group (same j and s) one rank a data
  index, over which row counts, losses and metric sums are reduced; a
  **replica** group (same j, every d and s), over which gradients and
  BatchNorm statistics are reduced. Every collective helper takes the
  ``group`` it runs over (None: the world).

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

# torchrun's environment, read by init_distributed
ENV_KEYS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')
# the data x model x seq grid of the process group (set_grid)
_NO_GRID = {'model': 1, 'seq': 1, 'data_group': None, 'model_group': None,
            'seq_group': None, 'replica_group': None}
_GRID = dict(_NO_GRID)


class Mesh:
    """A ``data`` mesh, or a ``data`` x ``model`` x ``seq`` grid (an axis
    of extent 1 left out, as JAX's ``make_mesh`` names them): the devices
    in order, the trailing axes the fast ones (entry ``(d, j, s)`` is
    ``devices[(d * model + j) * seq + s]``)."""

    def __init__(self, devices, model: int = 1, seq: int = 1):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        self.size = len(self.devices)
        model, seq = int(model or 1), int(seq or 1)
        if self.size % (model * seq):
            raise ValueError(f'{self.size} devices do not form rows of '
                             f'model={model} x seq={seq}')
        self.model, self.seq = model, seq
        self.shape = {'data': self.size // (model * seq)}
        if model > 1:
            self.shape['model'] = model
        if seq > 1:
            self.shape['seq'] = seq
        self.axis_names = tuple(self.shape)

    def __repr__(self):
        grid = ''.join(f', {k}={v}' for k, v in (('model', self.model),
                                                 ('seq', self.seq)) if v > 1)
        return f'Mesh({[str(d) for d in self.devices]}{grid})'


def data_extent(num_devices, model: int = 1, seq: int = 1,
                visible: int | None = None) -> int:
    """The ``data`` extent of a mesh of ``num_devices`` x ``model`` x
    ``seq`` entries (None / -1: ``visible // (model * seq)``), raising the
    JAX package's text when more than ``visible`` devices are asked for
    (``visible`` None: no limit)."""
    model, seq = int(model or 1), int(seq or 1)
    extra = model * seq
    if num_devices in (None, -1):
        n = (visible or extra) // extra
    else:
        n = int(num_devices)
    if extra == 1:
        if visible is not None and n > visible:
            raise ValueError(f'Requested {n} devices, only {visible} '
                             'visible')
        if n < 1:
            raise ValueError(f'Requested {n} devices')
        return n
    if n < 1 or (visible is not None and n * extra > visible):
        raise ValueError(f'Requested {n}x{model}x{seq} (data x model x seq) '
                         f'devices, only {visible} visible')
    return n


def make_mesh(num_devices: int | None = None, axis: str = 'data',
              model: int = 1, seq: int = 1, device='cuda') -> Mesh:
    """The first ``num_devices`` x ``model`` x ``seq`` CUDA devices as a
    ``data`` (x ``model``) (x ``seq``) mesh; ``num_devices`` None / -1
    takes every visible one (``visible // (model * seq)`` rows).

    ``device='cpu'`` gives a mesh of entries of the one CPU device (one
    row for None / -1), which stands in for the JAX package's virtual CPU
    devices in tests; nothing falls back to it.
    """
    if axis != 'data':
        raise ValueError(f'the mesh axis is {"data"!r}, got {axis!r}')
    model, seq = int(model or 1), int(seq or 1)
    kind = torch.device(device).type
    if kind == 'cpu':
        n = data_extent(num_devices, model, seq)
        return Mesh([torch.device('cpu')] * (n * model * seq), model, seq)
    if kind != 'cuda':
        raise ValueError(f'no mesh over {kind!r} devices')
    from ..runtime import resolve_device
    resolve_device('cuda')   # raises without a card
    n = data_extent(num_devices, model, seq, torch.cuda.device_count())
    return Mesh([torch.device('cuda', i) for i in range(n * model * seq)],
                model, seq)


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
                     model: int = 1, seq: int = 1):
    """Join the process group torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK`` on ``cuda`` (pinned as
    the current device), the CPU on ``cpu``. ``backend`` defaults to
    NCCL on ``cuda`` and gloo on ``cpu``; NCCL is never swapped for gloo
    unless asked (several ranks on one GPU need ``backend='gloo'``).
    ``model`` / ``seq`` > 1 lay the world out as a data x model x seq
    grid and build its groups (``set_grid``); a second call with other
    extents builds them anew (every rank must make it)."""
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
        _GRID.update(_NO_GRID)
        kw = {'device_id': dev} if backend == 'nccl' else {}
        dist.init_process_group(
            backend, init_method='env://',
            world_size=int(os.environ['WORLD_SIZE']),
            rank=int(os.environ['RANK']),
            timeout=datetime.timedelta(minutes=10), **kw)
    set_grid(model, seq)
    return dev


def grid_ranks(world_size: int, model: int, seq: int) -> dict:
    """Every group of the data x model x seq grid of ``world_size`` ranks,
    by kind, each a list of its global ranks in order (rank ``(d*model +
    j)*seq + s``): 'model' (same d and s), 'seq' (same d and j), 'data'
    (same j and s) and 'replica' (same j, every d and s)."""
    data = world_size // (model * seq)

    def r(d, j, s):
        return (d * model + j) * seq + s
    return {
        'model': [[r(d, j, s) for j in range(model)]
                  for d in range(data) for s in range(seq)],
        'seq': [[r(d, j, s) for s in range(seq)]
                for d in range(data) for j in range(model)],
        'data': [[r(d, j, s) for d in range(data)]
                 for j in range(model) for s in range(seq)],
        'replica': [[r(d, j, s) for d in range(data) for s in range(seq)]
                    for j in range(model)],
    }


def set_grid(model: int = 1, seq: int = 1) -> None:
    """Lay the process group out as ``world // (model * seq)`` data rows
    of ``model`` x ``seq`` ranks (``grid_ranks``) and build the groups,
    created on every rank in the same order. An axis of extent 1 has no
    group; the replica group is the data group when ``seq`` is 1 and the
    world (None) when ``model`` is 1, as both groups are with ``model``
    and ``seq`` both 1."""
    model, seq = int(model or 1), int(seq or 1)
    if ((model, seq) == (_GRID['model'], _GRID['seq'])
            and (model * seq == 1 or _GRID['data_group'] is not None)):
        return
    w, me = dist.get_world_size(), dist.get_rank()
    if w % (model * seq):
        raise ValueError(f'trainer.mesh.model={model} x trainer.mesh.seq='
                         f'{seq} does not divide the world size {w}')
    _GRID.update(_NO_GRID)
    if model * seq == 1:
        return
    skip = {'model': model == 1, 'seq': seq == 1,
            'replica': seq == 1 or model == 1}
    mine = {}
    for kind, groups in grid_ranks(w, model, seq).items():
        if skip.get(kind):
            continue
        for ranks in groups:
            g = dist.new_group(ranks)
            if me in ranks:
                mine[f'{kind}_group'] = g
    if seq == 1:
        mine['replica_group'] = mine['data_group']
    _GRID.update(model=model, seq=seq, **mine)


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


def seq_world() -> int:
    """Ranks that share one replica's activations as time slices (1
    without sequence parallelism)."""
    return _GRID['seq'] if distributed() else 1


def model_rank() -> int:
    """This rank's index in its model group: which channel shard it
    holds."""
    return (rank() // seq_world()) % model_world()


def seq_rank() -> int:
    """This rank's index in its seq group: which time slice of its
    replica's activations it holds."""
    return rank() % seq_world()


def data_world() -> int:
    """Replicas, each a model x seq block of ranks, that split the global
    batch."""
    return world() // (model_world() * seq_world())


def data_rank() -> int:
    """This rank's replica: which rows of the global batch it holds."""
    return rank() // (model_world() * seq_world())


def data_group():
    """The group of one rank a data index (same model and seq index),
    over which row counts, losses and metric sums are reduced (None: the
    world)."""
    return _GRID['data_group']


def model_group():
    """The group of this replica's channel shards (None without tensor
    parallelism)."""
    return _GRID['model_group']


def seq_group():
    """The group of this replica's time slices (None without sequence
    parallelism)."""
    return _GRID['seq_group']


def replica_group():
    """The group over which gradients and BatchNorm statistics are
    reduced: every rank that holds this rank's channel shard, of any
    rows and any time slice (None: the world)."""
    return _GRID['replica_group']


def replica_world() -> int:
    """Ranks of the replica group."""
    return data_world() * seq_world()


def replica_root() -> int:
    """The global rank of data index 0 and seq index 0 of this rank's
    model index: the replica group's source of a broadcast."""
    return model_rank() * seq_world()


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


def chan_combine(n, mean, m2, group):
    """(count, mean, M2) of the union of every rank of ``group``'s sets,
    each given by its ``n`` (count, no gradient), ``mean`` and ``m2``
    (same shapes): an all-gather and Chan's parallel formula (not
    E[x^2] - mean^2, which loses digits when |mean| >> std),
    differentiably. A rank's set may be empty (``n`` 0, ``mean`` and
    ``m2`` finite)."""
    parts = all_gather(torch.stack([n, mean, m2]), group)   # [W, 3, ...]
    ns, means, m2s = parts[:, 0].detach(), parts[:, 1], parts[:, 2]
    total = ns.sum(0)
    g_mean = (ns * means).sum(0) / total
    g_m2 = m2s.sum(0) + (ns * (means - g_mean) ** 2).sum(0)
    return total, g_mean, g_m2


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
