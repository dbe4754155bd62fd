"""Tensor (model) parallelism: channel-sharded weights, BatchNorm
statistics and optimizer state over a ``model`` process group.

The counterpart of ``wav2letter_pytorch_tpu.parallel.tp``. There, tensor
parallelism is a sharding annotation: ``model_axis_spec`` shards the
trailing (channel) dim of every floating state leaf over a ``model`` mesh
axis and XLA's partitioner inserts the collectives. PyTorch has no
single-process SPMD, so the port keeps the same rule on the same leaves
and places every collective by hand:

* ``model_axis_spec`` applies JAX's rule to the torch layout, where the
  channel dim is dim 0 (conv weights ``[Cout, Cin/g, K]``, depthwise
  weights ``[C, 1, K]``, every ``(C,)`` bias, norm scale and shift and
  BatchNorm running statistic);
* ``shard_module`` keeps this rank's slice of every such leaf of a model
  built whole (the state-dict names stay, and a checkpoint keeps the
  whole layout: ``gather_state`` rebuilds it, ``shard_state`` slices it
  again), and marks each sharded parameter (``tp_dim``) for the
  optimizers' per-tensor norms (``sq_sums``);
* the models run each sharded conv column-parallel: its rank's ``Cout``
  slice from the whole input, its norm on the slice, then an all-gather
  rebuilds the channels (Megatron's operators: ``copy_to_model`` on the
  conv's input, identity forward and an all-reduce of the partial input
  gradient backward; ``gather_from_model`` after the norm, all-gather
  forward and this rank's slice of the gradient backward).

Every helper is the identity without a model group, so one code path
serves model=1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import sp
from .mesh import (all_reduce_sum, chan_combine, model_group, model_rank,
                   model_world, seq_group)

MODEL_AXIS = 'model'
MIN_SHARD = 8   # channels a shard keeps at least (JAX's lane-width rule)


def model_axis_spec(tensor, model_size: int):
    """The dim of ``tensor`` to shard over ``model_size`` ranks, or None
    to keep it replicated: dim 0 of a floating leaf with at least one dim
    whose dim 0 divides by ``model_size`` and holds at least ``MIN_SHARD``
    channels a shard. So the 29-label head, ``num_batches_tracked``,
    NovoGrad's per-tensor second moments (0-d) and step counters stay
    whole."""
    shape = tuple(getattr(tensor, 'shape', ()))
    floating = (tensor.is_floating_point() if torch.is_tensor(tensor)
                else np.issubdtype(np.dtype(tensor.dtype), np.floating))
    if int(model_size) <= 1 or not shape or not floating:
        return None
    c = shape[0]
    if c % model_size or c < MIN_SHARD * model_size:
        return None
    return 0


def shard_slice(p: torch.Tensor):
    """The channel range ``[start, stop)`` this rank holds of the
    parameter ``p``; None when ``p`` is whole."""
    if not is_sharded(p):
        return None
    size = p.shape[0]
    start = model_rank() * size
    return slice(start, start + size)


def is_sharded(p: torch.Tensor) -> bool:
    """Whether ``shard_module`` sharded the parameter ``p``."""
    return getattr(p, 'tp_dim', None) is not None


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A copy of this rank's dim-0 slice of ``t``, one of its model
    group's."""
    size = t.shape[0] // model_world()
    return t.narrow(0, model_rank() * size, size).clone()


def shard_module(model) -> dict:
    """Keep this rank's slice of every parameter and buffer that
    ``model_axis_spec`` shards over its model group, in place; returns
    and records (``model.tp_spec``) each state-dict key's sharded dim or
    None. The model must be whole: build it from the seed as model=1
    does, then shard."""
    world = model_world()
    spec = {}
    with torch.no_grad():
        for prefix, module in model.named_modules():
            pre = f'{prefix}.' if prefix else ''
            for name, p in module._parameters.items():
                if p is None:
                    continue
                spec[pre + name] = dim = model_axis_spec(p, world)
                if dim is not None:
                    p.data = local_shard(p.data)
                    p.tp_dim = dim
            for name, b in list(module._buffers.items()):
                if b is None or name in module._non_persistent_buffers_set:
                    continue
                spec[pre + name] = dim = model_axis_spec(b, world)
                if dim is not None:
                    module._buffers[name] = local_shard(b)
    model.tp_spec = spec
    return spec


def model_spec(model) -> dict:
    """The ``tp_spec`` of a sharded model ({} for a whole one)."""
    return getattr(model, 'tp_spec', {})


GATHER_BUCKET = 1 << 24   # elements a rank sends in one all-gather


def gather_rows(tensors: list, group) -> list:
    """Each of ``tensors`` concatenated along dim 0 over the ranks of
    ``group``, in rank order, on the host: the tensors go out in buckets
    of at most GATHER_BUCKET elements (one all-gather each, a dtype at a
    time) and each whole tensor is copied to the host as it is rebuilt,
    so a checkpoint never holds the whole state on the device."""
    out = [None] * len(tensors)
    world = dist.get_world_size(group)
    buckets, size = [], None
    for i, t in enumerate(tensors):
        if (size is None or size + t.numel() > GATHER_BUCKET
                or t.dtype != tensors[buckets[-1][0]].dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += t.numel()
    for idx in buckets:
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat.contiguous(), group=group)
        off = 0
        for i in idx:
            t, n = tensors[i], tensors[i].numel()
            out[i] = torch.cat([p[off:off + n].view_as(t)
                                for p in parts]).cpu()
            off += n
    return out


def gather_state(state: dict, spec: dict) -> dict:
    """``state`` (a sharded model's state dict) with every leaf that
    ``spec`` shards rebuilt whole over the model group (a collective:
    every rank of the group calls it); the layout of a model=1 run."""
    group = model_group()
    keys = [k for k, v in state.items() if spec.get(k) is not None]
    if not keys or group is None:
        return dict(state)
    full = gather_rows([state[k] for k in keys], group)
    return {**state, **dict(zip(keys, full))}


def shard_state(state: dict, spec: dict) -> dict:
    """A whole state dict (any run's checkpoint) sliced for this rank's
    shards: the inverse of ``gather_state``."""
    return {k: (local_shard(v) if spec.get(k) is not None else v)
            for k, v in state.items()}


def _opt_params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g['params']]


def gather_optimizer_state(optimizer) -> dict:
    """``optimizer.state_dict()`` with each state tensor that mirrors a
    sharded parameter (its shape, e.g. momenta) rebuilt whole over the
    model group; the 0-d per-tensor moments and step counts as they
    are (replicated)."""
    sd = optimizer.state_dict()
    group = model_group()
    if group is None:
        return sd
    params = _opt_params(optimizer)
    where, tensors = [], []
    for i, st in sd['state'].items():
        for k, v in st.items():
            if (is_sharded(params[i]) and torch.is_tensor(v)
                    and v.shape == params[i].shape):
                where.append((i, k))
                tensors.append(v)
    state = {i: dict(st) for i, st in sd['state'].items()}
    if tensors:
        for (i, k), v in zip(where, gather_rows(tensors, group)):
            state[i][k] = v
    return {**sd, 'state': state}


def shard_optimizer_state(optimizer, sd: dict) -> dict:
    """A whole optimizer state dict sliced for this rank's shards (the
    inverse of ``gather_optimizer_state``)."""
    world = model_world()
    if world == 1:
        return sd
    params = _opt_params(optimizer)
    state = {}
    for i, st in sd['state'].items():
        p = params[int(i)]
        whole = (p.shape[0] * world, *p.shape[1:])
        state[i] = {k: (local_shard(v) if is_sharded(p)
                        and torch.is_tensor(v)
                        and tuple(v.shape) == whole else v)
                    for k, v in st.items()}
    return {**sd, 'state': state}


def sq_sums(tensors, params) -> list:
    """``sum(t * t)`` of each of ``tensors`` (0-d), where ``params[i]``
    is the parameter ``tensors[i]`` belongs to: the sums of sharded
    parameters' tensors are added up over the model group in one
    all-reduce, so each is the whole tensor's; the others are local
    (replicated: counted once)."""
    sums = [torch.sum(t * t) for t in tensors]
    group = model_group()
    idx = [i for i, p in enumerate(params) if is_sharded(p)]
    if group is None or not idx:
        return sums
    vec = all_reduce_sum(torch.stack([sums[i] for i in idx]), group)
    for j, i in enumerate(idx):
        sums[i] = vec[j]
    return sums


# ------------------------------------------------ Megatron's operators

class _CopyToModel(torch.autograd.Function):
    """f: identity forward; the input gradient, partial on each rank
    (each rank's slice of the output channels), summed over the model
    group backward."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), model_group())


class _GatherFromModel(torch.autograd.Function):
    """g: the ranks' channel slices concatenated along ``dim`` forward;
    this rank's slice of the (whole, replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        group = model_group()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, model_rank() * ctx.size,
                        ctx.size).contiguous(), None


class _ScatterToModel(torch.autograd.Function):
    """This rank's channel slice of a whole, replicated tensor forward;
    the ranks' slice gradients concatenated backward (f then a slice)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        size = x.shape[dim] // model_world()
        return x.narrow(dim, model_rank() * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        group = model_group()
        parts = [torch.empty_like(g)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, g.contiguous(), group=group)
        return torch.cat(parts, ctx.dim), None


class _GatherParam(torch.autograd.Function):
    """A dim-0-sharded parameter whole forward; backward, this rank's
    slice of the gradient, summed over the model group first when each
    rank's use of it gives only a partial gradient."""

    @staticmethod
    def forward(ctx, w, partial):
        ctx.partial, ctx.size = partial, w.shape[0]
        group = model_group()
        parts = [torch.empty_like(w)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, w.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce_sum(g.contiguous().clone(), model_group())
        return g.narrow(0, model_rank() * ctx.size,
                        ctx.size).contiguous(), None


def _active() -> bool:
    return model_world() > 1


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f, on the input of a column-parallel conv."""
    return _CopyToModel.apply(x) if _active() else x


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Megatron's g: the whole channels (``dim``) from the ranks'
    slices."""
    return _GatherFromModel.apply(x, dim) if _active() else x


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of channel dim ``dim`` of a replicated tensor,
    for work that runs on the slice (a depthwise conv, a norm)."""
    return _ScatterToModel.apply(x, dim) if _active() else x


def whole_param(w: torch.Tensor, partial: bool) -> torch.Tensor:
    """The parameter ``w`` whole when it is sharded (``partial``: each
    rank's use gives a partial gradient, summed over the ranks)."""
    if not is_sharded(w):
        return w
    return _GatherParam.apply(w, bool(partial))


def group_norm(x: torch.Tensor, norm) -> torch.Tensor:
    """``norm`` (an ``nn.GroupNorm``: group, instance or layer norm) on
    ``x`` [B, C_r, T_r]: this rank's channel slice when ``norm``'s
    parameters are sharded, this rank's range of frames under sequence
    parallelism (``parallel.sp``). Shards that hold whole groups and every
    frame normalise alone; otherwise each group's (count, mean, M2) over
    the rank's channels and frames of it are combined with Chan's
    formula (as cross-replica BatchNorm combines rows): over the model
    group when a group straddles the channel shards, then over the seq
    group."""
    sl = shard_slice(norm.weight)
    seq = sp.active()
    if sl is None and not seq:
        return norm(x)
    cpg = norm.num_channels // norm.num_groups
    if sl is None:
        sl = slice(0, norm.num_channels)
    straddles = sl.start % cpg != 0 or (sl.stop - sl.start) % cpg != 0
    if not straddles and not seq:
        return F.group_norm(x, (sl.stop - sl.start) // cpg, norm.weight,
                            norm.bias, norm.eps)
    B, _, T = x.shape
    # the groups in play: every group when the shards are combined, else
    # those of this rank's channels (each then has frames somewhere)
    g0 = 0 if straddles else sl.start // cpg
    g1 = norm.num_groups if straddles else (sl.stop - 1) // cpg + 1
    gid = torch.arange(sl.start, sl.stop, device=x.device) // cpg - g0
    onehot = F.one_hot(gid, g1 - g0).to(x.dtype)               # [C_r, G]
    n = onehot.sum(0) * T                                      # [G]
    mean = torch.einsum('bct,cg->bg', x, onehot) / torch.clamp(n, min=1.0)
    dev = x - (mean @ onehot.t())[:, :, None]
    m2 = torch.einsum('bct,cg->bg', dev * dev, onehot)
    n = n.expand(B, -1)
    if straddles:
        n, mean, m2 = chan_combine(n, mean, m2, model_group())
    if seq:
        n, mean, m2 = chan_combine(n, mean, m2, seq_group())
    mean_c, var_c = mean[:, gid], (m2 / n)[:, gid]             # [B, C_r]
    y = (x - mean_c[:, :, None]) * torch.rsqrt(var_c + norm.eps)[:, :, None]
    return y * norm.weight[None, :, None] + norm.bias[None, :, None]
