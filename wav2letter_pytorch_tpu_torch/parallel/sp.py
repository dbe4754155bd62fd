"""Sequence parallelism: activations sharded over time across a ``seq``
process group, every conv fed by a halo exchange.

The counterpart of the JAX trainer's ``_seq_constraint`` and of what
XLA's partitioner makes of it: there, ``trainer.mesh.seq`` adds a mesh
axis, the features are constrained to ``P('data', 'seq')`` and every conv
becomes shard-local compute plus halo collective-permutes; the logits
are resharded to ``P('data')`` before CTC, whose recursion runs along
time. PyTorch has no single-process SPMD, so the port places each piece
by hand:

* ``time_partition(T, S)``: seq rank ``s`` holds the contiguous frames
  ``[T*s // S, T*(s+1) // S)`` of an activation of global length ``T``
  (any T; the ranges differ by at most one frame);
* ``shard_time``: this rank's range of a whole activation (the features:
  the frontend and SpecAugment run whole on every seq rank of a replica,
  as in JAX, and draw alike);
* ``gather_time``: the whole time axis from the ranks' ranges (the
  logits, before the loss). Every seq rank then computes the same loss
  on the same logits, so the gradient each gets is already the whole
  one: the backward keeps this rank's slice and sums nothing;
* ``conv_input``: the global input frames a conv needs for this rank's
  range of its output, through ``Halo``: the frames other ranks hold come
  in one all-gather of edge pieces (NCCL and gloo alike, CUDA tensors
  included), frames outside ``[0, T)`` are filled by reflection (the
  Wav2Letter stack's SAME padding) or with zeros (Jasper's), so the conv
  then runs unpadded. A halo may span several ranks (QuartzNet's k=87,
  d=2 block needs 86 frames a side). The backward adds each fetched
  frame's gradient into its owner's: one all-reduce of the edge pieces'
  gradients over the seq group.

The pure planning and packing functions (``halo_plan``, ``halo_pack``,
``halo_unpack``, ``halo_grad``, ``halo_grad_finish``) take the rank and
extent as arguments, so one process can play every rank of a group
(``tests/test_torch_seq_parallel.py`` does). Without a seq group (S = 1)
every helper is the identity or a local pad.
"""

from __future__ import annotations

import bisect
import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from .mesh import seq_group, seq_rank, seq_world


def time_partition(T: int, S: int) -> list:
    """Each of ``S`` ranks' contiguous range ``(lo, hi)`` of ``T``
    frames, in rank order."""
    T, S = int(T), int(S)
    return [(T * s // S, T * (s + 1) // S) for s in range(S)]


def active() -> bool:
    """Whether activations are sharded over time (a seq group of more
    than one rank)."""
    return seq_world() > 1


def local_range(T: int) -> tuple:
    """This rank's range ``(lo, hi)`` of an activation of ``T`` frames."""
    return time_partition(T, seq_world())[seq_rank()]


def shard_time(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's range of ``x``'s time dim ``dim`` (``x`` whole and the
    same on every seq rank; a slice, so its gradient is this rank's
    part only)."""
    if not active():
        return x
    lo, hi = local_range(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


class _GatherTime(torch.autograd.Function):
    """The ranks' ranges of time dim ``dim`` concatenated; backward, this
    rank's slice of the gradient (no sum: see the module's text)."""

    @staticmethod
    def forward(ctx, x, dim, T):
        parts = time_partition(T, seq_world())
        ctx.dim, ctx.range = dim, parts[seq_rank()]
        width = max(hi - lo for lo, hi in parts)
        n = x.shape[dim]
        if n < width:
            pad = list(x.shape)
            pad[dim] = width - n
            x = torch.cat([x, x.new_zeros(pad)], dim)
        bufs = [torch.empty_like(x) for _ in parts]
        dist.all_gather(bufs, x.contiguous(), group=seq_group())
        return torch.cat([b.narrow(dim, 0, hi - lo)
                          for b, (lo, hi) in zip(bufs, parts)], dim)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.range
        return g.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None


def gather_time(x: torch.Tensor, dim: int, T: int) -> torch.Tensor:
    """The whole time axis (``T`` frames) of an activation of which every
    seq rank holds its range (``time_partition``)."""
    if not active():
        return x
    return _GatherTime.apply(x, dim, int(T))


# ------------------------------------------------------------------ halos

class HaloPlan(NamedTuple):
    """How the ranks of a seq group fetch their conv inputs. ``parts``:
    the range each rank holds; ``wants``: the global range each fetches;
    ``pieces[q]``: the global frames rank q sends to the ranks before it
    and to those after it (two ranges, possibly empty); ``width``: the
    frames of a piece in the all-gather (the longest; 0: no exchange);
    ``index[r]``: for each frame rank r fetches, its row in the pool
    ``[local frames | every rank's two pieces | one zero frame]``."""
    T: int
    parts: tuple
    wants: tuple
    pieces: tuple
    width: int
    index: tuple


def source_frame(g: int, T: int, mode: str):
    """The frame of ``[0, T)`` that global frame ``g`` reads: itself
    inside, its mirror image outside under ``reflect`` (numpy's and
    ``F.pad``'s reflection, the edge frame not repeated), None (a zero)
    under ``zeros``."""
    if 0 <= g < T:
        return g
    if mode == 'zeros':
        return None
    if mode != 'reflect':
        raise ValueError(f'halo fill must be reflect or zeros, got {mode!r}')
    if T == 1:
        return 0
    period = 2 * (T - 1)
    m = g % period
    return m if m < T else period - m


@functools.lru_cache(maxsize=512)
def halo_plan(T: int, S: int, wants: tuple, mode: str) -> HaloPlan:
    """The plan of one exchange: rank r of S fetches global frames
    ``wants[r]`` of an activation of ``T`` frames held as
    ``time_partition(T, S)``, filled outside ``[0, T)`` by ``mode``."""
    parts = tuple(time_partition(T, S))
    los = [lo for lo, _ in parts]
    sources = []
    need = [[None, None] for _ in range(S)]   # per owner: (min, max) a side
    for r, (lo, hi) in enumerate(wants):
        row = []
        for g in range(lo, hi):
            src = source_frame(g, T, mode)
            q = None if src is None else bisect.bisect_right(los, src) - 1
            row.append((src, q))
            if q is not None and q != r:
                side = 0 if r < q else 1
                a = need[q][side]
                need[q][side] = (src, src) if a is None else (
                    min(a[0], src), max(a[1], src))
        sources.append(row)
    pieces = tuple(tuple((parts[q][0], parts[q][0]) if a is None
                         else (a[0], a[1] + 1) for a in need[q])
                   for q in range(S))
    width = max(b - a for piece in pieces for a, b in piece)
    index = []
    for r, row in enumerate(sources):
        n = parts[r][1] - parts[r][0]
        zero = n + S * 2 * width
        idx = []
        for src, q in row:
            if src is None:
                idx.append(zero)
            elif q == r:
                idx.append(src - parts[r][0])
            else:
                side = 0 if r < q else 1
                start = pieces[q][side][0]
                idx.append(n + (q * 2 + side) * width + src - start)
        index.append(tuple(idx))
    return HaloPlan(int(T), parts, tuple(wants), pieces, width, tuple(index))


def halo_pack(xt: torch.Tensor, plan: HaloPlan, r: int) -> torch.Tensor:
    """Rank r's send buffer ``[2 * width, ...]``: its two pieces of its
    frames ``xt`` (time first), zero-padded to ``width`` each."""
    w = plan.width
    buf = xt.new_zeros((2 * w, *xt.shape[1:]))
    lo = plan.parts[r][0]
    for side, (a, b) in enumerate(plan.pieces[r]):
        if b > a:
            buf[side * w:side * w + b - a] = xt[a - lo:b - lo]
    return buf


@functools.lru_cache(maxsize=512)
def _index(plan: HaloPlan, r: int, device) -> torch.Tensor:
    return torch.tensor(plan.index[r], dtype=torch.long, device=device)


def halo_unpack(xt: torch.Tensor, gathered, plan: HaloPlan,
                r: int) -> torch.Tensor:
    """Rank r's fetched frames ``[hi - lo, ...]`` (time first) from its
    own frames ``xt`` and every rank's send buffer concatenated
    (``gathered`` ``[S * 2 * width, ...]``; None when width is 0)."""
    pool = [xt] + ([gathered] if plan.width else [])
    pool.append(xt.new_zeros((1, *xt.shape[1:])))
    return torch.cat(pool).index_select(0, _index(plan, r, xt.device))


def halo_grad(gt: torch.Tensor, plan: HaloPlan, r: int) -> tuple:
    """The backward of ``halo_unpack`` on rank r, from the gradient of
    its fetched frames ``gt`` (time first): (the gradient of its own
    frames so far, the gradient of every rank's send buffer
    ``[S * 2 * width, ...]`` or None), the second to be summed over the
    ranks (``halo_grad_finish``)."""
    n = plan.parts[r][1] - plan.parts[r][0]
    S = len(plan.parts)
    size = n + S * 2 * plan.width + 1
    pool = gt.new_zeros((size, *gt.shape[1:]))
    pool.index_add_(0, _index(plan, r, gt.device), gt)
    remote = pool[n:size - 1].contiguous() if plan.width else None
    return pool[:n], remote


def halo_grad_finish(dx: torch.Tensor, summed, plan: HaloPlan,
                     r: int) -> torch.Tensor:
    """Rank r's own frames' gradient ``dx`` plus what every rank fetched
    of its pieces (``summed``: ``halo_grad``'s second part summed over
    the ranks), in place."""
    if summed is None:
        return dx
    w, lo = plan.width, plan.parts[r][0]
    mine = summed[r * 2 * w:(r + 1) * 2 * w]
    for side, (a, b) in enumerate(plan.pieces[r]):
        if b > a:
            dx[a - lo:b - lo] += mine[side * w:side * w + b - a]
    return dx


class Halo(torch.autograd.Function):
    """The global frames ``plan.wants[rank]`` of an activation whose time
    dim ``dim`` is sharded over ``group`` (``x``: this rank's frames)."""

    @staticmethod
    def forward(ctx, x, dim, plan, rank, group):
        ctx.dim, ctx.plan, ctx.rank, ctx.group = dim, plan, rank, group
        xt = x.movedim(dim, 0)
        gathered = None
        if plan.width:
            buf = halo_pack(xt, plan, rank)
            bufs = [torch.empty_like(buf) for _ in plan.parts]
            dist.all_gather(bufs, buf, group=group)
            gathered = torch.cat(bufs)
        return halo_unpack(xt, gathered, plan, rank).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        plan, rank = ctx.plan, ctx.rank
        dx, remote = halo_grad(g.movedim(ctx.dim, 0), plan, rank)
        if remote is not None:
            dist.all_reduce(remote, op=dist.ReduceOp.SUM, group=ctx.group)
        dx = halo_grad_finish(dx, remote, plan, rank)
        return dx.movedim(0, ctx.dim).contiguous(), None, None, None, None


def conv_wants(T: int, S: int, kernel: int, stride: int, dilation: int,
               left: int, right: int) -> tuple:
    """(the global input range each of S ranks needs for its range of a
    conv's output, the output's global length): output frame t reads
    input frames ``t*stride - left + k*dilation``, k < ``kernel``."""
    t_out = (T + left + right - dilation * (kernel - 1) - 1) // stride + 1
    outs = time_partition(t_out, S)
    if any(hi == lo for lo, hi in outs):
        raise ValueError(f'sequence parallelism over {S} ranks needs at '
                         f'least {S} output frames a conv, got {t_out}')
    span = dilation * (kernel - 1) + 1
    return tuple((lo * stride - left, (hi - 1) * stride - left + span)
                 for lo, hi in outs), t_out


def conv_input(x: torch.Tensor, dim: int, T: int, kernel: int,
               stride: int = 1, dilation: int = 1, left: int = 0,
               right: int = 0, mode: str = 'zeros') -> tuple:
    """(the input this rank's range of a conv's output reads, padding
    included, the output's global length): ``x`` is this rank's range of
    an activation of ``T`` frames along ``dim``; the conv (``kernel``,
    ``stride``, ``dilation``, ``left`` / ``right`` padding filled by
    ``mode``) then runs unpadded on the result."""
    S, r = seq_world(), seq_rank()
    wants, t_out = conv_wants(int(T), S, int(kernel), int(stride),
                              int(dilation), int(left), int(right))
    plan = halo_plan(int(T), S, wants, mode)
    lo, hi = plan.parts[r]
    if x.shape[dim] != hi - lo:
        raise ValueError(f'conv_input: rank {r} holds {hi - lo} of {T} '
                         f'frames, got {x.shape[dim]}')
    return Halo.apply(x, dim, plan, r, seq_group()), t_out
