"""Streaming (chunked, stateful) inference for Jasper and QuartzNet, on the
card.

The counterpart of the JAX package's ``serving/streaming_jasper.py``, over
the port's streaming frontend and session (``streaming.py``): the same
plan (``_plan`` over zero-padded layers), prime window, per-conv carries,
finish flush and float length arithmetic, so a stream emits what the
eval-mode ``Jasper`` emits offline (softmax probabilities) on the same
audio zero-padded past the network's lookahead, with fixed normalisation
statistics (``norm='precomputed'``), up to float reassociation.

The block structure streamed, as in JAX:

* symmetric zero padding: every conv primes from a zeros carry;
* separable convs: a depthwise carry-conv, then a pointwise product, with
  eval BatchNorm folded into the pointwise (or into the single conv);
  ``heads`` is the full depthwise conv whose channel ``c`` filter is
  ``w[c % heads]``;
* grouped convs and the ``GroupShuffle`` after each norm;
* in-block residual branches (1x1 convs of the block input, dense panes
  included), aligned to the main path's emission lag by FIFOs;
* masked convs: interior chunks are all valid; the finish zeroes the
  frames past each row's float length before every conv, from the
  reference's length arithmetic (``len = a * flen + b``, float32);
* group, instance and layer norms: time-global offline, so a stream keeps
  their learned scale and bias and normalises with cumulative statistics
  over the valid frames seen so far (biased variance, eps 1e-5). Those
  outputs converge to the offline ones but never equal them: the JAX
  streamer's documented contract.

Tensors are ``[B, T, C]`` throughout. Every phase launches kernel K1 once
(the frontend) and kernel K4 (``ops.depthwise.depthwise_fwd``) once for
each depthwise conv, VALID over the carry plus the new frames; pointwise
and residual 1x1 products are ``torch.matmul`` (grouped per group), full
convs with k > 1 ``F.conv1d``: what the JAX streamer leaves to XLA.

Weights: ``'f32'``; ``'int8'`` (the float32 math on ``quantize_folded``
weights); ``'int8_full'``, where every non-depthwise conv of the main path
runs on int8 activations (``infer.conv_q8_valid``, one a group) with the
dynamic per-row scale ``max|x| / 127`` divided by a tensor, and, with
``int8_depthwise``, the depthwise convs too as an integer tap loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import compute_new_kernel_size, get_same_padding
from ..models.jasper import _ACTIVATIONS, group_shuffle
from ..ops.depthwise import depthwise_fwd
from .fold import BN_EPS, _kernel, _state_dict
from .infer import (_materialize, _tensor, conv_q8_valid, dynamic_act_scale,
                    quantize_act)
from .quantize import quantize_folded
from .streaming import (StreamingSession, _FrontendStreaming, _LayerSpec,
                        _plan)

NORM_EPS = 1e-5  # group / instance / layer norm epsilon (models/jasper.py)


def _act(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f'unsupported activation for streaming: {name!r}')
    return _ACTIVATIONS[name]


def _bn_fold(sd: dict, key: str):
    g = (np.asarray(sd[f'{key}.weight'], np.float32)
         / np.sqrt(np.asarray(sd[f'{key}.running_var'], np.float32)
                   + BN_EPS))
    beta = np.asarray(sd[f'{key}.bias'], np.float32)
    mean = np.asarray(sd[f'{key}.running_mean'], np.float32)
    return g, beta - mean * g


def _num_groups(b: dict, C: int) -> int:
    """Effective group count of the block's norm (models/jasper.py)."""
    kind = b.get('normalization', 'batch')
    if kind == 'instance':
        return C
    if kind == 'layer':
        return 1
    ng = int(b.get('norm_groups', 1))
    return C if ng == -1 else ng


def fold_jasper(model_or_state_dict, jasper_blocks):
    """Extract and fold Jasper weights into streaming op descriptors.

    ``model_or_state_dict``: the port's ``Jasper`` or its state dict (the
    reference layout ``jasper_encoder.{b}.mconv.{i}``, ``final_layer.0``);
    ``jasper_blocks``: the config's blocks, truncated to the model's
    depth. Returns ``(blocks, head)``, the JAX ``fold_jasper``'s
    descriptors in its layout and float32 arithmetic: each block holds its
    repeats (``reps``: ``{'ops': [...], 'norm': None | {...}}``), its
    residual branches (``res``) and its attributes. Eval BatchNorm (eps
    1e-3) is folded into the conv weights; group, instance and layer norms
    keep their scale and bias as runtime descriptors.
    """
    sd = _state_dict(model_or_state_dict)
    blocks = []
    for i, b in enumerate(jasper_blocks):
        key = f'jasper_encoder.{i}'
        norm_kind = b.get('normalization', 'batch')
        if norm_kind not in ('batch', 'group', 'instance', 'layer'):
            raise ValueError(f'unknown normalization: {norm_kind!r}')
        batch_norm = norm_kind == 'batch'
        groups = int(b.get('groups', 1))
        heads = int(b.get('heads', -1))
        repeat = int(b.get('repeat', 1))
        kernel = compute_new_kernel_size(int(b['kernel_size']),
                                         float(b.get('kernel_size_factor',
                                                     1.0)))
        stride = int(b.get('stride', 1))
        dilation = int(b.get('dilation', 1))
        separable = bool(b.get('separable', True)) and kernel > 1
        residual = bool(b.get('residual', True))
        if residual and stride > 1:
            # The offline residual add would not match shapes.
            raise ValueError('residual blocks must have stride 1')
        if heads != -1 and not separable:
            raise ValueError('heads streaming requires separable blocks '
                             '(the depthwise path, jasper.py:436-453)')
        mask = bool(b.get('conv_mask', True))
        pad = get_same_padding(kernel, stride, dilation)
        planes = int(b['layer_size'])

        def norm_desc(nkey, C):
            if batch_norm:
                return None
            return dict(gamma=np.asarray(sd[f'{nkey}.weight'], np.float32),
                        beta=np.asarray(sd[f'{nkey}.bias'], np.float32),
                        ng=_num_groups(b, C))

        reps, idx = [], 0
        for r in range(repeat):
            ops = []
            if separable:
                w_dw = _kernel(sd[f'{key}.mconv.{idx}.conv.weight'])
                w_pw = _kernel(sd[f'{key}.mconv.{idx + 1}.conv.weight'])
                idx += 2
                C_in = w_pw.shape[1] * groups  # pw kernel [1, C/g, out]
                if heads != -1:
                    # [k, 1, heads] -> full depthwise [k, 1, C]: channel c
                    # uses filter c % heads.
                    w_dw = np.tile(w_dw, (1, 1, C_in // heads))
                ops.append(dict(k=kernel, s=stride, d=dilation, pad=pad,
                                w=w_dw, b=None, depthwise=True, mask=mask,
                                fgc=C_in))
                if batch_norm:
                    g, bias = _bn_fold(sd, f'{key}.mconv.{idx}')
                    w_pw, b_pw = w_pw * g[None, None, :], bias
                else:
                    b_pw = None
                ops.append(dict(k=1, s=1, d=1, pad=0, w=w_pw, b=b_pw,
                                depthwise=False, mask=mask, fgc=groups))
            else:
                w = _kernel(sd[f'{key}.mconv.{idx}.conv.weight'])
                idx += 1
                if batch_norm:
                    g, bias = _bn_fold(sd, f'{key}.mconv.{idx}')
                    w, b_c = w * g[None, None, :], bias
                else:
                    b_c = None
                ops.append(dict(k=kernel, s=stride, d=dilation, pad=pad,
                                w=w, b=b_c, depthwise=False, mask=mask,
                                fgc=groups))
            reps.append(dict(ops=ops, norm=norm_desc(f'{key}.mconv.{idx}',
                                                     planes)))
            # the norm, a GroupShuffle slot, act + dropout but after the last
            idx += 1 + (groups > 1) + 2 * (r < repeat - 1)
        res = None
        if residual:
            # Residual 1x1 branches are plain convs (groups 1, no heads, no
            # GroupShuffle), as the reference builds them.
            res = []
            j = 0
            while f'{key}.res.{j}.0.conv.weight' in sd:
                w = _kernel(sd[f'{key}.res.{j}.0.conv.weight'])
                if batch_norm:
                    g, bias = _bn_fold(sd, f'{key}.res.{j}.1')
                    entry = dict(w=w * g[None, None, :], b=bias, norm=None,
                                 fgc=1)
                else:
                    entry = dict(w=w, b=None,
                                 norm=norm_desc(f'{key}.res.{j}.1', planes),
                                 fgc=1)
                res.append(entry)
                j += 1
        blocks.append(dict(reps=reps, res=res,
                           residual_mode=b.get('residual_mode', 'add'),
                           activation=b.get('activation', 'relu'),
                           dense=bool(b.get('residual_dense', False)),
                           mask=mask, groups=groups))
    head = (_kernel(sd['final_layer.0.weight']),
            np.asarray(sd['final_layer.0.bias'], np.float32))
    return blocks, head


def _copy_fold(blocks):
    """The descriptors as new dicts (arrays shared), so that the streamer's
    bookkeeping never writes into the caller's fold."""
    out = []
    for blk in blocks:
        blk = dict(blk)
        blk['reps'] = [dict(ops=[dict(op) for op in rep['ops']],
                            norm=None if rep['norm'] is None
                            else dict(rep['norm']))
                       for rep in blk['reps']]
        if blk['res'] is not None:
            blk['res'] = [dict(e, norm=None if e['norm'] is None
                               else dict(e['norm'])) for e in blk['res']]
        out.append(blk)
    return out


class JasperStreamState(NamedTuple):
    """Carries between chunks, on the streamer's device, batch leading."""
    preemph_last: torch.Tensor
    fe_carry: torch.Tensor
    conv_carries: tuple      # per main-chain op, [B, c, C]
    fifos: tuple             # per residual branch, [B, c, C]
    norm_count: torch.Tensor
    norm_sum: torch.Tensor
    norm_sumsq: torch.Tensor
    gnorms: tuple = ()       # per runtime norm, (count [B, 1], sum, sumsq)


def _grouped_1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped pointwise conv of ``x [B, t, C]`` with ``w [fgc, C/fgc,
    out/fgc]`` (output channel ``o`` reads input group ``o // (out /
    fgc)``, the flax grouped-conv layout), one product a group."""
    fgc, cg, og = w.shape
    if fgc == 1:
        return torch.matmul(x, w[0])
    B, t, _ = x.shape
    xg = x.reshape(B * t, fgc, cg).transpose(0, 1)
    return torch.bmm(xg, w).transpose(0, 1).reshape(B, t, fgc * og)


class StreamingJasper(_FrontendStreaming):
    """Chunked stateful Jasper / QuartzNet inference; the session API of
    ``StreamingWav2Letter`` (``start()`` returns a ``StreamingSession``).
    Emits eval-mode softmax probabilities, as the offline ``Jasper`` does.

    Parameters
    ----------
    jasper_blocks : the config's blocks, truncated to the model's depth.
    num_labels : output labels (blank at 0).
    model : the port's ``Jasper`` or its state dict (``fold_jasper``); may
        be None when ``folded`` is given.
    frontend : the offline ``SpectrogramFrontend``; moved to ``device``.
    chunk_frames : steady-state chunk in STFT frames (divisible by the
        model's total stride).
    norm : 'precomputed' (fixed statistics) or 'cumulative'.
    norm_stats : (mean [M], std [M]) for 'precomputed'.
    weights : 'f32', 'int8' or 'int8_full'; int8 quantizes whichever fold
        is used, at construction.
    folded : a pre-folded ``(blocks, head)`` pair (``fold_jasper``, or an
        artifact's from ``export.load_serving``).
    int8_depthwise : with 'int8_full', run the depthwise convs on int8
        activations too (an integer tap loop; off by default, as in JAX,
        where it only adds quantize traffic).
    device : where the phases run (default the card).
    """

    emits_probs = True  # (Wav2Letter sessions emit log-probs)

    def __init__(self, jasper_blocks, num_labels: int, model, frontend,
                 chunk_frames: int = 64, norm: str = 'cumulative',
                 norm_stats=None, weights: str = 'f32', folded=None,
                 int8_depthwise: bool = False, device='cuda'):
        self.num_labels = num_labels
        self._init_frontend(frontend, norm, norm_stats, chunk_frames, device)
        self._blocks_cfg = [dict(b) for b in jasper_blocks]
        if folded is None:
            folded = fold_jasper(model, self._blocks_cfg)
        blocks, self._head = folded
        self._blocks = _copy_fold(blocks)
        if weights not in ('f32', 'int8', 'int8_full'):
            raise ValueError(f'unknown weights mode: {weights!r}')
        self._int8 = weights in ('int8', 'int8_full')
        self._act_int8 = weights == 'int8_full'
        self._int8_dw = bool(int8_depthwise)

        # Main-chain specs (1x1 residual branches never change frame
        # counts; norms and shuffles are frame-local).
        specs = [self._fe_spec]
        for blk in self._blocks:
            for rep in blk['reps']:
                for op in rep['ops']:
                    specs.append(_LayerSpec(op['k'], op['s'], op['d'],
                                            op['pad'], 'zeros'))
        specs.append(_LayerSpec(1, 1, 1, 0, 'zeros'))  # head
        self._specs = specs
        self.scale = int(np.prod([sp.stride for sp in specs[1:]]))
        if chunk_frames % self.scale:
            raise ValueError(f'chunk_frames must be divisible by the total '
                             f'stride {self.scale}')

        plan = None
        fp = chunk_frames
        while plan is None:
            fp += 1
            if fp > 1 << 16:
                raise ValueError('no feasible prime window')
            plan = _plan(specs, fp * self.hop, self.chunk_samples)
        self.prime_frames = fp
        self.prime_samples = fp * self.hop
        self._carries, self._prime_outs, self._chunk_outs = plan
        self.prime_out = self._prime_outs[-1]
        self.chunk_out = self._chunk_outs[-1]
        la = 0
        for sp in reversed(specs[1:]):
            la = la * sp.stride + (sp.ctx - sp.left)
        self.lookahead_frames = la
        self._set_fin_zeros(self._carries[0])

        # Per-op stream bookkeeping: the prime input count and the float
        # length coefficients len = a * flen + b of each op's INPUT stream
        # (the reference's MaskedConv length chain; dyadic, exact in
        # float32). Runtime norms record their input stream's (a, b,
        # prime) so that the finish can leave invalid tail frames out of
        # the cumulative statistics.
        a, b = 1.0, 0.0
        idx = 1  # specs index (0 is the frontend)
        prime_in = self._prime_outs[0]
        norm_i = 0
        for blk in self._blocks:
            for rep in blk['reps']:
                for op in rep['ops']:
                    op['len_a'], op['len_b'] = a, b
                    op['prime_in'] = prime_in
                    if op['mask']:
                        c0 = 2 * op['pad'] - op['d'] * (op['k'] - 1) - 1
                        a, b = a / op['s'], (b + c0) / op['s'] + 1.0
                    prime_in = self._prime_outs[idx]
                    idx += 1
                if rep['norm'] is not None:
                    rep['norm']['len'] = (a, b, prime_in)
                    rep['norm']['idx'] = norm_i
                    norm_i += 1
            if blk['res'] is not None:
                for entry in blk['res']:
                    if entry['norm'] is not None:
                        # 1x1 masked convs keep lengths; the FIFO aligns
                        # emission with the main path, so the valid count
                        # at the add site applies.
                        entry['norm']['len'] = (a, b, prime_in)
                        entry['norm']['idx'] = norm_i
                        norm_i += 1
        self._len_coeffs_head = (a, b)
        self._norm_descs = [rep['norm'] for blk in self._blocks
                            for rep in blk['reps']
                            if rep['norm'] is not None]
        self._norm_descs += [e['norm'] for blk in self._blocks
                             if blk['res'] for e in blk['res']
                             if e['norm'] is not None]
        self._norm_descs.sort(key=lambda d: d['idx'])

        # Finish flush: zero feature frames appended so that every valid
        # head frame drains, at the largest possible tail.
        x_max = fp + chunk_frames + 1
        rem_max = int(a * x_max + b) - self.prime_out
        z = 0
        while True:
            q, ok = self._fin_frames + z, True
            for sp, carry in zip(specs[1:], self._carries[1:]):
                q = (carry + q - sp.ctx - 1) // sp.stride + 1
                if q < 1:
                    ok = False
                    break
            if ok and q >= rem_max:
                self._fin_flush = z
                self._fin_out = q
                break
            z += self.scale

        ops_w = [(op['w'], op['b']) for blk in self._blocks
                 for rep in blk['reps'] for op in rep['ops']]
        res_w = [(e['w'], e['b']) for blk in self._blocks if blk['res']
                 for e in blk['res']]
        head_w = self._head
        if self._int8:
            ops_w = quantize_folded(ops_w)
            res_w = quantize_folded(res_w)
            head_w = quantize_folded([head_w])[0]
        ops = [op for blk in self._blocks for rep in blk['reps']
               for op in rep['ops']]
        res = [e for blk in self._blocks if blk['res'] for e in blk['res']]
        dev = self.device
        wh, bh = _materialize(head_w, 'cpu')
        # On the device once, each in the layout its product reads; every
        # phase takes them as an argument.
        self._weights_dev = {
            'ops': [self._op_weights(op, wb) for op, wb in zip(ops, ops_w)],
            'res': [_grouped(*_materialize(wb, 'cpu'), e['fgc'], dev)
                    for e, wb in zip(res, res_w)],
            'head': (wh[0].contiguous().to(dev), bh.to(dev)),
            'norms': [(_tensor(d['gamma'], dev), _tensor(d['beta'], dev))
                      for d in self._norm_descs]}
        self._prime_fn = self._prime
        self._step_fn = self._step
        self._finish_fn = self._finish

    def _op_weights(self, op: dict, wb) -> tuple:
        """One main-chain op's device weights: K4's ``[K, C]`` (depthwise),
        the grouped ``[fgc, C/fgc, out/fgc]`` (1x1) or ``F.conv1d``'s
        ``[out, C/fgc, k]``, then the bias; under int8_full the int8
        operands of ``conv_q8_valid`` (one a group) or the depthwise taps
        as int32 ``[K, C]``, then the scales and the bias."""
        dev = self.device
        if self._act_int8 and (self._int8_dw or not op['depthwise']):
            q, w_scale = wb[0], _tensor(wb[1], dev)
            b = None if wb[2] is None else _tensor(wb[2], dev)
            if op['depthwise']:
                return (torch.from_numpy(
                    q[:, 0, :].astype(np.int32)).to(dev), w_scale, b)
            k, cin, cout = q.shape
            og = cout // op['fgc']
            # Each group's [k, C_in/fgc, out/fgc] as a view of a contiguous
            # [out/fgc, k * C_in/fgc]: the column-major operand of
            # torch._int_mm (infer.to_device's layout).
            qs = [torch.from_numpy(np.ascontiguousarray(
                q[..., g * og:(g + 1) * og].reshape(k * cin, og).T))
                .to(dev).t().reshape(k, cin, og) for g in range(op['fgc'])]
            return (qs, w_scale, b)
        w, b = _materialize(wb, 'cpu')
        b = None if b is None else b.to(dev)
        if op['depthwise']:
            return (w[:, 0, :].contiguous().to(dev), b)
        if op['k'] == 1 and op['s'] == 1:
            return _grouped(w, b, op['fgc'], dev)
        return (w.permute(2, 1, 0).contiguous().to(dev), b)

    # ------------------------------------------------------------------
    # phase programs (tensors on self.device in, tensors out)
    # ------------------------------------------------------------------

    def _cum_norm(self, gb, desc, h, carry, x_frames):
        """Cumulative group / instance / layer norm over the valid frames
        seen so far. Returns (normalised h, new carry)."""
        gamma, beta = gb
        ng = desc['ng']
        B, t, C = h.shape
        cpg = C // ng
        if x_frames is None:
            valid = h.new_full((B,), float(t))
        else:
            a, b0, prime_in = desc['len']
            valid = torch.clamp(torch.floor(a * x_frames + b0) - prime_in,
                                0.0, float(t))
        m = (torch.arange(t, device=h.device)[None, :]
             < valid[:, None]).to(h.dtype)
        hg = (h * m[:, :, None]).reshape(B, t, ng, cpg)
        cnt, s, ss = carry
        cnt = cnt + valid[:, None] * cpg
        s = s + hg.sum(dim=(1, 3))
        ss = ss + torch.square(hg).sum(dim=(1, 3))
        c = torch.clamp(cnt, min=1.0)
        mean = s / c                                       # [B, ng]
        var = torch.clamp(ss / c - torch.square(mean), min=0.0)  # biased
        scale = (gamma.reshape(1, 1, ng, cpg)
                 / torch.sqrt(var + NORM_EPS)[:, None, :, None])
        y = (h.reshape(B, t, ng, cpg) - mean[:, None, :, None]) * scale \
            + beta.reshape(1, 1, ng, cpg)
        return y.reshape(B, t, C), (cnt, s, ss)

    def _op(self, op: dict, wts: tuple, buf: torch.Tensor) -> torch.Tensor:
        """One main-chain conv, VALID over ``buf [B, T, C]``, bias added."""
        s, d = op['s'], op['d']
        if self._act_int8 and (self._int8_dw or not op['depthwise']):
            q, w_scale, b = wts
            a_scale = dynamic_act_scale(buf)
            xq = quantize_act(buf, a_scale)
            if op['depthwise']:
                out = _int_taps(xq, q, s, d)
            elif len(q) == 1:
                out = conv_q8_valid(xq, q[0], s, d)
            else:
                # conv_q8_valid has no groups: one product a group
                cg = buf.shape[2] // len(q)
                out = torch.cat([conv_q8_valid(xq[..., g * cg:(g + 1) * cg],
                                               qg, s, d)
                                 for g, qg in enumerate(q)], dim=2)
            out = out.to(torch.float32) * (a_scale * w_scale[None, None, :])
        else:
            w, b = wts
            if op['depthwise']:
                out = depthwise_fwd(buf, w, s, d, 0)              # K4
            elif op['k'] == 1 and s == 1:
                out = _grouped_1x1(buf, w)
            else:
                out = F.conv1d(buf.transpose(1, 2), w, stride=s, dilation=d,
                               groups=op['fgc']).transpose(1, 2)
        return out + b if b is not None else out

    def _convs(self, weights, feats, carries, fifos, gnorms,
               x_frames=None):
        """Run the block stack over new frames ``feats [B, n, M]``.
        ``x_frames`` ([B] float32, finish only): prime_frames + tail // hop
        + 1, which drives the per-conv masked-length arithmetic. Returns
        (probabilities [B, n_out, L], carries, fifos, norm statistics)."""
        x = feats
        new_carries, new_fifos = [], []
        new_gnorms = list(gnorms)
        ci = fi = 0
        panes = [x]
        for blk in self._blocks:
            act = _act(blk['activation'])
            block_panes = panes
            h = x
            for r, rep in enumerate(blk['reps']):
                for op in rep['ops']:
                    if op['mask'] and x_frames is not None and (
                            op['k'] > 1 or self._act_int8):
                        # Zero the new frames past this row's length (carry
                        # frames are always valid). A 1x1 conv mixes no
                        # frames, so f32 skips it; int8_full's dynamic
                        # scale is a max over the whole buffer, so it masks
                        # before every op.
                        cnt = torch.floor(op['len_a'] * x_frames
                                          + op['len_b']) - op['prime_in']
                        m = (torch.arange(h.shape[1], device=h.device)[None]
                             < cnt[:, None]).to(h.dtype)
                        h = h * m[:, :, None]
                    if op['k'] > 1 or op['s'] > 1:
                        buf = torch.cat([carries[ci], h], dim=1)
                        ctx = op['d'] * (op['k'] - 1)
                        q = (buf.shape[1] - ctx - 1) // op['s'] + 1
                        new_carries.append(buf[:, q * op['s']:])
                    else:
                        buf = h
                        new_carries.append(carries[ci])  # zero-size
                    h = self._op(op, weights['ops'][ci], buf)
                    ci += 1
                if rep['norm'] is not None:
                    ni = rep['norm']['idx']
                    h, new_gnorms[ni] = self._cum_norm(
                        weights['norms'][ni], rep['norm'], h, gnorms[ni],
                        x_frames)
                if blk['groups'] > 1:
                    h = group_shuffle(h, blk['groups'])
                if r < len(blk['reps']) - 1:
                    h = act(h)
            if blk['res'] is not None:
                take = h.shape[1]
                # Branch inputs as offline: every pane for dense-residual
                # blocks, else the block input.
                branches = block_panes if blk['dense'] \
                    else [block_panes[-1]]
                for pane, entry in zip(branches, blk['res']):
                    w, bias = weights['res'][fi]
                    fifo = torch.cat([fifos[fi], pane], dim=1)
                    rin, new_fifo = fifo[:, :take], fifo[:, take:]
                    new_fifos.append(new_fifo)
                    fi += 1
                    r_out = _grouped_1x1(rin, w)
                    if bias is not None:
                        r_out = r_out + bias
                    if entry['norm'] is not None:
                        ni = entry['norm']['idx']
                        r_out, new_gnorms[ni] = self._cum_norm(
                            weights['norms'][ni], entry['norm'], r_out,
                            gnorms[ni], x_frames)
                    h = h + r_out if blk['residual_mode'] == 'add' \
                        else torch.maximum(h, r_out)
            h = act(h)
            x = h
            panes = panes + [x] if blk['dense'] else [x]
        wh, bh = weights['head']
        logits = torch.matmul(x, wh) + bh
        return (F.softmax(logits, dim=-1), tuple(new_carries),
                tuple(new_fifos), tuple(new_gnorms))

    def _zero_state(self, B: int):
        """Prime-phase carries: each conv's left zero pad; empty FIFOs;
        zeroed cumulative-norm statistics."""
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32,
                               device=self.device)
        carries, fifos = [], []
        ch = self.feat_dim
        pane_ch = [ch]
        for blk in self._blocks:
            for rep in blk['reps']:
                for op in rep['ops']:
                    left = op['pad'] if (op['k'] > 1 or op['s'] > 1) else 0
                    carries.append(zeros(B, left, ch))
                    ch = op['w'].shape[-1]  # dw keeps C; conv/pw -> C_out
            if blk['res'] is not None:
                for c in (pane_ch if blk['dense'] else [pane_ch[-1]]):
                    fifos.append(zeros(B, 0, c))
            pane_ch = pane_ch + [ch] if blk['dense'] else [ch]
        gnorms = tuple((zeros(B, 1), zeros(B, d['ng']), zeros(B, d['ng']))
                       for d in self._norm_descs)
        return tuple(carries), tuple(fifos), gnorms

    @torch.no_grad()
    def _prime(self, weights, audio):
        last, fe_carry, norm_state, feats = self._fe_prime(audio)
        carries, fifos, gnorms = self._zero_state(audio.shape[0])
        probs, carries, fifos, gnorms = self._convs(weights, feats, carries,
                                                    fifos, gnorms)
        return JasperStreamState(last, fe_carry, carries, fifos,
                                 *norm_state, gnorms), probs

    @torch.no_grad()
    def _step(self, weights, state, audio):
        last, fe_carry, norm_state, feats = self._fe_step(
            state.preemph_last, state.fe_carry,
            (state.norm_count, state.norm_sum, state.norm_sumsq), audio)
        probs, carries, fifos, gnorms = self._convs(
            weights, feats, state.conv_carries, state.fifos, state.gnorms)
        return JasperStreamState(last, fe_carry, carries, fifos,
                                 *norm_state, gnorms), probs

    @torch.no_grad()
    def _finish(self, weights, state, tail, tail_lengths):
        """tail: [B, chunk_samples] zero-padded; tail_lengths: [B] int64
        valid samples within it. Returns (probabilities, head frames still
        valid [B])."""
        feats, _ = self._fe_finish(
            state.preemph_last, state.fe_carry,
            (state.norm_count, state.norm_sum, state.norm_sumsq),
            tail, tail_lengths, extra_zero_frames=self._fin_flush)
        xf = (self.prime_frames + tail_lengths // self.hop + 1) \
            .to(torch.float32)
        probs, _, _, _ = self._convs(weights, feats, state.conv_carries,
                                     state.fifos, state.gnorms, x_frames=xf)
        a, b = self._len_coeffs_head
        fin_valid = (torch.floor(a * xf + b).to(torch.int32)
                     - self.prime_out)
        return probs, fin_valid

    def start(self, batch_size: int = 1) -> StreamingSession:
        return StreamingSession(self, batch_size)


def _grouped(w: torch.Tensor, b, fgc: int, device) -> tuple:
    """A 1x1 kernel ``[1, C/fgc, out]`` as ``[fgc, C/fgc, out/fgc]`` on
    ``device``, and its bias."""
    _, cg, out = w.shape
    wg = w[0].reshape(cg, fgc, out // fgc).transpose(0, 1).contiguous()
    return wg.to(device), None if b is None else b.to(device)


def _int_taps(xq: torch.Tensor, q: torch.Tensor, s: int,
              d: int) -> torch.Tensor:
    """int32 accumulators of a VALID depthwise conv of int8 ``xq [B, T,
    C]`` with int32 taps ``q [K, C]``: the K taps added in order (integer
    sums, so equal to any other order)."""
    K = q.shape[0]
    t_out = (xq.shape[1] - d * (K - 1) - 1) // s + 1
    x = xq.to(torch.int32)
    acc = x[:, 0:(t_out - 1) * s + 1:s] * q[0]
    for k in range(1, K):
        acc = acc + x[:, k * d:k * d + (t_out - 1) * s + 1:s] * q[k]
    return acc
