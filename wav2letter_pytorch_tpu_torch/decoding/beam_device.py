"""Batched CTC prefix beam search as torch tensor ops on the eval step's
device.

The counterpart of ``wav2letter_pytorch_tpu.decoding.beam_device`` (an XLA
step program there, plain tensor ops here), with the same functions and
the same strings. The host search (``decoder.prefix_beam_search``) is a
string-keyed DP, serial per utterance; this one runs the same dynamic
program over a whole batch in fixed-shape tensors. A prefix is named by a
pair of 32-bit rolling hashes, and the strings are rebuilt on the host
from per-step (parent, char) backpointers. Its bookkeeping, in log space:

* per-prefix blank/non-blank mass (``p_b`` / ``p_nb``);
* per-step candidate pruning (``step[c] > prune``, the blank included);
* the repeat-character split (extend from blank paths only; same-char
  continuation stays on the shorter prefix);
* the "discarded prefixes" re-merge: an extension that is not among the
  current beams recovers the mass its prefix still holds in the PREVIOUS
  step's pool, so the pool (k·V slots), not just the k beams, is carried
  from step to step;
* the word-count bonus ``(num_words + 1) ** beta`` in the ranking.

LM and hotword fusion (``beam_search_device_lm``) run one step a frame
from a host loop: the device does the mass bookkeeping over the batch, the
host keeps each pool slot's prefix string and looks up (memoised) the LM
bonus ``alpha * ln(lm(prefix))`` and the hotword log-deltas the next step
applies. ``DeviceBeamDecoder(lm_mode='rescore')`` instead runs the LM-free
search and rescores its n-best list on the host.

Details that keep the strings equal to the JAX search's:

* the hashes wrap at 32 bits: they are int64 tensors reduced
  ``& 0xFFFFFFFF`` after every multiply-add, and the multiply is split in
  16-bit halves so no int64 product overflows;
* the top k is a stable descending sort, so ties go to the lower index
  as ``jax.lax.top_k`` sends them (``torch.topk`` promises no order);
* dead slots hold ``NEG_INF = -1e30``, never ``-inf``, so ``logaddexp``
  and ``logsumexp`` over them give the same finite values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import resolve_device
from .arpa_lm import load_lm
from .decoder import (DEFAULT_BEAM_ALPHA, DEFAULT_BEAM_BETA, DEFAULT_BEAM_K,
                      DEFAULT_BEAM_PRUNE, Decoder, HotwordTrie,
                      _beam_offsets)

NEG_INF = -1e30
# Two independent multiplicative rolling hashes; matches are also gated on
# liveness, and both 32-bit hashes must agree.
_H1_MULT = 0x9E3779B1
_H2_MULT = 0x85EBCA77
_MASK32 = 0xFFFFFFFF


def _log(x):
    return float(np.log(x)) if x > 0 else -np.inf


def _masks(labels):
    sep_mask = tuple(int(ch in ' |>') for ch in labels)
    word_mask = tuple(int(ch.isalnum() or ch == '_') for ch in labels)
    return sep_mask, word_mask


def _mul32(h: torch.Tensor, mult: int) -> torch.Tensor:
    """``h * mult mod 2**32`` for int64 ``h`` in [0, 2**32): the product
    split at bit 16, each part below 2**48."""
    lo = (h & 0xFFFF) * mult
    hi = ((h >> 16) * mult) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties to the
    lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def _pool_init(P, B: int = 1, device='cpu'):
    """The pool before the first frame: slot 0 is '' with p_b = 1."""
    def full(value, dtype):
        return torch.full((B, P), value, dtype=dtype, device=device)
    pb = full(NEG_INF, torch.float32)
    pb[:, 0] = 0.0
    pnb = full(NEG_INF, torch.float32)
    h1 = full(0, torch.int64)
    h1[:, 0] = 1
    h2 = h1.clone()
    wc = full(0, torch.int32)
    lastc = full(-1, torch.int64)
    alive = full(False, torch.bool)
    alive[:, 0] = True
    has_char = full(False, torch.bool)  # prefix has any non-space char
    return pb, pnb, h1, h2, wc, lastc, alive, has_char


def _mask_tail_steps(lp, lengths, blank):
    """Steps past a sample's length must be identity on the beam state: a
    deterministic blank (log-prob 0) only moves p_nb mass into p_b,
    leaving every prefix's total and the ranking unchanged."""
    T, V = lp.shape[-2], lp.shape[-1]
    blank_row = torch.full((V,), NEG_INF, dtype=lp.dtype, device=lp.device)
    blank_row[blank] = 0.0
    t_ix = torch.arange(T, device=lp.device)
    valid = t_ix[None, :, None] < lengths.to(lp.device)[:, None, None]
    return torch.where(valid, lp, blank_row)


def _rank(pb, pnb, wc, alive, beta):
    score = torch.logaddexp(pb, pnb)
    return torch.where(alive, score + beta * torch.log(wc.float() + 1.0),
                       NEG_INF), score


def _make_step(k, blank, beta, log_prune, sep_mask, word_mask,
               space_ix: int, use_lm: bool, use_hw: bool = False,
               device='cpu'):
    """Build the batched DP step:
    (carry, lp_t [B, V], lm_add [B, P], hw_add [B, P, V-1]) ->
    (carry, (parent [B, P], char [B, P])).

    ``lm_add[b, slot]`` = alpha*ln(lm(prefix of the slot, stripped)):
    added to non-repeat SPACE extensions of prefixes that hold a word
    character, where the host DP multiplies ``lm(l_plus)**alpha`` (the
    re-merge terms stay LM-free, as there). Ignored unless ``use_lm``.

    ``hw_add[b, slot, j]`` = the hotword log-delta of extending the slot's
    prefix with non-blank char ``cs[j]`` (``ln trie.extend`` for ordinary
    chars, ``ln trie.complete`` for the space): added to EVERY extension
    contribution (repeat and non-repeat), where the host DP multiplies
    ``w_h``; continuation and re-merge terms stay unweighted. Ignored
    unless ``use_hw``.
    """
    V = len(sep_mask)
    sep = torch.tensor(sep_mask, dtype=torch.bool, device=device)
    word = torch.tensor(word_mask, dtype=torch.bool, device=device)
    cs = torch.tensor([c for c in range(V) if c != blank], dtype=torch.int64,
                      device=device)
    P = k * V
    sep_cs = sep[cs][None, None, :]
    is_space = (cs == space_ix)[None, None, :]
    cs3 = cs[None, None, :]
    cs_hash = cs3 + 1
    char_tail = cs.repeat(k)

    def step(carry, lp_t, lm_add, hw_add):
        pb, pnb, h1, h2, wc, lastc, alive, has_char = carry
        B = pb.shape[0]
        rank, _ = _rank(pb, pnb, wc, alive, beta)
        bidx = _top_k(rank, k)                             # [B, k]
        bpb, bpnb = pb.gather(1, bidx), pnb.gather(1, bidx)
        bh1, bh2 = h1.gather(1, bidx), h2.gather(1, bidx)
        bwc, blast = wc.gather(1, bidx), lastc.gather(1, bidx)
        balive, bhas = alive.gather(1, bidx), has_char.gather(1, bidx)
        prev_total = torch.logaddexp(bpb, bpnb)

        lpb = lp_t[:, blank:blank + 1]                      # [B, 1]
        blank_ok = lpb > log_prune

        # ---- keep slots: the beam's own prefix at step t -----------
        keep_pb = torch.where(balive & blank_ok, lpb + prev_total, NEG_INF)
        blast0 = blast.clamp(min=0)
        rep_lp = lp_t.gather(1, blast0)
        rep_ok = balive & (blast >= 0) & (rep_lp > log_prune)
        keep_pnb = torch.where(rep_ok, rep_lp + bpnb, NEG_INF)

        # ---- extension slots: beam i extended with char c ----------
        lc = lp_t[:, cs]                                    # [B, V-1]
        active = lc > log_prune
        is_rep = cs3 == blast[:, :, None]                   # [B, k, V-1]
        base = torch.where(is_rep, bpb[:, :, None],
                           prev_total[:, :, None]) + lc[:, None, :]
        if use_hw:
            base = base + hw_add.gather(
                1, bidx[:, :, None].expand(B, k, V - 1))
        if use_lm:
            fuse = ~is_rep & bhas[:, :, None] & is_space
            base = base + torch.where(
                fuse, lm_add.gather(1, bidx)[:, :, None], 0.0)
        ext_alive = balive[:, :, None] & active[:, None, :]
        contrib = torch.where(ext_alive, base, NEG_INF)
        eh1 = (_mul32(bh1, _H1_MULT)[:, :, None] + cs_hash) & _MASK32
        eh2 = (_mul32(bh2, _H2_MULT)[:, :, None] + cs_hash) & _MASK32

        # extension == an existing beam? -> its mass goes to that beam's
        # keep slot instead.
        m_keep = ((eh1[..., None] == bh1[:, None, None, :])
                  & (eh2[..., None] == bh2[:, None, None, :])
                  & balive[:, None, None, :] & ext_alive[..., None])
        in_beams = m_keep.any(-1)
        inc = torch.logsumexp(
            torch.where(m_keep, contrib[..., None], NEG_INF), dim=(1, 2))
        keep_pnb = torch.logaddexp(keep_pnb, inc)

        # re-merge vs the full previous pool (discarded prefixes).
        m_pool = ((eh1[..., None] == h1[:, None, None, :])
                  & (eh2[..., None] == h2[:, None, None, :])
                  & alive[:, None, None, :] & ext_alive[..., None]
                  & ~in_beams[..., None])
        prev_pb_m = torch.logsumexp(
            torch.where(m_pool, pb[:, None, None, :], NEG_INF), dim=-1)
        prev_pnb_m = torch.logsumexp(
            torch.where(m_pool, pnb[:, None, None, :], NEG_INF), dim=-1)
        dead_ext = in_beams | ~ext_alive
        ext_pb = torch.where(
            dead_ext, NEG_INF,
            lpb[:, :, None] + torch.logaddexp(prev_pb_m, prev_pnb_m))
        ext_pnb = torch.where(
            dead_ext, NEG_INF,
            torch.logaddexp(contrib, lc[:, None, :] + prev_pnb_m))

        # word bookkeeping: a separator right after a word char completes
        # a word (the host DP's _WORD_RE = \w+[\s|>]).
        last_is_word = (blast >= 0) & word[blast0]
        ext_wc = bwc[:, :, None] + (sep_cs & last_is_word[:, :, None]).to(
            torch.int32)
        ext_lastc = cs3.expand(B, k, V - 1)
        ext_has = bhas[:, :, None] | ~is_space

        def flat(a):
            return a.reshape(B, k * (V - 1))
        new = (
            torch.cat([keep_pb, flat(ext_pb)], 1),
            torch.cat([keep_pnb, flat(ext_pnb)], 1),
            torch.cat([bh1, flat(eh1)], 1),
            torch.cat([bh2, flat(eh2)], 1),
            torch.cat([bwc, flat(ext_wc)], 1),
            torch.cat([blast, flat(ext_lastc)], 1),
            torch.cat([balive, flat(~dead_ext)], 1),
            torch.cat([bhas, flat(ext_has)], 1),
        )
        parent = torch.cat([bidx, bidx.repeat_interleave(V - 1, dim=1)], 1)
        char = torch.cat([torch.full((B, k), -1, dtype=torch.int64,
                                     device=cs.device),
                          char_tail.expand(B, k * (V - 1))], 1)
        return new, (parent, char)

    return step, P


def _final_rank(carry, beta, k):
    """(top slots [B, k], their ranks, their scores) of the final pool."""
    pb, pnb, _, _, wc, _, alive, _ = carry
    rank, score = _rank(pb, pnb, wc, alive, beta)
    top_idx = _top_k(rank, k)
    return top_idx, rank.gather(1, top_idx), score.gather(1, top_idx)


def _as_log_probs(log_probs, lengths):
    """(float32 [B, T, V] tensor, int64 [B] lengths) on the device of
    ``log_probs`` (the CPU for numpy input)."""
    lp = torch.as_tensor(log_probs).to(torch.float32)
    return lp, torch.as_tensor(lengths).to(lp.device, torch.int64)


def _check_labels(labels):
    labels = list(labels)
    if '>' in labels:
        raise ValueError("device beam search does not support an end_char "
                         "('>') label; use the host search")
    return labels


def _search(lp, lengths, *, k, blank, beta, log_prune, sep_mask, word_mask):
    """lp: [B, T, V] log-probabilities. Returns the backpointer tables
    [B, T, P] and the final pool's top slots, ranks and scores (LM-free:
    every frame stays on the device)."""
    B, T, _ = lp.shape
    step, P = _make_step(k, blank, beta, log_prune, sep_mask, word_mask,
                         space_ix=-1, use_lm=False, device=lp.device)
    lp = _mask_tail_steps(lp, lengths, blank)
    carry = _pool_init(P, B, lp.device)
    parents = torch.empty((B, T, P), dtype=torch.int64, device=lp.device)
    chars = torch.empty((B, T, P), dtype=torch.int64, device=lp.device)
    for t in range(T):
        carry, (parent, char) = step(carry, lp[:, t], None, None)
        parents[:, t] = parent
        chars[:, t] = char
    return (parents, chars) + _final_rank(carry, beta, k)


def _backtrace(parents, chars, slot):
    """Walk (parent, char) tables backwards from ``slot`` at the last step."""
    out = []
    s = int(slot)
    for t in range(parents.shape[0] - 1, -1, -1):
        c = int(chars[t, s])
        if c >= 0:
            out.append(c)
        s = int(parents[t, s])
    out.reverse()
    return out


def beam_search_device(log_probs, lengths, labels, k: int = 5,
                       beta: float = 5.0, prune: float = 1e-3,
                       blank_index: int = 0, n_best: int = 1):
    """Batched CTC prefix beam search (LM-free) on the device of
    ``log_probs`` (a tensor; numpy input runs on the CPU).

    Args:
        log_probs: [B, T, V] log-probabilities (natural log).
        lengths: [B] valid frame counts.
        labels: label list aligned with V (blank at ``blank_index``).
        n_best: how many hypotheses to materialize per sample.
    Returns:
        list (len B) of lists of (ids, log_score, log_rank) tuples, best
        first; ``ids`` is the decoded label-id sequence.
    """
    labels = _check_labels(labels)
    sep_mask, word_mask = _masks(labels)
    lp, lengths = _as_log_probs(log_probs, lengths)
    parents, chars, top_idx, ranks, scores = _search(
        lp, lengths, k=int(k), blank=int(blank_index), beta=float(beta),
        log_prune=_log(prune), sep_mask=sep_mask, word_mask=word_mask)
    # One copy of the backpointers to the host.
    host = torch.stack([parents, chars]).to(torch.int32).cpu().numpy()
    parents, chars = host[0], host[1]
    top_idx = top_idx.cpu().numpy()
    ranks = ranks.cpu().numpy()
    scores = scores.cpu().numpy()
    results = []
    for b in range(lp.shape[0]):
        hyps = []
        for j in range(min(n_best, top_idx.shape[1])):
            ids = _backtrace(parents[b], chars[b], top_idx[b, j])
            hyps.append((ids, float(scores[b, j]), float(ranks[b, j])))
        results.append(hyps)
    return results


def beam_search_device_lm(log_probs, lengths, labels, lm=None, k: int = 5,
                          alpha: float = 0.3, beta: float = 5.0,
                          prune: float = 1e-3, blank_index: int = 0,
                          hotwords=None, hotword_weight: float = 2.0):
    """EXACT in-loop LM and/or hotword fusion on the device of
    ``log_probs`` (numpy input runs on the CPU).

    A host loop runs one batched DP step a frame. After each step one
    pinned buffer brings (parent, char, alive) [B, P] to the host (one
    synchronisation a frame); the host advances the pool's prefix strings
    and refreshes (a) the per-slot LM bonus
    ``alpha * ln(lm(prefix.strip(' ')))`` the NEXT step applies to its
    space extensions and (b) the per-slot-per-char hotword log-delta table
    (``ln trie.extend`` per char, ``ln trie.complete`` on the space
    column) it applies to every extension, both memoised. The math is the
    host ``prefix_beam_search``'s with the same ``lm``/``hotwords``.

    ``lm``: callable str -> probability (the host DP contract), or None.
    Returns: list (len B) of decoded strings.
    """
    labels = _check_labels(labels)
    sep_mask, word_mask = _masks(labels)
    space_ix = labels.index(' ') if ' ' in labels else -1
    k = int(k)
    use_lm = lm is not None
    trie = None
    if hotwords is not None:
        trie = hotwords if isinstance(hotwords, HotwordTrie) \
            else HotwordTrie(hotwords, hotword_weight)
    lp, lengths = _as_log_probs(log_probs, lengths)
    dev = lp.device
    B, T, V = lp.shape
    step, P = _make_step(k, int(blank_index), float(beta), _log(prune),
                         sep_mask, word_mask, space_ix, use_lm=use_lm,
                         use_hw=trie is not None, device=dev)
    lp = _mask_tail_steps(lp, lengths, int(blank_index))
    carry = _pool_init(P, B, dev)

    pin = dev.type == 'cuda'
    stage = torch.empty((3, B, P), dtype=torch.int32, device=dev)
    host = torch.empty((3, B, P), dtype=torch.int32, pin_memory=pin)
    host_np = host.numpy()
    # Host-side pool mirrors: the prefix string of every live slot and the
    # memoised LM-bonus / hotword-delta tables, uploaded before each step.
    strings = [[''] * P for _ in range(B)]
    lm_add_t = torch.zeros((B, P), dtype=torch.float32, pin_memory=pin)
    lm_add_h = lm_add_t.numpy()
    memo: dict = {}
    ln = np.log

    def bonus(s: str) -> float:
        hit = memo.get(s)
        if hit is None:
            p = lm(s)
            hit = float(alpha * ln(p)) if p > 0 else NEG_INF
            memo[s] = hit
        return hit

    hw_add_t = hw_add_h = None
    if trie is not None:
        # Hotword delta rows, memoised per in-progress-word partial (the
        # delta depends only on the chars after the prefix's last space),
        # from the same HotwordTrie methods the host DP multiplies.
        cs_host = [c for c in range(V) if c != blank_index]
        hw_add_t = torch.zeros((B, P, V - 1), dtype=torch.float32,
                               pin_memory=pin)
        hw_add_h = hw_add_t.numpy()
        hw_memo: dict = {}

        def hw_row(partial: str):
            # Every non-empty partial that no hotword starts with has the
            # same row (all zeros: no credit to gain or cancel), so they
            # share one memo entry.
            key = partial if not partial or trie.units(partial) else None
            row = hw_memo.get(key)
            if row is None:
                row = np.asarray(
                    [ln(trie.complete(partial)) if labels[ci] == ' '
                     else ln(trie.extend(partial, labels[ci]))
                     for ci in cs_host], np.float32)
                hw_memo[key] = row
            return row

        # The root prefix '' is live before the first frame: its
        # extensions already earn first-character credit.
        hw_add_h[:, 0, :] = hw_row('')
    for t in range(T):
        lm_add = lm_add_t.to(dev, non_blocking=True) if use_lm else None
        hw_add = hw_add_t.to(dev, non_blocking=True) \
            if trie is not None else None
        carry, (parent, char) = step(carry, lp[:, t], lm_add, hw_add)
        stage[0] = parent
        stage[1] = char
        stage[2] = carry[6]
        host.copy_(stage, non_blocking=pin)
        if pin:
            torch.cuda.current_stream(dev).synchronize()
        parent_h, char_h, alive_h = host_np
        for b in range(B):
            prev = strings[b]
            row = parent_h[b]
            crow = char_h[b]
            live = np.flatnonzero(alive_h[b])
            new = [''] * P
            for s in live.tolist():
                c = crow[s]
                new[s] = prev[row[s]] if c < 0 else prev[row[s]] + labels[c]
            strings[b] = new
            if use_lm:
                # Next step's LM bonus: the boundary factor is
                # lm((prefix + ' ').strip(' ')) == lm(prefix.strip(' ')).
                add = lm_add_h[b]
                add[:] = 0.0
                for s in live.tolist():
                    if new[s].replace(' ', ''):
                        add[s] = bonus(new[s].strip(' '))
            if trie is not None and live.size:
                hw_add_h[b, live] = np.stack(
                    [hw_row(new[s].rsplit(' ', 1)[-1]) for s in live.tolist()])

    top_idx = _final_rank(carry, float(beta), k)[0][:, 0].cpu().numpy()
    return [strings[b][int(top_idx[b])] for b in range(B)]


class DeviceBeamDecoder:
    """Decoder API over the batched device search.

    An alternative to PrefixBeamSearchLMDecoder for a batch that is on the
    device: the whole batch is searched at once. With an LM,
    ``lm_mode='fused'`` (default) runs the exact in-loop word-boundary
    fusion (``beam_search_device_lm``); ``lm_mode='rescore'`` runs the
    LM-free search and rescores the n-best list on the host
    (``rank + alpha*ln10*lm.score(text)``), an approximation without the
    per-frame host loop. ``decode`` takes numpy probabilities (the
    reference decoder contract) and searches on ``device``;
    ``decode_log_probs`` takes the eval step's log-probabilities where
    they lie.
    """

    def __init__(self, labels, blank_index: int = 0, k: int = None,
                 alpha: float = None, beta: float = None, prune: float = None,
                 lm_path: str = '', n_best: int = 8,
                 lm_mode: str = 'fused', hotwords=None,
                 hotword_weight: float = 2.0, device='cuda'):
        k = DEFAULT_BEAM_K if k is None else k
        alpha = DEFAULT_BEAM_ALPHA if alpha is None else alpha
        beta = DEFAULT_BEAM_BETA if beta is None else beta
        prune = DEFAULT_BEAM_PRUNE if prune is None else prune
        self._base = Decoder(list(labels), blank_index)
        self.labels = self._base.labels
        self.blank_index = blank_index
        self.k, self.alpha, self.beta, self.prune = k, alpha, beta, prune
        self.n_best = n_best
        if lm_mode not in ('fused', 'rescore'):
            raise ValueError(f'unknown lm_mode: {lm_mode!r}')
        self.lm_mode = lm_mode
        self.device = resolve_device(device)
        self._lm = load_lm(lm_path) if lm_path else None
        self.trie = None
        if hotwords is not None:
            if lm_mode == 'rescore':
                raise ValueError(
                    'hotword biasing needs in-loop fusion: use '
                    "lm_mode='fused' (n-best rescoring cannot recover "
                    'hypotheses the unbiased search pruned)')
            self.trie = hotwords if isinstance(hotwords, HotwordTrie) \
                else HotwordTrie(hotwords, hotword_weight)

    # WER/CER surface (the shared Decoder math)
    def wer(self, *a, **k):
        return self._base.wer(*a, **k)

    def cer(self, *a, **k):
        return self._base.cer(*a, **k)

    def wer_ratio(self, *a, **k):
        return self._base.wer_ratio(*a, **k)

    def cer_ratio(self, *a, **k):
        return self._base.cer_ratio(*a, **k)

    def decode_log_probs(self, log_probs, sizes) -> list[str]:
        """[B, T, V] natural-log probabilities (a tensor, searched on its
        device) -> one string a sample."""
        if (self._lm is not None and self.lm_mode == 'fused') \
                or self.trie is not None:
            lm_prob = None if self._lm is None \
                else (lambda s: 10.0 ** self._lm.score(s))
            return beam_search_device_lm(
                log_probs, sizes, self.labels, lm_prob, k=self.k,
                alpha=self.alpha, beta=self.beta, prune=self.prune,
                blank_index=self.blank_index, hotwords=self.trie)
        n_best = self.n_best if self._lm is not None else 1
        results = beam_search_device(log_probs, sizes, self.labels, k=self.k,
                                     beta=self.beta, prune=self.prune,
                                     blank_index=self.blank_index,
                                     n_best=n_best)
        out = []
        ln10 = float(np.log(10.0))
        for hyps in results:
            if self._lm is None:
                best = hyps[0][0]
            else:
                def rescored(h):
                    ids, _, log_rank = h
                    text = ''.join(self.labels[i] for i in ids).strip()
                    return log_rank + self.alpha * ln10 * \
                        self._lm.score(text)
                best = max(hyps, key=rescored)[0]
            out.append(''.join(self.labels[i] for i in best))
        return out

    def decode(self, probs, sizes=None, return_offsets: bool = False):
        """probs: [B, T, V] or [T, V] label PROBABILITIES (numpy). Returns
        decoded strings (a single string for 2-D input); with
        ``return_offsets``, also per-char frame offsets from forced
        alignment of each hypothesis (decoder._beam_offsets).
        """
        probs = np.asarray(probs)
        squeeze = probs.ndim == 2
        if squeeze:
            probs = probs[None]
        B, T, _ = probs.shape
        sizes = np.full((B,), T, np.int32) if sizes is None \
            else np.asarray(sizes, np.int32)
        lp = torch.from_numpy(np.log(np.clip(probs, 1e-30, None))).to(
            self.device)
        out = self.decode_log_probs(lp, sizes)
        if return_offsets:
            offs = [_beam_offsets(probs[b, :sizes[b]], out[b], self.labels,
                                  self.blank_index) for b in range(B)]
            if squeeze:
                return out[0], offs[0]
            return out, offs
        return out[0] if squeeze else out
