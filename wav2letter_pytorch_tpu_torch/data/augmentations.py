"""Spectrogram augmentations (SpecAugment / SpecCutout), batched, on the
features' device.

Same masks as ``wav2letter_pytorch_tpu.data.augmentations`` on features
[B, T, F]; the random integers come from a ``torch.Generator`` instead of
a JAX key, so the draws differ, but the mask built from given draws is the
same (``band_mask`` / ``rect_mask`` take the draws, so a test can feed them
JAX's). SpecCutout sizes rectangles with ``rect_freq`` on the frequency
axis and ``rect_time`` on the time axis (the original recipe swaps them).
"""

from __future__ import annotations

import torch

from ..parallel.mesh import draw_rows


def band_mask(starts: torch.Tensor, widths: torch.Tensor,
              length: int) -> torch.Tensor:
    """[B, length] bool: inside any band [start, start + width) of the
    [B, M] ``starts``/``widths``."""
    idx = torch.arange(length, device=starts.device)[None, None, :]
    bands = (idx >= starts[:, :, None]) & (idx < (starts + widths)[:, :, None])
    return bands.any(dim=1)


def rect_mask(t0, tw, f0, fw, T: int, F: int) -> torch.Tensor:
    """[B, T, F] bool: inside any of the [B, M] time x frequency
    rectangles."""
    t_idx = torch.arange(T, device=t0.device)[None, None, :]
    f_idx = torch.arange(F, device=f0.device)[None, None, :]
    t_in = (t_idx >= t0[:, :, None]) & (t_idx < (t0 + tw)[:, :, None])
    f_in = (f_idx >= f0[:, :, None]) & (f_idx < (f0 + fw)[:, :, None])
    return (t_in[:, :, :, None] & f_in[:, :, None, :]).any(dim=1)


def _randint(gen, high: int, shape, device) -> torch.Tensor:
    """Integers in [0, high), as ``jax.random.randint(key, shape, 0,
    high)``."""
    return draw_rows(lambda size, generator: torch.randint(
        0, high, size, generator=generator, device=device), shape, gen)


def _draw_bands(gen, length: int, batch: int, n_masks: int, max_width: int,
                device):
    starts = _randint(gen, max(length - max_width, 1), (batch, n_masks),
                      device)
    widths = _randint(gen, max(max_width, 1), (batch, n_masks), device)
    return starts, widths


def spec_augment(gen, feats, freq_masks: int = 1, time_masks: int = 1,
                 freq_width: int = 15, time_width: int = 50):
    """Zero random frequency bands and time bands (arXiv:1904.08779)."""
    B, T, F = feats.shape
    fmask = band_mask(*_draw_bands(gen, F, B, freq_masks, freq_width,
                                   feats.device), F)
    tmask = band_mask(*_draw_bands(gen, T, B, time_masks, time_width,
                                   feats.device), T)
    keep = ~(fmask[:, None, :] | tmask[:, :, None])
    return feats * keep.to(feats.dtype)


def spec_cutout(gen, feats, rect_masks: int = 5, rect_time: int = 60,
                rect_freq: int = 25):
    """Zero random time x frequency rectangles."""
    B, T, F = feats.shape
    shape, dev = (B, rect_masks), feats.device
    t0 = _randint(gen, max(T - rect_time, 1), shape, dev)
    tw = _randint(gen, max(rect_time, 1), shape, dev)
    f0 = _randint(gen, max(F - rect_freq, 1), shape, dev)
    fw = _randint(gen, max(rect_freq, 1), shape, dev)
    return feats * (~rect_mask(t0, tw, f0, fw, T, F)).to(feats.dtype)


def identity(gen, feats):
    """Placeholder, as in the original recipe."""
    return feats


_AUGMENTATIONS = {
    'spec_augment': spec_augment,
    'spec_cutout': spec_cutout,
    'identity': identity,
}


def build_augment_fn(augment_cfg):
    """Compose augmentations from a config block like
    ``{spec_augment: {freq_masks: 2}, spec_cutout: {}}``. Returns
    ``fn(generator, feats) -> feats`` or None when the block is empty or
    every entry is disabled (``False``); ``True``/``None`` mean defaults."""
    if not augment_cfg:
        return None
    steps = []
    for name, kwargs in dict(augment_cfg).items():
        if name not in _AUGMENTATIONS:
            raise ValueError(f'Unknown augmentation {name!r}; options: '
                             f'{sorted(_AUGMENTATIONS)}')
        if kwargs is False:
            continue
        if kwargs is None or kwargs is True:
            kwargs = {}
        steps.append((_AUGMENTATIONS[name], dict(kwargs)))
    if not steps:
        return None

    def apply(gen, feats):
        for fn, kwargs in steps:
            feats = fn(gen, feats, **kwargs)
        return feats

    return apply
