"""The port's SpecAugment / SpecCutout vs the JAX package.

The two draw their random integers differently (a torch.Generator vs a
JAX key), so the masks are compared given JAX's own draws: the test
replays the JAX functions' key splits to get their integers, builds the
port's masks from them, and the result must equal JAX's output exactly.
The port's own draws are checked for their bounds, and the composition
and error rules of ``tests/test_augmentations.py`` for the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2letter_pytorch_tpu.data import augmentations as jax_aug
from wav2letter_pytorch_tpu_torch.data.augmentations import (band_mask,
                                                             build_augment_fn,
                                                             rect_mask,
                                                             spec_augment,
                                                             spec_cutout)

torch.set_num_threads(1)

B, T, F = 3, 100, 64


def _jax_bands(key, length, n_masks, max_width):
    """The integers ``jax_aug._band_mask`` draws from ``key``."""
    r_start, r_width = jax.random.split(key)
    starts = jax.random.randint(r_start, (B, n_masks), 0,
                                max(length - max_width, 1))
    widths = jax.random.randint(r_width, (B, n_masks), 0, max(max_width, 1))
    return torch.from_numpy(np.array(starts)), torch.from_numpy(
        np.array(widths))


@pytest.mark.parametrize('seed,fm,tm,fw,tw', [(0, 1, 1, 15, 50),
                                              (1, 2, 3, 27, 10),
                                              (2, 4, 2, 64, 120)])
def test_spec_augment_masks_equal_jax_given_its_draws(seed, fm, tm, fw, tw):
    key = jax.random.PRNGKey(seed)
    feats = np.random.default_rng(seed).standard_normal((B, T, F)).astype(
        np.float32)
    theirs = np.asarray(jax_aug.spec_augment(key, jnp.asarray(feats), fm, tm,
                                             fw, tw))
    r_f, r_t = jax.random.split(key)
    fmask = band_mask(*_jax_bands(r_f, F, fm, fw), F)
    tmask = band_mask(*_jax_bands(r_t, T, tm, tw), T)
    keep = ~(fmask[:, None, :] | tmask[:, :, None])
    ours = (torch.from_numpy(feats) * keep.float()).numpy()
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize('seed,masks,rt,rf', [(0, 5, 60, 25), (3, 2, 7, 40)])
def test_spec_cutout_masks_equal_jax_given_its_draws(seed, masks, rt, rf):
    key = jax.random.PRNGKey(seed)
    feats = np.ones((B, T, F), np.float32)
    theirs = np.asarray(jax_aug.spec_cutout(key, jnp.asarray(feats), masks,
                                            rt, rf))
    r_t0, r_tw, r_f0, r_fw = jax.random.split(key, 4)
    shape = (B, masks)

    def draw(k, hi):
        return torch.from_numpy(np.array(jax.random.randint(k, shape, 0,
                                                            hi)))
    rects = rect_mask(draw(r_t0, max(T - rt, 1)), draw(r_tw, max(rt, 1)),
                      draw(r_f0, max(F - rf, 1)), draw(r_fw, max(rf, 1)), T, F)
    np.testing.assert_array_equal((~rects).float().numpy(), theirs)
    # rect_freq sizes the frequency extent (the original recipe swapped it)
    zero_f = (theirs == 0).any(axis=1).sum(axis=1)
    assert zero_f.max() <= masks * (rf - 1)


def test_port_draws_stay_in_bounds():
    """Bands start in [0, max(L - w, 1)) and are [0, w) wide, as in JAX."""
    ones = torch.ones(B, T, F)
    for seed in range(20):
        out = spec_augment(torch.Generator().manual_seed(seed), ones,
                           freq_masks=2, time_masks=2)
        assert set(out.unique().tolist()) <= {0.0, 1.0}
        for b in range(B):
            zero_f = (out[b] == 0).all(dim=0).nonzero().flatten()
            zero_t = (out[b] == 0).all(dim=1).nonzero().flatten()
            assert len(zero_f) <= 2 * 14 and len(zero_t) <= 2 * 49
            if len(zero_f):
                assert zero_f.min() < F - 15 and zero_f.max() < F - 15 + 14
            if len(zero_t):
                assert zero_t.min() < T - 50 and zero_t.max() < T - 50 + 49
        cut = spec_cutout(torch.Generator().manual_seed(seed), ones,
                          rect_masks=3)
        assert 0.3 < cut.mean() <= 1.0


def test_deterministic_given_generator():
    ones = torch.ones(B, T, F)
    a = spec_augment(torch.Generator().manual_seed(2), ones)
    b = spec_augment(torch.Generator().manual_seed(2), ones)
    c = spec_augment(torch.Generator().manual_seed(3), ones)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_build_augment_fn_composition_and_errors():
    ones = torch.ones(B, T, F)
    fn = build_augment_fn({'spec_augment': {'freq_masks': 1},
                           'spec_cutout': {'rect_masks': 2}})
    assert (fn(torch.Generator().manual_seed(5), ones) == 0).any()
    assert build_augment_fn(None) is None and build_augment_fn({}) is None
    with pytest.raises(ValueError, match='Unknown augmentation'):
        build_augment_fn({'nope': {}})
    # false disables; true / None / {} mean enabled with defaults
    assert build_augment_fn({'spec_augment': False}) is None
    fn = build_augment_fn({'spec_augment': True})
    assert fn(torch.Generator().manual_seed(0), ones).shape == ones.shape
    assert build_augment_fn({'spec_cutout': False,
                             'spec_augment': {}}) is not None
    assert torch.equal(build_augment_fn({'identity': None})(None, ones), ones)
