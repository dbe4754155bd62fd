"""Port Wav2Letter and ``weights.py`` vs the JAX package.

A narrow 3-layer flax Wav2Letter is initialised in JAX, given non-trivial
BatchNorm statistics, carried across with ``state_dict_from_flax`` and run
in both frameworks on the same seeded numpy features.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2letter_pytorch_tpu.models import Wav2Letter as JaxWav2Letter
from wav2letter_pytorch_tpu.training.torch_import import \
    torch_state_dict_from_variables
from wav2letter_pytorch_tpu_torch.models.base import same_pad_amount
from wav2letter_pytorch_tpu_torch.models.wav2letter import (WAV2LETTER_LAYERS,
                                                            Wav2Letter)
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

LAYERS = [
    dict(output_size=24, kernel_size=7, stride=2, dilation=1, dropout=0.2),
    dict(output_size=32, kernel_size=5, stride=1, dilation=2, dropout=0.2),
    dict(output_size=16, kernel_size=4, stride=1, dilation=1, dropout=0.3),
]
F_IN, N_LABELS = 16, 29
# float32 convs summed in another order in XLA and ATen (TF32 is off on
# both sides; this runs on the CPU): log-probs agree to ~1e-6.
TOL = 1e-4


def _flax_variables(seed=0, T=40):
    model = JaxWav2Letter(layers=LAYERS, num_labels=N_LABELS, mid_layers=3,
                          precision='highest')
    x = jnp.zeros((1, T, F_IN), jnp.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(seed), x,
                                          jnp.array([T]), train=False))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(seed)
    for name, st in variables['batch_stats'].items():
        bn = st['BatchNorm_0']
        bn['mean'] = rng.normal(0.1, 0.2, bn['mean'].shape).astype(np.float32)
        bn['var'] = rng.uniform(0.5, 1.5, bn['var'].shape).astype(np.float32)
        p = variables['params'][name]['BatchNorm_0']
        p['scale'] = rng.normal(1.0, 0.1, p['scale'].shape).astype(np.float32)
        p['bias'] = rng.normal(0.0, 0.1, p['bias'].shape).astype(np.float32)
    return model, variables


def _port_model(variables):
    model = Wav2Letter(N_LABELS, input_size=F_IN, layers=LAYERS, mid_layers=3)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize('T', [40, 37])
def test_model_matches_flax_apply(T):
    jmodel, variables = _flax_variables()
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, F_IN)).astype(np.float32)
    lens = np.array([T, T - 9], np.int32)
    ref, ref_lens = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                                 train=False)
    with torch.no_grad():
        ours, our_lens = _port_model(variables)(torch.from_numpy(x),
                                                torch.from_numpy(lens))
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(our_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_state_dict_matches_torch_import_export():
    _, variables = _flax_variables(seed=1)
    ours = state_dict_from_flax(variables)
    ref = torch_state_dict_from_variables(variables)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)
    # the port's parameter keys are exactly this layout
    model = Wav2Letter(N_LABELS, input_size=F_IN, layers=LAYERS, mid_layers=3)
    assert sorted(model.state_dict()) == sorted(ref)


def test_state_dict_rejects_non_wav2letter_trees():
    with pytest.raises(ValueError, match='Wav2Letter'):
        state_dict_from_flax({'params': {'encoder': {}, 'head': {}}})
    # a Jasper tree needs its block specs (tests/test_torch_jasper.py)
    with pytest.raises(ValueError, match='jasper_blocks'):
        state_dict_from_flax({'params': {'block0': {}, 'head': {}}})


@pytest.mark.parametrize('t_in,k,s,d', [(40, 7, 2, 1), (37, 7, 2, 1),
                                        (20, 5, 1, 2), (11, 1, 1, 1),
                                        (10, 4, 1, 1)])
def test_same_pad_amount_matches_jax(t_in, k, s, d):
    from wav2letter_pytorch_tpu.models.base import \
        same_pad_amount as jax_pad
    assert same_pad_amount(t_in, k, s, d) == jax_pad(t_in, k, s, d)


def test_full_model_geometry_and_seeded_init():
    """Wav2Letter-20 at full width: ~153M parameters (cheap to build, not
    run here); the same seed gives the same weights."""
    layers = WAV2LETTER_LAYERS[:2]
    a = Wav2Letter(29, layers=layers, mid_layers=2,
                   generator=torch.Generator().manual_seed(7))
    b = Wav2Letter(29, layers=layers, mid_layers=2,
                   generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    n = 0
    cin = 64
    for spec in WAV2LETTER_LAYERS:
        n += spec['output_size'] * (cin * spec['kernel_size'] + 1 + 2)
        cin = spec['output_size']
    n += 29 * (cin + 1)
    assert 150e6 < n < 156e6
    with torch.device('meta'):
        full = Wav2Letter(29, mid_layers=20, device='meta')
    # conv weight + bias and BatchNorm scale + shift per block, then the head
    assert sum(p.numel() for p in full.parameters()) == n
    assert full.scaling_factor == 2
