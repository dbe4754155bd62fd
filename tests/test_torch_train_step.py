"""One train step of the port vs the JAX ``Trainer._train_step``.

A 3-layer, narrow Wav2Letter initialised by JAX is carried across with
``weights.state_dict_from_flax``; the same WAV batches (the port's loader)
go through both train steps with dither, dropout and augmentation off, on
the CPU. Compared: the loss of every micro-step, and afterwards every
parameter and the BatchNorm running statistics (which catches flax's
biased running variance: torch's own BatchNorm1d would store the
unbiased one, ~1 % off at this batch of ~100 frames). Covered: the
default SGD group, NovoGrad, and SGD with gradient clipping and two-step
accumulation (optax ``MultiSteps``).
"""

import json

import numpy as np
import pytest
import torch

import jax

from wav2letter_pytorch_tpu.config import load_config as jax_load_config
from wav2letter_pytorch_tpu.training import Trainer as JaxTrainer
from wav2letter_pytorch_tpu.training import build as jax_build
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.evaluate import make_loader
from wav2letter_pytorch_tpu_torch.models.wav2letter import Wav2Letter
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_optimizer)
from wav2letter_pytorch_tpu_torch.training.trainer import Trainer, to_device
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

LAYERS = [
    dict(output_size=32, kernel_size=11, stride=2, dilation=1, dropout=-1.0),
    dict(output_size=32, kernel_size=11, stride=1, dilation=1, dropout=-1.0),
    dict(output_size=48, kernel_size=13, stride=1, dilation=2, dropout=-1.0),
]
# float32 on both sides, convolutions and CTC summed in other orders.
LOSS_RTOL = 1e-4
UPDATE_RTOL = 1e-3   # relative global norm of the parameter-update difference
PARAM_ATOL = 1e-5    # every new parameter, elementwise
STATS_RTOL = 1e-5    # running stats; the unbiased-variance trap gives ~1e-2
WORDS = ['hello', 'world', 'the', 'quick', 'brown', 'fox', "it's", 'zz']

OPTIMIZERS = {
    'sgd': ['model.optimizer.lr=0.05'],
    'novograd': ['optimizer=novograd', 'model.optimizer.lr=0.01'],
    'sgd_clip_accumulate': ['model.optimizer.lr=0.05',
                            'trainer.gradient_clip_val=0.5',
                            'trainer.accumulate_grad_batches=2'],
}


@pytest.fixture(scope='module')
def manifest(tmp_path_factory):
    root = tmp_path_factory.mktemp('corpus')
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        # one length bucket (edge 9120 samples): one compiled JAX program
        n = int(rng.integers(7841, 9121))
        t = np.arange(n) / 16000
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 800) * t)
                 * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        write_wav(str(root / f'utt{i}.wav'), audio, 16000)
        text = ' '.join(rng.choice(WORDS, size=int(rng.integers(1, 3))))
        rows.append({'audio_filepath': str(root / f'utt{i}.wav'),
                     'text': text})
    path = root / 'manifest.jsonl'
    path.write_text('\n'.join(json.dumps(r) for r in rows) + '\n')
    return str(path)


def _rel(a: dict, b: dict, keys) -> float:
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in keys)
    den = sum(float((b[k].double() ** 2).sum()) for k in keys)
    return float(np.sqrt(num / den))


@pytest.mark.parametrize('opt', sorted(OPTIMIZERS))
def test_train_step_matches_jax(opt, manifest, tmp_path):
    overrides = [f'data.train_manifest={manifest}',
                 f'data.val_manifest={manifest}', 'model.mid_layers=3',
                 *OPTIMIZERS[opt]]
    layers = ', '.join('{' + ', '.join(f'{k}: {v}' for k, v in l.items())
                       + '}' for l in LAYERS)
    jcfg = jax_load_config(overrides + [f'model.layers=[{layers}]',
                                        'model.stft_method=conv',
                                        'trainer.mesh.data=1'])
    labels = jax_build.build_labels(jcfg.model)
    tx, sched = jax_build.build_optimizer(jcfg.model, 1, 10)
    jtr = JaxTrainer(jcfg, jax_build.build_model(jcfg.model, len(labels)),
                     jax_build.build_frontend(jcfg.model, dither=0.0), tx,
                     sched, jax_build.build_decoder(jcfg.model, labels),
                     run_dir=str(tmp_path / 'jax'))
    cfg = load_config(overrides)
    cfg['model']['layers'] = LAYERS
    fe = build_frontend(cfg['model'], dither=0.0)
    batches = [b for b in make_loader(manifest, 2, fe, prefetch=0)]
    assert len(batches) == 2
    state = jtr.init_state(batches[0])
    variables = jax.device_get({'params': state.params,
                                'batch_stats': state.batch_stats})
    model = Wav2Letter(len(labels), input_size=64, layers=LAYERS,
                       mid_layers=3)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, schedule = build_optimizer(model.parameters(), cfg['model'],
                                          1, 10)
    tr = Trainer(cfg, model, fe, optimizer, schedule, GreedyDecoder(labels),
                 device='cpu', run_dir=str(tmp_path / 'port'))

    jstep = jax.jit(jtr._train_step)
    for batch in batches:
        state, jloss, _, _ = jstep(state, {k: v for k, v in batch.items()
                                           if isinstance(v, np.ndarray)})
        loss, _, _ = tr.train_step(to_device(batch, torch.device('cpu')))
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)

    theirs = state_dict_from_flax(jax.device_get(
        {'params': state.params, 'batch_stats': state.batch_stats}))
    ours = model.state_dict()
    # A conv bias that feeds BatchNorm has an exact gradient of zero (BN
    # removes any per-channel shift), so what both sides compute for it is
    # rounding noise; NovoGrad divides each tensor's gradient by its norm
    # and turns that noise into a full-size step in a random direction.
    # Those biases move neither the loss nor anything below them, only the
    # next batch's BatchNorm mean: for NovoGrad they and the running means
    # are left out, and the running variances (shift-invariant) compared.
    noisy = opt == 'novograd'
    pre_bn = {k for k in ours if k.endswith('conv1.bias')
              and k.replace('conv1.bias', 'batch_norm.weight') in ours}
    params = [k for k in ours if k.endswith(('.weight', '.bias'))
              and not (noisy and k in pre_bn)]
    stats = [k for k in ours if k.endswith('running_var')
             or (k.endswith('running_mean') and not noisy)]
    update = _rel({k: ours[k] - before[k] for k in params},
                  {k: theirs[k] - before[k] for k in params}, params)
    assert update < UPDATE_RTOL, update
    assert max(float((ours[k] - before[k]).abs().max()) for k in params) > 0
    for k in params:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    assert _rel(ours, theirs, stats) < STATS_RTOL
    assert int(ours['conv1ds.conv1d_0.batch_norm.num_batches_tracked']) == 2
