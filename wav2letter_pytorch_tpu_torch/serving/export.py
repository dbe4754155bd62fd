"""Serving artifacts: export a trained Wav2Letter, load one, corpus CMVN.

The counterpart of the JAX package's ``serving/export.py``, in the same
format, so an artifact written by either package loads in the other:

* ``serving.npz``: the BN-folded weights ``w{i}``/``b{i}`` (f32) or
  ``w{i}``/``s{i}``/``b{i}`` (int8 + per-channel scales), one ``i`` a
  layer with the 1x1 head last, and optionally ``cmvn_mean``/``cmvn_std``;
* ``serving.json``: the layer geometry, labels, audio config, weight
  format, padding mode, feature type, n_mels, static int8 activation
  scales and, with ``lm_path``, the bundled ``lm.arpa`` with its decode
  settings.

A Jasper / QuartzNet artifact (``export_serving_jasper``) holds the
``fold_jasper`` descriptors instead: ``b{i}_r{r}_o{j}_w``/``_b`` a conv,
``b{i}_res{j}_w``/``_b`` a residual branch, ``_g``/``_beta`` a runtime
norm, ``head_w``/``head_b``, with the geometry in ``serving.json``'s
``blocks_meta``; it is stored f32 and quantized at load.
``streaming_from_artifact`` builds the streaming model of either family.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from .fold import fold_batchnorm
from .quantize import quantize_folded
from .streaming import StreamingWav2Letter
from .streaming_jasper import StreamingJasper, fold_jasper


def compute_cmvn(manifest_path: str, frontend_factory, labels, audio_conf,
                 limit: int | None = None):
    """Corpus-level CMVN: the masked mean and std of raw log-mel features
    over a manifest.

    ``frontend_factory(normalize=False)`` must return a frontend (on the
    device to run it on) that emits unnormalised masked features. Each
    utterance is zero-padded to a 0.5 s grid, as the JAX function pads it.
    Sums are float32 on the host and the variance is the unbiased one, as
    there. Returns ``(mean [M], std [M])``, the ``norm_stats`` of a
    fixed-statistics frontend.
    """
    from ..data.dataset import ManifestDataset, resample_flag
    ds = ManifestDataset(manifest_path, int(audio_conf['sample_rate']),
                         labels,
                         resample=resample_flag(audio_conf))
    frontend = frontend_factory(normalize=False)
    dev = frontend.fb_t.device
    n = len(ds) if limit is None else min(limit, len(ds))
    grid = max(int(audio_conf['sample_rate']) // 2, 1)
    count, total, total_sq = 0.0, None, None
    with torch.no_grad():
        for i in range(n):
            audio = np.asarray(ds[i][0], np.float32)
            L = len(audio)
            buf = np.zeros((1, ((L + grid - 1) // grid) * grid), np.float32)
            buf[0, :L] = audio
            feats, flens = frontend(torch.from_numpy(buf).to(dev),
                                    torch.tensor([L], dtype=torch.int32,
                                                 device=dev))
            feats = feats[0, :int(flens[0])].cpu().numpy()
            count += feats.shape[0]
            s, ss = feats.sum(0), np.square(feats).sum(0)
            total = s if total is None else total + s
            total_sq = ss if total_sq is None else total_sq + ss
    mean = total / count
    var = np.maximum(total_sq / count - np.square(mean), 0.0)
    var *= count / max(count - 1.0, 1.0)
    return mean.astype(np.float32), np.sqrt(var).astype(np.float32)


def export_serving(out_dir: str, layers, num_labels: int, model,
                   labels=None, audio_conf=None, weights: str = 'f32',
                   norm_stats=None, padding_mode: str = 'reflect',
                   feature_type: str = 'logmel', n_mels: int | None = None,
                   act_scales=None, folded=None, lm_path: str | None = None,
                   lm_beam_params: dict | None = None) -> str:
    """Write the serving artifact of a Wav2Letter; returns its directory.

    ``model``: the port's ``Wav2Letter`` or its state dict, folded with
    ``fold_batchnorm`` unless ``folded`` (an f32 fold) is given.
    ``weights``: 'f32' or 'int8' (``quantize_folded``). ``act_scales``:
    static int8 activation scales (``calibrate_activation_scales``) for
    int8_full inference. ``lm_path``: an ARPA LM copied into the artifact
    as ``lm.arpa``, with ``lm_beam_params`` (k/alpha/beta/prune) as its
    decode settings.
    """
    os.makedirs(out_dir, exist_ok=True)
    layers = [dict(l) for l in layers]
    if folded is None:
        folded = fold_batchnorm(model, len(layers))
    arrays = {}
    if weights == 'int8':
        for i, (q, scale, b) in enumerate(quantize_folded(folded)):
            arrays[f'w{i}'] = q
            arrays[f's{i}'] = scale
            arrays[f'b{i}'] = b
    elif weights == 'f32':
        for i, (w, b) in enumerate(folded):
            arrays[f'w{i}'] = w
            arrays[f'b{i}'] = b
    else:
        raise ValueError(f'unknown weights mode: {weights!r}')
    if norm_stats is not None:
        arrays['cmvn_mean'] = np.asarray(norm_stats[0], np.float32)
        arrays['cmvn_std'] = np.asarray(norm_stats[1], np.float32)
    np.savez(os.path.join(out_dir, 'serving.npz'), **arrays)
    meta = {
        'format': weights,
        'family': 'wav2letter',
        'num_layers': len(folded),
        'layers': layers,
        'num_labels': num_labels,
        'labels': list(labels) if labels is not None else None,
        'audio_conf': dict(audio_conf) if audio_conf is not None else None,
        'has_cmvn': norm_stats is not None,
        'padding_mode': padding_mode,
        'feature_type': feature_type,
        'n_mels': (n_mels if n_mels is not None
                   else int(np.asarray(folded[0][0]).shape[1])),
        'act_scales': (None if act_scales is None
                       else [float(s) for s in act_scales]),
    }
    if lm_path:
        shutil.copyfile(lm_path, os.path.join(out_dir, 'lm.arpa'))
        meta['lm'] = {'file': 'lm.arpa',
                      'beam_params': dict(lm_beam_params or {})}
    with open(os.path.join(out_dir, 'serving.json'), 'w') as f:
        json.dump(meta, f, indent=2)
    return out_dir


def export_serving_jasper(out_dir: str, jasper_blocks, num_labels: int,
                          model, labels=None, audio_conf=None,
                          norm_stats=None, feature_type: str = 'logmel',
                          n_mels: int | None = None) -> str:
    """Write the serving artifact of a Jasper / QuartzNet (the folded f32
    weights and their geometry); returns its directory.

    ``model``: the port's ``Jasper`` or its state dict, folded with
    ``streaming_jasper.fold_jasper``. Stored f32: int8 is applied at load
    time (``StreamingJasper(weights='int8')`` quantizes the loaded fold),
    so one artifact serves both formats, as in the JAX package.
    """
    os.makedirs(out_dir, exist_ok=True)
    cfg = [dict(b) for b in jasper_blocks]
    blocks, head = fold_jasper(model, cfg)
    arrays, blocks_meta = {}, []

    def put(key, w, b):
        arrays[key + '_w'] = np.asarray(w, np.float32)
        if b is not None:
            arrays[key + '_b'] = np.asarray(b, np.float32)

    def put_norm(key, norm):
        """A runtime (non-batch) norm's scale, bias and group count; its
        JSON descriptor (None for folded batch norm)."""
        if norm is None:
            return None
        arrays[key + '_g'] = np.asarray(norm['gamma'], np.float32)
        arrays[key + '_beta'] = np.asarray(norm['beta'], np.float32)
        return {'ng': int(norm['ng'])}

    for i, blk in enumerate(blocks):
        bm = {k: blk[k] for k in ('residual_mode', 'activation', 'dense',
                                  'mask', 'groups')}
        bm['reps'] = []
        for r, rep in enumerate(blk['reps']):
            row = []
            for j, op in enumerate(rep['ops']):
                put(f'b{i}_r{r}_o{j}', op['w'], op['b'])
                row.append({f: op[f] for f in ('k', 's', 'd', 'pad',
                                               'depthwise', 'mask', 'fgc')})
            bm['reps'].append({
                'ops': row,
                'norm': put_norm(f'b{i}_r{r}_norm', rep['norm'])})
        bm['n_res'] = -1
        if blk['res'] is not None:
            bm['n_res'] = len(blk['res'])
            bm['res'] = []
            for j, entry in enumerate(blk['res']):
                put(f'b{i}_res{j}', entry['w'], entry['b'])
                bm['res'].append({
                    'fgc': entry['fgc'],
                    'norm': put_norm(f'b{i}_res{j}_norm', entry['norm'])})
        blocks_meta.append(bm)
    put('head', head[0], head[1])
    if norm_stats is not None:
        arrays['cmvn_mean'] = np.asarray(norm_stats[0], np.float32)
        arrays['cmvn_std'] = np.asarray(norm_stats[1], np.float32)
    np.savez(os.path.join(out_dir, 'serving.npz'), **arrays)
    first = blocks[0]['reps'][0]['ops'][0]
    meta = {
        'format': 'f32',
        'family': 'jasper',
        'jasper_blocks': cfg,
        'blocks_meta': blocks_meta,
        'num_labels': num_labels,
        'labels': list(labels) if labels is not None else None,
        'audio_conf': dict(audio_conf) if audio_conf is not None else None,
        'has_cmvn': norm_stats is not None,
        'feature_type': feature_type,
        # Else the first conv's input channels (a depthwise kernel [k, 1,
        # C] keeps C; a plain one [k, C_in/g, C_out] has C_in/g).
        'n_mels': (n_mels if n_mels is not None else int(
            first['w'].shape[2] if first['depthwise']
            else first['w'].shape[1] * blocks[0].get('groups', 1))),
    }
    with open(os.path.join(out_dir, 'serving.json'), 'w') as f:
        json.dump(meta, f, indent=2)
    return out_dir


def load_serving(artifact_dir: str):
    """Load an artifact -> ``(meta dict, folded weights, norm_stats |
    None)``, all numpy.

    For the wav2letter family ``folded`` is the list ``offline_forward`` /
    ``offline_forward_q8`` take; for jasper it is the ``(blocks, head)``
    pair ``StreamingJasper(folded=...)`` takes.
    """
    with open(os.path.join(artifact_dir, 'serving.json')) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(artifact_dir, 'serving.npz'))
    norm_stats = None
    if meta.get('has_cmvn'):
        norm_stats = (npz['cmvn_mean'], npz['cmvn_std'])

    if meta.get('family', 'wav2letter') == 'jasper':
        files = set(npz.files)

        def get(key):
            b = npz[key + '_b'] if key + '_b' in files else None
            return npz[key + '_w'], b

        def get_norm(key, desc):
            if desc is None:
                return None
            return dict(gamma=npz[key + '_g'], beta=npz[key + '_beta'],
                        ng=int(desc['ng']))

        blocks = []
        for i, bm in enumerate(meta['blocks_meta']):
            blk = {k: bm[k] for k in ('residual_mode', 'activation',
                                      'dense', 'mask')}
            blk['groups'] = int(bm.get('groups', 1))
            blk['reps'] = []
            for r, rep in enumerate(bm['reps']):
                # Older artifacts stored a repeat as a bare op list,
                # newer ones as {'ops': [...], 'norm': ...}.
                row = rep['ops'] if isinstance(rep, dict) else rep
                norm = rep.get('norm') if isinstance(rep, dict) else None
                ops = []
                for j, geom in enumerate(row):
                    w, b = get(f'b{i}_r{r}_o{j}')
                    op = dict(geom, w=w, b=b)
                    op.setdefault('fgc', w.shape[2] if op['depthwise']
                                  else 1)
                    ops.append(op)
                blk['reps'].append(dict(
                    ops=ops, norm=get_norm(f'b{i}_r{r}_norm', norm)))
            blk['res'] = None
            if bm['n_res'] >= 0:
                res_meta = bm.get('res') or [
                    {'fgc': 1, 'norm': None}] * bm['n_res']
                blk['res'] = []
                for j, rm in enumerate(res_meta):
                    w, b = get(f'b{i}_res{j}')
                    blk['res'].append(dict(
                        w=w, b=b, fgc=int(rm.get('fgc', 1)),
                        norm=get_norm(f'b{i}_res{j}_norm',
                                      rm.get('norm'))))
            blocks.append(blk)
        return meta, (blocks, get('head')), norm_stats

    folded = []
    for i in range(meta['num_layers']):
        if meta['format'] == 'int8':
            folded.append((npz[f'w{i}'], npz[f's{i}'], npz[f'b{i}']))
        else:
            folded.append((npz[f'w{i}'], npz[f'b{i}']))
    return meta, folded, norm_stats


def artifact_frontend(meta: dict, norm_stats=None, device='cuda'):
    """The frontend an artifact's weights were trained on (log-mel or
    MFCC, by its ``feature_type``; no dither), on ``device``;
    ``norm_stats`` gives it fixed CMVN statistics in place of
    per-utterance normalisation. Raises ``ValueError`` for an artifact
    without its audio metadata."""
    from ..data.features import AudioConfig, SpectrogramFrontend
    ac = meta.get('audio_conf')
    if meta.get('labels') is None or ac is None:
        raise ValueError('artifact lacks labels/audio_conf metadata')
    n_mels = meta.get('n_mels')
    if n_mels is None:
        raise ValueError('artifact lacks n_mels metadata')
    conf = AudioConfig(sample_rate=int(ac['sample_rate']),
                       window_size=float(ac['window_size']),
                       window_stride=float(ac['window_stride']),
                       window=ac.get('window', 'hamming'))
    return SpectrogramFrontend(conf, n_mels=int(n_mels), dither=0.0,
                               device=device, norm_stats=norm_stats,
                               feature_type=meta.get('feature_type',
                                                     'logmel'))


def streaming_from_artifact(artifact_dir: str, chunk_frames: int = 64,
                            device='cuda'):
    """Build a ready-to-stream model from a serving artifact.

    Returns ``(model, labels, meta)``: ``model`` is a
    ``StreamingWav2Letter`` (f32, or int8 weights with float32 math) or a
    ``StreamingJasper`` (f32) on ``device`` in the artifact's weight
    format, with its CMVN statistics as fixed normalisation when it has
    them (else cumulative), as ``evaluate --artifact`` streams and
    ``serve_tcp`` serves.
    """
    meta, folded, norm_stats = load_serving(artifact_dir)
    frontend = artifact_frontend(meta, device=device)
    kw = {}
    if norm_stats is not None:
        kw = dict(norm='precomputed', norm_stats=norm_stats)
    if meta.get('family', 'wav2letter') == 'jasper':
        model = StreamingJasper(meta['jasper_blocks'], meta['num_labels'],
                                None, frontend, folded=folded,
                                chunk_frames=chunk_frames, device=device,
                                **kw)
    else:
        model = StreamingWav2Letter(
            meta['layers'], meta['num_labels'], None, frontend,
            folded=folded, chunk_frames=chunk_frames,
            padding_mode=meta.get('padding_mode', 'reflect'), device=device,
            **kw)
    return model, meta['labels'], meta
