"""The port's FLAC codec against the JAX package's, on the CPU.

Streams come from the JAX package's Python encoder steered through every
decoder path (subframe types, stereo modes, Rice escape and partition
orders, wasted bits, bit depths, blocking and rate codes). On each, the
port's Python decoder (``data/flac.py``, the plain version) and its C++
decoder (``csrc/host/flac.cpp`` through ``data/flac_native.py``) give the
JAX decoder's samples exactly, and the port's Python encoder writes the
JAX encoder's bytes. The port's C++ encoder writes the JAX native
encoder's bytes. Error texts, ``read_audio`` / ``audio_info`` on FLAC and
the refusal to fall back to Python are checked too.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from wav2letter_pytorch_tpu.data import audio_io as jaudio
from wav2letter_pytorch_tpu.data import flac as jflac
from wav2letter_pytorch_tpu.data import flac_native as jnative
from wav2letter_pytorch_tpu_torch import _build
from wav2letter_pytorch_tpu_torch.data import audio_io, flac, flac_native

torch.set_num_threads(1)


def _sine(n=4096, amp=9000, sr=16000):
    t = np.arange(n)
    return np.round(amp * np.sin(2 * np.pi * 523 * t / sr)
                    + 0.4 * amp * np.sin(2 * np.pi * 97 * t / sr)
                    ).astype(np.int64)


def _noise(n, bps=16, seed=0):
    lim = 1 << (bps - 1)
    return np.random.default_rng(seed).integers(-lim, lim, size=n)


def _stereo(mode):
    x = _sine(3000)
    return np.stack([x, np.roll(x, 3) // 2 + 5], axis=1), {'stereo_mode': mode}


# id -> (samples, encode_flac keyword arguments)
CASES = {
    'tonal': (_sine(), {}),
    'noise': (_noise(3000), {}),
    'constant': (np.full(3000, 123), {}),
    'silence': (np.zeros(2048, np.int64), {}),
    **{f'stereo-{m}': _stereo(m) for m in ('independent', 'left_side',
                                           'right_side', 'mid_side',
                                           'auto')},
    **{f'subframe-{f}': (np.full(3000, 3) if f == 'constant' else _sine(3000),
                         {'force_subframe': f})
       for f in ('constant', 'verbatim', 'fixed', 'lpc')},
    'rice-escape': (_noise(2048, seed=1), {'force_escape': True}),
    'partition-order-0': (_sine(2048), {'partition_order': 0}),
    'partition-order-4': (_sine(2048), {'partition_order': 4}),
    'wasted-bits': ((_sine(3000) // 16) * 16, {}),
    **{f'bps-{b}': (_noise(1500, b, seed=b), {'bits_per_sample': b})
       for b in (8, 12, 16, 20, 24, 32)},
    'variable-blocksize': (_sine(5000), {'variable_blocksize': True,
                                         'blocksize': 1152}),
    'blocksize-1000': (_sine(3000), {'blocksize': 1000}),
    'rate-12345': (_sine(2000), {'sample_rate': 12345}),
    'rate-44100': (_sine(2000), {'sample_rate': 44100}),
    'three-samples': (np.array([5, -3, 2]), {}),
    'lpc-order-20': (_sine(3000), {'lpc_order': 20}),
}


def _encode(enc, x, kw):
    kw = dict(kw)
    sr = kw.pop('sample_rate', 16000)
    bps = kw.pop('bits_per_sample', 16)
    return enc(x, sr, bps, **kw)


@pytest.mark.parametrize('case', sorted(CASES))
def test_decoders_and_encoder_match_jax(case):
    x, kw = CASES[case]
    data = _encode(jflac.encode_flac, x, kw)
    assert _encode(flac.encode_flac, x, kw) == data
    want, jinfo = jflac.decode_flac(data, verify_crc=True, verify_md5=True)
    np.testing.assert_array_equal(want, x[:, None] if x.ndim == 1 else x)
    got, info = flac.decode_flac(data, verify_crc=True, verify_md5=True)
    assert got.dtype == want.dtype and asdict(info) == asdict(jinfo)
    np.testing.assert_array_equal(got, want)
    native, sr, bps = flac_native.decode_native(data)
    jn, jsr, jbps = jnative.decode_native(data)
    assert (sr, bps) == (jsr, jbps) == (jinfo.sample_rate,
                                        jinfo.bits_per_sample)
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(native, jn)
    assert flac_native.parse_info_native(data) == \
        jnative.parse_info_native(data)
    assert asdict(flac.read_flac_info(data)) == \
        asdict(jflac.read_flac_info(data))


def test_native_encoder_bytes_match_jax():
    rng = np.random.default_rng(4)
    cases = [(_sine(20000), 16000, 4096), (rng.integers(-32768, 32768, 9000),
                                           16000, 4096),
             (np.full(5000, -3), 16000, 4096), (np.zeros(100, np.int64),
                                                16000, 4096),
             (np.array([1, 2, 3]), 16000, 4096),
             (np.stack([_sine(9000), np.roll(_sine(9000), 2)], axis=1),
              16000, 4096),
             (_sine(3000), 12345, 1000), (_sine(5000), 8000, 4096)]
    for x, sr, bs in cases:
        data = flac_native.encode_native(x, sr, blocksize=bs)
        assert data == jnative.encode_native(x, sr, blocksize=bs)
        want = x[:, None] if x.ndim == 1 else x
        py, _ = flac.decode_flac(data, verify_crc=True, verify_md5=True)
        np.testing.assert_array_equal(py, want)
        np.testing.assert_array_equal(flac_native.decode_native(data)[0],
                                      want)


def test_native_matches_python_on_fuzz():
    """Randomised encoder settings: the port's C++ and Python decoders give
    the JAX decoder's samples."""
    rng = np.random.default_rng(3)
    for trial in range(6):
        n = int(rng.integers(50, 3000))
        x = [rng.integers(-32768, 32768, size=n),
             np.clip(np.cumsum(rng.integers(-50, 51, size=n)), -32768,
                     32767)][trial % 2]
        if trial % 3 == 0:
            x = np.stack([x, np.roll(x, 1)], axis=1)
        data = jflac.encode_flac(
            x, 16000, 16, blocksize=int(rng.choice([192, 576, 1000])),
            lpc_order=int(rng.integers(1, 16)),
            variable_blocksize=bool(rng.integers(2)))
        want, _ = jflac.decode_flac(data)
        np.testing.assert_array_equal(flac.decode_flac(data)[0], want)
        np.testing.assert_array_equal(flac_native.decode_native(data)[0],
                                      want)


def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_crc_md5_and_stream_error_texts_match_jax():
    data = jflac.encode_flac(_sine(4096), 16000)
    payload = bytearray(data)
    payload[-1] ^= 0x40            # the last frame's CRC-16
    header = bytearray(data)
    first = 4 + 4 + 34 + 4 + 16    # fLaC, STREAMINFO, PADDING(16)
    header[first + 5] ^= 0x01      # the first frame header's CRC-8
    md5 = bytearray(data)
    md5[8 + 18] ^= 0xFF            # STREAMINFO's MD5
    for bad in (bytes(payload), bytes(header)):
        py = _error(flac.decode_flac, bad, verify_crc=True)
        assert py == _error(jflac.decode_flac, bad, verify_crc=True)
        assert 'CRC' in py
        nat = _error(flac_native.decode_native, bad, verify_crc=True)
        assert nat == _error(jnative.decode_native, bad, verify_crc=True)
        assert 'CRC' in nat
    assert 'CRC-16' in _error(flac.decode_flac, bytes(payload))
    assert 'CRC-8' in _error(flac.decode_flac, bytes(header))
    text = _error(flac.decode_flac, bytes(md5), verify_md5=True)
    assert text == _error(jflac.decode_flac, bytes(md5), verify_md5=True)
    assert 'MD5' in text
    stub = b'fLaC' + bytes(60)
    assert _error(flac_native.decode_native, stub) == \
        _error(jnative.decode_native, stub)
    assert _error(flac.decode_flac, b'RIFF' + bytes(60)) == \
        _error(jflac.decode_flac, b'RIFF' + bytes(60))
    assert _error(flac_native.decode_native, b'RIFF' + bytes(60)) == \
        _error(jnative.decode_native, b'RIFF' + bytes(60))


def test_native_decodes_a_stream_of_unknown_length():
    """STREAMINFO's sample count 0 (unknown): the JAX native decoder hands
    such a stream back to Python; the port's decodes it in C++."""
    x = _sine(70000)
    data = bytearray(jflac.encode_flac(x, 16000, blocksize=4608))
    # total_samples: the low 36 bits of STREAMINFO bytes 13..17
    data[8 + 13] &= 0xF0
    data[8 + 14:8 + 18] = bytes(4)
    data = bytes(data)
    assert jnative.decode_native(data) is None
    assert flac.read_flac_info(data).total_samples == 0
    got, sr, bps = flac_native.decode_native(data)
    np.testing.assert_array_equal(got[:, 0], x)
    np.testing.assert_array_equal(got, jflac.decode_flac(data)[0])


def _with_padding_block(data: bytes, n: int) -> bytes:
    """``data`` with an ``n``-byte PADDING block after its last metadata
    block."""
    pos = 4
    while True:
        last = data[pos] & 0x80
        end = pos + 4 + int.from_bytes(data[pos + 1:pos + 4], 'big')
        if last:
            break
        pos = end
    head = bytearray(data[:end])
    head[pos] &= 0x7F
    return bytes(head) + bytes([0x81]) + n.to_bytes(3, 'big') + bytes(n) \
        + data[end:]


def test_audio_info_past_a_64k_metadata_head_matches_jax(tmp_path):
    # Metadata longer than the 64 KiB that audio_info reads first (cover
    # art, padding) still gives the header's numbers, as the JAX reader's.
    x = _sine(6000)
    path = tmp_path / 'padded.flac'
    path.write_bytes(_with_padding_block(jflac.encode_flac(x, 16000),
                                         70000))
    assert audio_io.audio_info(str(path)) == jaudio.audio_info(str(path)) \
        == (6000, 16000)
    got, sr = audio_io.read_audio(str(path))
    want, _ = jaudio.read_audio(str(path))
    assert sr == 16000
    np.testing.assert_array_equal(got, want)


def test_read_audio_and_audio_info_on_flac_match_jax(tmp_path):
    mono = str(tmp_path / 'a.flac')
    jflac.write_flac_file(mono, _sine(32000), 16000)
    stereo = str(tmp_path / 's.flac')
    x = _sine(9000)
    jflac.write_flac_file(stereo, np.stack([x, -x // 3], axis=1), 8000)
    deep = str(tmp_path / 'd.flac')
    jflac.write_flac_file(deep, _noise(5000, 24), 22050, bits_per_sample=24)
    for path in (mono, stereo, deep):
        assert audio_io.audio_info(path) == jaudio.audio_info(path)
        for kw in ({}, {'offset': 0.1, 'duration': 0.05}, {'offset': 0.2},
                   {'duration': 0.3}, {'offset': 10.0}):
            got, sr = audio_io.read_audio(path, **kw)
            want, jsr = jaudio.read_audio(path, **kw)
            assert sr == jsr and got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    full, _ = audio_io.read_audio(mono)
    np.testing.assert_array_equal(audio_io.read_audio(mono, 0.25, 0.5)[0],
                                  full[8000:12000])


def test_read_flac_raises_when_the_host_library_does_not_build(
        tmp_path, monkeypatch):
    path = str(tmp_path / 'a.flac')
    jflac.write_flac_file(path, _sine(1000), 16000)

    def broken():
        raise RuntimeError('g++ failed: (exit 1)')
    monkeypatch.setattr(_build, 'load_host', broken)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        audio_io.read_audio(path)
