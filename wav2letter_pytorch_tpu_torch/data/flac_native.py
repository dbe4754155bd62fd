"""ctypes binding of the host library's FLAC codec (``csrc/host/flac.cpp``).

The same functions as ``wav2letter_pytorch_tpu.data.flac_native``, on the
port's own host library (built by g++ at first use, ``_build.load_host``).
Where the JAX module returns None when its library does not load, these
raise with g++'s output: the data path never decodes in Python behind the
caller's back. The pure-Python codec in ``flac.py`` is the plain version
the tests hold this one against.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np

from .. import _build

_ERRORS = {
    -1: 'truncated stream',
    -2: 'not a FLAC stream (missing fLaC marker)',
    -3: 'no STREAMINFO block',
    -4: 'bad frame sync',
    -5: 'reserved value in stream',
    -6: 'frame header CRC-8 mismatch',
    -7: 'frame CRC-16 mismatch',
    -8: 'output capacity exceeded',
    -9: 'malformed stream',
}
_ERR_CAPACITY = -8


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def parse_info_native(data: bytes) -> dict:
    """STREAMINFO via C++ -> dict (sample_rate, channels, bits_per_sample,
    total_samples, min_blocksize, max_blocksize)."""
    lib = _build.load_host()
    out = (ctypes.c_int64 * 7)()
    rc = lib.w2l_flac_parse_info(data, len(data), out)
    if rc:
        raise ValueError(f'FLAC: {_ERRORS.get(rc, rc)}')
    return {'sample_rate': out[0], 'channels': out[1],
            'bits_per_sample': out[2], 'total_samples': out[3],
            'min_blocksize': out[4], 'max_blocksize': out[5]}


def decode_native(data: bytes, verify_crc: bool = True):
    """Decode via C++ -> (int32 [n, channels], sample_rate,
    bits_per_sample). A stream whose STREAMINFO gives no sample count is
    decoded into a buffer that doubles until the stream fits."""
    lib = _build.load_host()
    info = parse_info_native(data)
    n, ch = info['total_samples'], info['channels']
    # Frames may legally carry a few samples past total_samples; give the
    # decoder one extra max-blocksize of headroom, then trim.
    cap = (n if n else 4 * len(data)) + max(info['max_blocksize'], 65536)
    while True:
        out = np.empty(cap * ch, dtype=np.int32)
        rc = lib.w2l_flac_decode_all(data, len(data), _i32p(out), cap,
                                     1 if verify_crc else 0)
        if rc != _ERR_CAPACITY or n:
            break
        cap *= 2
    if rc < 0:
        raise ValueError(f'FLAC: {_ERRORS.get(rc, rc)}')
    n_dec = min(int(rc), n) if n else int(rc)
    return (out[:n_dec * ch].reshape(n_dec, ch), info['sample_rate'],
            info['bits_per_sample'])


def encode_native(samples: np.ndarray, sample_rate: int,
                  bits_per_sample: int = 16, blocksize: int = 4096) -> bytes:
    """Encode int PCM ``[n]`` or ``[n, channels]`` via the C++
    fixed-predictor encoder -> bytes (the streams of the JAX package's
    ``encode_native``, byte for byte). The Python encoder in ``flac.py``
    is the full-featured one (LPC, stereo decorrelation, forced paths)."""
    lib = _build.load_host()
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    x32 = np.ascontiguousarray(x, dtype=np.int32)
    # STREAMINFO's MD5: interleaved little-endian PCM at the stream's byte
    # width (RFC 9639 section 8.2).
    width = max(1, (bits_per_sample + 7) // 8)
    inter = x32.reshape(-1).astype(np.int64)
    raw = np.zeros((len(inter), width), dtype=np.uint8)
    for i in range(width):
        raw[:, i] = (inter >> (8 * i)) & 0xFF
    md5 = hashlib.md5(raw.tobytes()).digest()
    cap = 64 + n * ch * 6 + 1024  # worst case ~ verbatim + headers
    out = np.empty(cap, dtype=np.uint8)
    rc = lib.w2l_flac_encode_fixed(
        _i32p(x32), n, ch, sample_rate, bits_per_sample, blocksize, md5,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if rc < 0:
        raise ValueError(f'FLAC encode: {_ERRORS.get(rc, rc)}')
    return out[:rc].tobytes()
