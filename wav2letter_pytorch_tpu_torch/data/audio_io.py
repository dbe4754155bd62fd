"""WAV file I/O with offset/duration seeking (stdlib ``wave`` + numpy).

FLAC and other containers are not ported yet.
"""

from __future__ import annotations

import wave

import numpy as np

_PCM_SCALE = {1: 127.0, 2: 32768.0, 4: 2147483648.0}
_PCM_DTYPE = {1: np.uint8, 2: np.int16, 4: np.int32}


def read_wav(path: str, duration: float = -1, offset: float = 0):
    """Read a PCM WAV file -> (float32 samples in [-1, 1], sample_rate).

    ``offset``/``duration`` are in seconds and seek at the container level.
    Multi-channel audio is averaged to mono.
    """
    with wave.open(path, 'rb') as f:
        rate = f.getframerate()
        width = f.getsampwidth()
        channels = f.getnchannels()
        if offset > 0:
            f.setpos(min(int(offset * rate), f.getnframes()))
        n = f.getnframes() - f.tell()
        if duration > 0:
            n = min(n, int(duration * rate))
        raw = f.readframes(n)
    data = np.frombuffer(raw, dtype=_PCM_DTYPE[width]).astype(np.float32)
    if width == 1:  # uint8 WAV is offset-binary
        data = data - 128.0
    data /= _PCM_SCALE[width]
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate


def wav_info(path: str):
    """(num_samples, sample_rate) from the WAV header without decoding."""
    with wave.open(path, 'rb') as f:
        return f.getnframes(), f.getframerate()


def write_wav(path: str, samples: np.ndarray, sample_rate: int):
    """Write mono float32 samples as 16-bit PCM."""
    pcm = np.clip(np.asarray(samples) * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, 'wb') as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
