"""Audio file I/O with offset/duration seeking: WAV through the stdlib
``wave`` module, FLAC through the host library's C++ decoder
(``flac_native``); other containers through soundfile where it is
installed (imported only then).
"""

from __future__ import annotations

import os
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


def read_flac(path: str, duration: float = -1, offset: float = 0):
    """Read a FLAC file -> (float32 samples in [-1, 1], sample_rate).

    Decodes through the C++ decoder (a failed build of the host library
    raises). FLAC frames are not seekable without a seektable, so
    ``offset``/``duration`` slice the decoded signal: the samples a
    container-level seek would give. Samples are scaled by
    ``1 / 2**(bps - 1)``; several channels are averaged to mono.
    """
    from . import flac_native
    with open(path, 'rb') as f:
        data = f.read()
    samples, rate, bps = flac_native.decode_native(data)
    out = samples.astype(np.float32) / float(1 << (bps - 1))
    out = out.mean(axis=1) if out.shape[1] > 1 else out[:, 0]
    start = min(int(offset * rate), len(out)) if offset > 0 else 0
    end = start + int(duration * rate) if duration > 0 else len(out)
    return out[start:end], rate


def read_audio(path: str, duration: float = -1, offset: float = 0):
    """(float32 samples, sample_rate) of a WAV, FLAC or (with soundfile)
    other audio file, by its extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == '.wav':
        return read_wav(path, duration, offset)
    if ext == '.flac':
        return read_flac(path, duration, offset)
    sf = _soundfile(ext)
    with sf.SoundFile(path, 'r') as f:
        rate = f.samplerate
        if offset > 0:
            f.seek(int(offset * rate))
        if duration > 0:
            samples = f.read(int(duration * rate), dtype='float32')
        else:
            samples = f.read(dtype='float32')
    samples = np.asarray(samples, np.float32)
    if samples.ndim > 1:
        samples = samples.mean(axis=1)
    return samples, rate


def _soundfile(ext: str):
    try:
        import soundfile
    except ImportError as e:
        raise ImportError(
            f'Reading {ext!r} files requires the optional soundfile package '
            '(WAV and FLAC work out of the box).') from e
    return soundfile


def audio_info(path: str):
    """(num_samples, sample_rate) from the header without decoding audio."""
    ext = os.path.splitext(path)[1].lower()
    if ext == '.wav':
        return wav_info(path)
    if ext == '.flac':
        from .flac_native import parse_info_native
        with open(path, 'rb') as f:
            head = f.read(65536)
            try:
                info = parse_info_native(head)
            except ValueError:
                if len(head) < 65536:
                    raise
                # Metadata blocks (cover art, padding) run past the head.
                f.seek(0)
                info = parse_info_native(f.read())
        return info['total_samples'], info['sample_rate']
    info = _soundfile(ext).info(path)
    return info.frames, info.samplerate


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
