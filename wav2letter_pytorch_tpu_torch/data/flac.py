"""Pure-Python FLAC codec: the plain version of the host library's C++
codec (``csrc/host/flac.cpp``, bound in ``flac_native.py``).

Same behaviour as ``wav2letter_pytorch_tpu.data.flac``:

* **Decoder**: CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes, Rice
  and Rice2 residual partitions with the escape code, wasted bits,
  left/right/mid-side stereo, 8/12/16/20/24/32-bit depths, fixed and
  variable blocking, CRC-8 header and CRC-16 frame checks, and the
  STREAMINFO MD5 on request.
* **Encoder**: constant / verbatim / fixed / LPC subframes with Rice
  partitioning, wasted-bit detection and stereo decorrelation, plus the
  switches (``force_subframe``, ``force_escape``, ``partition_order``,
  ``variable_blocksize``) that steer a stream through every decoder path.

The data path decodes through the C++ decoder (``audio_io.read_flac``);
this module is what tests and ``chip_smoke.py`` hold it against, never a
fallback. Format: RFC 9639.
"""

from __future__ import annotations

import hashlib
import math
import struct
from dataclasses import dataclass

import numpy as np

__all__ = [
    'StreamInfo', 'decode_flac', 'encode_flac', 'read_flac_info',
    'write_flac_file', 'decode_flac_file',
]

_BLOCKSIZE_CODE = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8,
                   512: 9, 1024: 10, 2048: 11, 4096: 12, 8192: 13,
                   16384: 14, 32768: 15}
_SAMPLE_RATE_CODE = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                     22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                     96000: 11}
_SAMPLE_SIZE_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_CODE_SAMPLE_RATE = {v: k for k, v in _SAMPLE_RATE_CODE.items()}
_CODE_SAMPLE_SIZE = {v: k for k, v in _SAMPLE_SIZE_CODE.items()}

# Fixed-predictor coefficients by order (RFC 9639 §9.2.1): residual is the
# order'th forward difference of the signal.
_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        if bits == 0:
            return
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, bits: int):
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, n: int):
        while n >= 32:
            self.write(0, 32)
            n -= 32
        self.write(1, n + 1)  # n zeros then a one

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos
        self.bit = 0

    def read(self, bits: int) -> int:
        out = 0
        while bits > 0:
            if self.byte >= len(self.data):
                raise ValueError('truncated FLAC stream')
            avail = 8 - self.bit
            take = min(bits, avail)
            cur = self.data[self.byte]
            out = (out << take) | ((cur >> (avail - take)) & ((1 << take) - 1))
            self.bit += take
            bits -= take
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return out

    def read_signed(self, bits: int) -> int:
        v = self.read(bits)
        return v - (1 << bits) if v >= (1 << (bits - 1)) else v

    def read_unary(self) -> int:
        n = 0
        while True:
            if self.byte >= len(self.data):
                raise ValueError('truncated FLAC stream')
            avail = 8 - self.bit
            cur = self.data[self.byte] & ((1 << avail) - 1)
            if cur == 0:
                n += avail
                self.bit = 0
                self.byte += 1
                continue
            lead = avail - cur.bit_length()
            n += lead
            self.bit += lead + 1
            if self.bit >= 8:
                self.bit -= 8
                self.byte += 1
            return n

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1

    def at_end(self) -> bool:
        return self.byte >= len(self.data)


@dataclass
class StreamInfo:
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int  # 0 = unknown
    min_blocksize: int = 0
    max_blocksize: int = 0
    md5: bytes = b'\x00' * 16


# ---------------------------------------------------------------------------
# Shared number codings
# ---------------------------------------------------------------------------

def _write_utf8_number(w: _BitWriter, value: int):
    """FLAC's UTF-8-style coded number (extended to 36 bits, RFC 9639 §9.1.5)."""
    if value < 0x80:
        w.write(value, 8)
        return
    for nbytes, bits in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31), (7, 36)):
        if value < (1 << bits):
            lead = (0xFF << (8 - nbytes)) & 0xFF
            w.write(lead | (value >> (6 * (nbytes - 1))), 8)
            for i in range(nbytes - 2, -1, -1):
                w.write(0x80 | ((value >> (6 * i)) & 0x3F), 8)
            return
    raise ValueError('number too large for FLAC UTF-8 coding')


def _read_utf8_number(r: _BitReader) -> int:
    first = r.read(8)
    if first < 0x80:
        return first
    nbytes = 0
    mask = 0x80
    while first & mask:
        nbytes += 1
        mask >>= 1
    value = first & (mask - 1)
    for _ in range(nbytes - 1):
        cont = r.read(8)
        if cont & 0xC0 != 0x80:
            raise ValueError('invalid UTF-8-coded number in frame header')
        value = (value << 6) | (cont & 0x3F)
    return value


def _zigzag(res: np.ndarray) -> np.ndarray:
    res = res.astype(np.int64)
    return np.where(res >= 0, res << 1, (-res << 1) - 1)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _rice_cost(uz: np.ndarray, param: int) -> int:
    return int(np.sum(uz >> param)) + len(uz) * (param + 1)


def _best_rice_param(uz: np.ndarray, max_param: int) -> int:
    if len(uz) == 0:
        return 0
    mean = float(uz.mean())
    guess = max(0, min(max_param, int(math.log2(mean + 1)) if mean > 0 else 0))
    best, best_cost = guess, _rice_cost(uz, guess)
    for p in (guess - 1, guess + 1, guess + 2):
        if 0 <= p <= max_param:
            c = _rice_cost(uz, p)
            if c < best_cost:
                best, best_cost = p, c
    return best


def _write_residual(w: _BitWriter, residual: np.ndarray, order: int,
                    blocksize: int, partition_order: int,
                    force_escape: bool = False):
    """Rice-coded residual (RFC 9639 §9.2.7). Chooses RICE vs RICE2 by the
    largest parameter needed; uses the escape code when a partition's
    residuals are cheaper verbatim (or when forced, for decoder testing)."""
    uz = _zigzag(residual)
    nparts = 1 << partition_order
    psize = blocksize >> partition_order
    bounds = [0]
    for p in range(nparts):
        n = psize - order if p == 0 else psize
        bounds.append(bounds[-1] + n)
    params = []
    escapes = []
    for p in range(nparts):
        seg = uz[bounds[p]:bounds[p + 1]]
        param = _best_rice_param(seg, 30)
        raw_bits = int(seg.max()).bit_length() + 1 if len(seg) and seg.max() > 0 else 1
        esc = force_escape or (len(seg) > 0
                               and raw_bits * len(seg) + 5 < _rice_cost(seg, param))
        params.append(param)
        escapes.append(raw_bits if esc else -1)
    method = 0 if all(p < 15 or e >= 0 for p, e in zip(params, escapes)) else 1
    pbits = 4 if method == 0 else 5
    escape_code = (1 << pbits) - 1
    w.write(method, 2)
    w.write(partition_order, 4)
    for p in range(nparts):
        seg_res = residual[bounds[p]:bounds[p + 1]]
        seg = uz[bounds[p]:bounds[p + 1]]
        if escapes[p] >= 0:
            w.write(escape_code, pbits)
            w.write(escapes[p], 5)
            for v in seg_res:
                w.write_signed(int(v), escapes[p])
        else:
            param = params[p]
            w.write(param, pbits)
            for v in seg:
                v = int(v)
                w.write_unary(v >> param)
                w.write(v, param) if param else None


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _lpc_analyze(x: np.ndarray, order: int, precision: int = 12):
    """Levinson-Durbin LPC fit + coefficient quantization.

    Returns (qcoefs, shift) or None when the block is degenerate.  Any
    quantized coefficients produce a losslessly decodable stream (the
    encoder computes residuals with the *quantized* predictor), so the fit
    only affects compression, never correctness."""
    fx = x.astype(np.float64)
    n = len(fx)
    if n <= order or not np.any(fx):
        return None
    # Welch window reduces spectral leakage in the autocorrelation estimate.
    w = 1.0 - (2.0 * np.arange(n) / (n - 1) - 1.0) ** 2 if n > 1 else np.ones(1)
    wx = fx * w
    auto = np.array([np.dot(wx[:n - k], wx[k:]) for k in range(order + 1)])
    if auto[0] == 0:
        return None
    err = auto[0]
    coefs = np.zeros(order)
    for i in range(order):
        acc = auto[i + 1] - np.dot(coefs[:i], auto[i:0:-1][:i])
        k = acc / err
        coefs[:i] = coefs[:i] - k * coefs[:i][::-1] if i else coefs[:i]
        coefs[i] = k
        err *= (1 - k * k)
        if err <= 0:
            return None
    cmax = float(np.abs(coefs).max())
    if cmax <= 0:
        return None
    shift = precision - 1 - (int(math.floor(math.log2(cmax))) + 1)
    shift = max(1, min(15, shift))
    qmax = (1 << (precision - 1)) - 1
    qmin = -(1 << (precision - 1))
    qcoefs = []
    error = 0.0
    for c in coefs:
        val = c * (1 << shift) + error
        q = int(np.clip(round(val), qmin, qmax))
        error = val - q
        qcoefs.append(q)
    return qcoefs, shift


def _lpc_residual(x: np.ndarray, qcoefs, shift: int) -> np.ndarray:
    order = len(qcoefs)
    xs = x.astype(np.int64)
    pred = np.zeros(len(xs) - order, dtype=np.int64)
    for j, q in enumerate(qcoefs):
        pred += q * xs[order - 1 - j:len(xs) - 1 - j]
    return xs[order:] - (pred >> shift)


def _pick_partition_order(blocksize: int, order: int, max_order: int = 3) -> int:
    po = 0
    while (po < max_order and blocksize % (1 << (po + 1)) == 0
           and (blocksize >> (po + 1)) > order):
        po += 1
    return po


def _encode_subframe(w: _BitWriter, x: np.ndarray, bps: int,
                     force: str | None = None, force_escape: bool = False,
                     lpc_order: int = 8, partition_order: int | None = None):
    """One subframe (RFC 9639 §9.2.2-9.2.6): header, wasted bits, payload."""
    x = x.astype(np.int64)
    wasted = 0
    if force != 'verbatim' and np.any(x):
        ors = int(np.bitwise_or.reduce(x))
        while wasted < bps - 1 and not (ors >> wasted) & 1:
            wasted += 1
    if wasted:
        x = x >> wasted
    ebps = bps - wasted

    def header(type_code):
        w.write(0, 1)
        w.write(type_code, 6)
        if wasted:
            w.write(1, 1)
            w.write_unary(wasted - 1)
        else:
            w.write(0, 1)

    if force == 'constant' or (force is None and np.all(x == x[0])):
        header(0)
        w.write_signed(int(x[0]), ebps)
        return
    if force == 'verbatim':
        header(1)
        for v in x:
            w.write_signed(int(v), ebps)
        return

    candidates = []
    best_fixed, best_cost = 0, None
    for o in range(min(4, len(x) - 1) + 1):
        res = _fixed_residual(x, o)
        cost = int(np.sum(np.log2(_zigzag(res) + 1))) if len(res) else 0
        if best_cost is None or cost < best_cost:
            best_fixed, best_cost = o, cost
    candidates.append(('fixed', best_fixed, None))
    if force == 'lpc' or (force is None and len(x) > 2 * lpc_order):
        fit = _lpc_analyze(x, min(lpc_order, len(x) - 1))
        if fit is not None:
            candidates.append(('lpc', fit[0], fit[1]))
        elif force == 'lpc':
            raise ValueError('degenerate block cannot be LPC coded')
    if force == 'fixed':
        candidates = [c for c in candidates if c[0] == 'fixed']
    elif force == 'lpc':
        candidates = [c for c in candidates if c[0] == 'lpc']

    best = None
    for kind, a, b in candidates:
        if kind == 'fixed':
            res = _fixed_residual(x, a)
            cost = _rice_cost(_zigzag(res), _best_rice_param(_zigzag(res), 30))
            cost += a * ebps
        else:
            res = _lpc_residual(x, a, b)
            cost = _rice_cost(_zigzag(res), _best_rice_param(_zigzag(res), 30))
            cost += len(a) * ebps + len(a) * 12 + 9
        if best is None or cost < best[0]:
            best = (cost, kind, a, b, res)
    _, kind, a, b, res = best
    if kind == 'fixed':
        order = a
        header(8 + order)
        for v in x[:order]:
            w.write_signed(int(v), ebps)
    else:
        order = len(a)
        header(32 + order - 1)
        for v in x[:order]:
            w.write_signed(int(v), ebps)
        w.write(12 - 1, 4)  # precision
        w.write_signed(b, 5)
        for q in a:
            w.write_signed(q, 12)
    po = partition_order
    if po is None:
        po = _pick_partition_order(len(x), order)
    while (len(x) % (1 << po)) or (len(x) >> po) <= order:
        po -= 1
    _write_residual(w, res, order, len(x), po, force_escape)


def encode_flac(samples: np.ndarray, sample_rate: int,
                bits_per_sample: int = 16, blocksize: int = 4096,
                stereo_mode: str = 'auto', force_subframe: str | None = None,
                force_escape: bool = False, lpc_order: int = 8,
                partition_order: int | None = None,
                variable_blocksize: bool = False) -> bytes:
    """Encode integer PCM to a FLAC stream.

    ``samples``: int array ``[n]`` or ``[n, channels]`` in the signed range
    of ``bits_per_sample``.  ``force_subframe``/``force_escape``/
    ``partition_order`` exist so tests can steer the encoder through every
    decoder code path.
    """
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape
    if channels > 8:
        raise ValueError('FLAC supports at most 8 channels')
    lim = 1 << (bits_per_sample - 1)
    if x.min() < -lim or x.max() >= lim:
        raise ValueError('samples exceed the stated bit depth')
    x = x.astype(np.int64)

    # MD5 of the raw little-endian interleaved PCM (RFC 9639 §8.2).
    width = max(1, (bits_per_sample + 7) // 8)
    md5 = hashlib.md5()
    inter = x.reshape(-1)
    raw = np.zeros((len(inter), width), dtype=np.uint8)
    for i in range(width):
        raw[:, i] = (inter >> (8 * i)) & 0xFF
    md5.update(raw.tobytes())

    frames = []
    min_bs = max_bs = None
    start = 0
    frame_index = 0
    bs_cycle = 0
    while start < n or (n == 0 and frame_index == 0):
        bs = min(blocksize, n - start) if n else blocksize
        if n == 0:
            break
        if variable_blocksize and start + blocksize < n:
            # Alternate sizes to exercise the variable-blocking decoder path.
            bs = blocksize if bs_cycle % 2 == 0 else max(16, blocksize // 2)
            bs = min(bs, n - start)
            bs_cycle += 1
        block = x[start:start + bs]
        frames.append(_encode_frame(
            block, frame_index if not variable_blocksize else start,
            sample_rate, bits_per_sample, stereo_mode, force_subframe,
            force_escape, lpc_order, partition_order, variable_blocksize))
        min_bs = bs if min_bs is None else min(min_bs, bs)
        max_bs = bs if max_bs is None else max(max_bs, bs)
        start += bs
        frame_index += 1
    if min_bs is None:
        min_bs = max_bs = blocksize

    info = _BitWriter()
    info.write(min_bs, 16)
    info.write(max_bs, 16)
    framesizes = [len(f) for f in frames] or [0]
    info.write(min(framesizes), 24)
    info.write(max(framesizes), 24)
    info.write(sample_rate, 20)
    info.write(channels - 1, 3)
    info.write(bits_per_sample - 1, 5)
    info.write(n, 36)
    streaminfo = info.getvalue() + md5.digest()

    out = bytearray(b'fLaC')
    out.append(0x00)  # STREAMINFO, not last
    out += struct.pack('>I', len(streaminfo))[1:]
    out += streaminfo
    pad = b'\x00' * 16
    out.append(0x81)  # PADDING, last block
    out += struct.pack('>I', len(pad))[1:]
    out += pad
    for f in frames:
        out += f
    return bytes(out)


def _encode_frame(block: np.ndarray, number: int, sample_rate: int, bps: int,
                  stereo_mode: str, force_subframe, force_escape, lpc_order,
                  partition_order, variable_blocksize) -> bytes:
    bs, channels = block.shape
    assignment = channels - 1
    subblocks = [block[:, c] for c in range(channels)]
    subbits = [bps] * channels
    if channels == 2 and stereo_mode != 'independent':
        left = block[:, 0]
        right = block[:, 1]
        side = left - right
        mid = (left + right) >> 1
        if stereo_mode == 'auto':
            cost_lr = _abs_cost(np.diff(left)) + _abs_cost(np.diff(right))
            cost_ls = _abs_cost(np.diff(left)) + _abs_cost(np.diff(side))
            cost_rs = _abs_cost(np.diff(side)) + _abs_cost(np.diff(right))
            cost_ms = _abs_cost(np.diff(mid)) + _abs_cost(np.diff(side))
            stereo_mode = ['independent', 'left_side', 'right_side',
                           'mid_side'][int(np.argmin(
                               [cost_lr, cost_ls, cost_rs, cost_ms]))]
        if stereo_mode == 'left_side':
            assignment, subblocks, subbits = 8, [left, side], [bps, bps + 1]
        elif stereo_mode == 'right_side':
            assignment, subblocks, subbits = 9, [side, right], [bps + 1, bps]
        elif stereo_mode == 'mid_side':
            assignment, subblocks, subbits = 10, [mid, side], [bps, bps + 1]

    w = _BitWriter()
    w.write(0b11111111111110, 14)
    w.write(0, 1)
    w.write(1 if variable_blocksize else 0, 1)
    bs_code = _BLOCKSIZE_CODE.get(bs)
    if bs_code is None:
        bs_code = 6 if bs <= 256 else 7
    w.write(bs_code, 4)
    sr_code = _SAMPLE_RATE_CODE.get(sample_rate)
    if sr_code is None:
        if sample_rate % 1000 == 0 and sample_rate // 1000 < 256:
            sr_code = 12
        elif sample_rate < 65536:
            sr_code = 13
        elif sample_rate % 10 == 0 and sample_rate // 10 < 65536:
            sr_code = 14
        else:
            sr_code = 0
    w.write(sr_code, 4)
    w.write(assignment, 4)
    w.write(_SAMPLE_SIZE_CODE.get(bps, 0), 3)
    w.write(0, 1)
    _write_utf8_number(w, number)
    if bs_code == 6:
        w.write(bs - 1, 8)
    elif bs_code == 7:
        w.write(bs - 1, 16)
    if sr_code == 12:
        w.write(sample_rate // 1000, 8)
    elif sr_code == 13:
        w.write(sample_rate, 16)
    elif sr_code == 14:
        w.write(sample_rate // 10, 16)
    header = w.getvalue()
    w2 = _BitWriter()
    w2.buf = bytearray(header)
    w2.write(_crc8(header), 8)
    for sb, sbits in zip(subblocks, subbits):
        _encode_subframe(w2, sb, sbits, force_subframe, force_escape,
                         lpc_order, partition_order)
    w2.align()
    body = w2.getvalue()
    return body + struct.pack('>H', _crc16(body))


def _abs_cost(d: np.ndarray) -> float:
    return float(np.sum(np.log2(np.abs(d.astype(np.float64)) + 1)))


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def read_flac_info(data: bytes) -> StreamInfo:
    """Parse STREAMINFO without decoding audio."""
    if data[:4] != b'fLaC':
        raise ValueError('not a FLAC stream (missing fLaC marker)')
    pos = 4
    while pos < len(data):
        head = data[pos]
        length = int.from_bytes(data[pos + 1:pos + 4], 'big')
        if head & 0x7F == 0:
            r = _BitReader(data, pos + 4)
            min_bs = r.read(16)
            max_bs = r.read(16)
            r.read(24)
            r.read(24)
            rate = r.read(20)
            channels = r.read(3) + 1
            bps = r.read(5) + 1
            total = r.read(36)
            md5 = bytes(data[pos + 4 + 18:pos + 4 + 34])
            return StreamInfo(rate, channels, bps, total, min_bs, max_bs, md5)
        pos += 4 + length
        if head & 0x80:
            break
    raise ValueError('FLAC stream has no STREAMINFO block')


def _first_frame_offset(data: bytes) -> int:
    pos = 4
    while pos < len(data):
        head = data[pos]
        length = int.from_bytes(data[pos + 1:pos + 4], 'big')
        pos += 4 + length
        if head & 0x80:
            return pos
    raise ValueError('FLAC stream ends inside metadata')


def _read_residual(r: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = r.read(2)
    if method > 1:
        raise ValueError('reserved residual coding method')
    pbits = 4 if method == 0 else 5
    escape_code = (1 << pbits) - 1
    partition_order = r.read(4)
    nparts = 1 << partition_order
    if blocksize % nparts:
        raise ValueError('partition order does not divide blocksize')
    psize = blocksize >> partition_order
    out = np.empty(blocksize - order, dtype=np.int64)
    idx = 0
    for p in range(nparts):
        count = psize - order if p == 0 else psize
        if count < 0:
            raise ValueError('predictor order exceeds first partition')
        param = r.read(pbits)
        if param == escape_code:
            nbits = r.read(5)
            for i in range(count):
                out[idx] = r.read_signed(nbits) if nbits else 0
                idx += 1
        else:
            for i in range(count):
                q = r.read_unary()
                u = (q << param) | (r.read(param) if param else 0)
                out[idx] = (u >> 1) ^ -(u & 1)
                idx += 1
    return out


def _decode_subframe(r: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if r.read(1):
        raise ValueError('subframe header padding bit set')
    type_code = r.read(6)
    wasted = 0
    if r.read(1):
        wasted = r.read_unary() + 1
    ebps = bps - wasted
    if type_code == 0:
        x = np.full(blocksize, r.read_signed(ebps), dtype=np.int64)
    elif type_code == 1:
        x = np.array([r.read_signed(ebps) for _ in range(blocksize)],
                     dtype=np.int64)
    elif 8 <= type_code <= 12:
        order = type_code - 8
        warm = [r.read_signed(ebps) for _ in range(order)]
        res = _read_residual(r, blocksize, order)
        x = np.empty(blocksize, dtype=np.int64)
        x[:order] = warm
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            pred = 0
            for j, c in enumerate(coefs):
                pred += c * x[i - 1 - j]
            x[i] = pred + res[i - order]
    elif type_code >= 32:
        order = type_code - 31
        warm = [r.read_signed(ebps) for _ in range(order)]
        precision = r.read(4) + 1
        if precision == 16:
            raise ValueError('invalid LPC precision escape')
        shift = r.read_signed(5)
        if shift < 0:
            raise ValueError('negative LPC shift')
        qcoefs = [r.read_signed(precision) for _ in range(order)]
        res = _read_residual(r, blocksize, order)
        x = np.empty(blocksize, dtype=np.int64)
        x[:order] = warm
        for i in range(order, blocksize):
            pred = 0
            for j, q in enumerate(qcoefs):
                pred += q * x[i - 1 - j]
            x[i] = (pred >> shift) + res[i - order]
    else:
        raise ValueError(f'reserved subframe type {type_code}')
    if wasted:
        x <<= wasted
    return x


def _decode_frame(data: bytes, pos: int, info: StreamInfo, verify_crc: bool):
    r = _BitReader(data, pos)
    sync = r.read(14)
    if sync != 0b11111111111110:
        raise ValueError(f'bad frame sync at byte {pos}')
    if r.read(1):
        raise ValueError('reserved bit set in frame header')
    r.read(1)  # blocking strategy (number semantics only)
    bs_code = r.read(4)
    sr_code = r.read(4)
    assignment = r.read(4)
    ss_code = r.read(3)
    if r.read(1):
        raise ValueError('reserved bit set in frame header')
    _read_utf8_number(r)
    if bs_code == 0:
        raise ValueError('reserved blocksize code')
    elif bs_code == 1:
        blocksize = 192
    elif bs_code <= 5:
        blocksize = 576 << (bs_code - 2)
    elif bs_code == 6:
        blocksize = r.read(8) + 1
    elif bs_code == 7:
        blocksize = r.read(16) + 1
    else:
        blocksize = 256 << (bs_code - 8)
    if sr_code == 12:
        r.read(8)
    elif sr_code in (13, 14):
        r.read(16)
    elif sr_code == 15:
        raise ValueError('invalid sample rate code')
    header_end = r.byte
    crc8 = r.read(8)
    if verify_crc and _crc8(data[pos:header_end]) != crc8:
        raise ValueError(f'frame header CRC-8 mismatch at byte {pos}')
    bps = _CODE_SAMPLE_SIZE.get(ss_code, info.bits_per_sample)
    if assignment < 8:
        channels = assignment + 1
        subs = [_decode_subframe(r, blocksize, bps) for _ in range(channels)]
        frame = np.stack(subs, axis=1)
    elif assignment in (8, 9, 10):
        bits0 = bps + (1 if assignment == 9 else 0)
        bits1 = bps + (1 if assignment in (8, 10) else 0)
        ch0 = _decode_subframe(r, blocksize, bits0)
        ch1 = _decode_subframe(r, blocksize, bits1)
        if assignment == 8:      # left/side
            left, right = ch0, ch0 - ch1
        elif assignment == 9:    # right/side
            left, right = ch0 + ch1, ch1
        else:                    # mid/side
            side = ch1
            m2 = (ch0 << 1) | (side & 1)
            left, right = (m2 + side) >> 1, (m2 - side) >> 1
        frame = np.stack([left, right], axis=1)
    else:
        raise ValueError(f'reserved channel assignment {assignment}')
    r.align()
    if r.byte + 2 > len(data):
        raise ValueError('truncated FLAC stream')
    crc16 = (data[r.byte] << 8) | data[r.byte + 1]
    if verify_crc and _crc16(data[pos:r.byte]) != crc16:
        raise ValueError(f'frame CRC-16 mismatch at byte {pos}')
    return frame, r.byte + 2


def decode_flac(data: bytes, verify_crc: bool = True, verify_md5: bool = False):
    """Decode a FLAC stream -> (int32 samples [n, channels], StreamInfo)."""
    info = read_flac_info(data)
    pos = _first_frame_offset(data)
    frames = []
    total = 0
    while pos < len(data) - 1:
        frame, pos = _decode_frame(data, pos, info, verify_crc)
        frames.append(frame)
        total += len(frame)
        if info.total_samples and total >= info.total_samples:
            break
    if frames:
        out = np.concatenate(frames, axis=0)
    else:
        out = np.zeros((0, info.channels), dtype=np.int64)
    if info.total_samples:
        out = out[:info.total_samples]
    if verify_md5 and info.md5 != b'\x00' * 16:
        width = max(1, (info.bits_per_sample + 7) // 8)
        inter = out.reshape(-1)
        raw = np.zeros((len(inter), width), dtype=np.uint8)
        for i in range(width):
            raw[:, i] = (inter >> (8 * i)) & 0xFF
        if hashlib.md5(raw.tobytes()).digest() != info.md5:
            raise ValueError('decoded audio fails the STREAMINFO MD5 check')
    return out.astype(np.int32), info


# ---------------------------------------------------------------------------
# File-level conveniences
# ---------------------------------------------------------------------------

def write_flac_file(path: str, samples: np.ndarray, sample_rate: int,
                    bits_per_sample: int = 16, **kwargs):
    """Float [-1,1] or integer samples -> .flac file on disk."""
    x = np.asarray(samples)
    if np.issubdtype(x.dtype, np.floating):
        lim = 1 << (bits_per_sample - 1)
        x = np.clip(np.round(x * lim), -lim, lim - 1).astype(np.int64)
    with open(path, 'wb') as f:
        f.write(encode_flac(x, sample_rate, bits_per_sample, **kwargs))


def decode_flac_file(path: str):
    """Decode a .flac file -> (float32 mono samples in [-1,1], sample_rate)."""
    with open(path, 'rb') as f:
        data = f.read()
    samples, info = decode_flac(data)
    out = samples.astype(np.float32) / float(1 << (info.bits_per_sample - 1))
    if out.shape[1] > 1:
        out = out.mean(axis=1)
    else:
        out = out[:, 0]
    return out, info.sample_rate
