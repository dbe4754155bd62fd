// FLAC decoder and encoder of the host library (the data path's codec).
//
// The counterpart of the JAX package's native/flac.cpp: the same RFC 9639
// subset as the pure-Python codec in data/flac.py, which is its plain
// version in the tests: CONSTANT/VERBATIM/FIXED(0-4)/LPC(1-32) subframes,
// Rice + Rice2 partitions with escape codes, wasted bits, left/right/mid
// side stereo, 8..32-bit depths, CRC-8/CRC-16 verification; and a
// fixed-predictor encoder whose streams are byte for byte those of the
// JAX package's native encoder.
//
// C ABI (ctypes, see data/flac_native.py):
//   w2l_flac_parse_info(data, len, out7)            -> 0 | negative error
//   w2l_flac_decode_all(data, len, out, cap, flags) -> n_samples | error
//   w2l_flac_encode_fixed(samples, n, ch, rate, bps, blocksize, md5, out,
//                         cap)                      -> bytes | error
//
// Error codes are negative and match _ERRORS in flac_native.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kErrTruncated = -1;
constexpr int kErrMarker = -2;
constexpr int kErrNoStreamInfo = -3;
constexpr int kErrBadSync = -4;
constexpr int kErrReserved = -5;
constexpr int kErrCrc8 = -6;
constexpr int kErrCrc16 = -7;
constexpr int kErrCapacity = -8;
constexpr int kErrBadStream = -9;

struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t byte = 0;
  int bit = 0;
  bool overrun = false;

  BitReader(const uint8_t* d, int64_t n, int64_t pos) : data(d), len(n), byte(pos) {}

  inline uint64_t read(int bits) {
    uint64_t out = 0;
    while (bits > 0) {
      if (byte >= len) { overrun = true; return 0; }
      int avail = 8 - bit;
      int take = bits < avail ? bits : avail;
      uint8_t cur = data[byte];
      out = (out << take) | ((cur >> (avail - take)) & ((1u << take) - 1));
      bit += take;
      bits -= take;
      if (bit == 8) { bit = 0; ++byte; }
    }
    return out;
  }

  inline int64_t read_signed(int bits) {
    uint64_t v = read(bits);
    if (bits > 0 && (v >> (bits - 1)) & 1) return (int64_t)v - ((int64_t)1 << bits);
    return (int64_t)v;
  }

  inline int64_t read_unary() {
    int64_t n = 0;
    for (;;) {
      if (byte >= len) { overrun = true; return 0; }
      uint8_t cur = data[byte] & ((1u << (8 - bit)) - 1);
      if (cur == 0) {
        n += 8 - bit;
        bit = 0;
        ++byte;
        continue;
      }
      int msb = 31 - __builtin_clz((unsigned)cur);  // position of first 1
      int lead = (8 - bit) - 1 - msb;
      n += lead;
      bit += lead + 1;
      if (bit >= 8) { bit -= 8; ++byte; }
      return n;
    }
  }

  inline void align() {
    if (bit) { bit = 0; ++byte; }
  }
};

uint8_t crc8(const uint8_t* data, int64_t n) {
  uint8_t crc = 0;
  for (int64_t i = 0; i < n; ++i) {
    crc ^= data[i];
    for (int k = 0; k < 8; ++k)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
  }
  return crc;
}

uint16_t crc16(const uint8_t* data, int64_t n) {
  uint16_t crc = 0;
  for (int64_t i = 0; i < n; ++i) {
    crc ^= (uint16_t)data[i] << 8;
    for (int k = 0; k < 8; ++k)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005) : (uint16_t)(crc << 1);
  }
  return crc;
}

struct StreamInfo {
  int64_t sample_rate = 0;
  int64_t channels = 0;
  int64_t bits_per_sample = 0;
  int64_t total_samples = 0;
  int64_t min_blocksize = 0;
  int64_t max_blocksize = 0;
  int64_t first_frame = 0;
};

int parse_info(const uint8_t* data, int64_t len, StreamInfo* out) {
  if (len < 8 || memcmp(data, "fLaC", 4) != 0) return kErrMarker;
  int64_t pos = 4;
  bool have_info = false;
  while (pos + 4 <= len) {
    uint8_t head = data[pos];
    int64_t blen = ((int64_t)data[pos + 1] << 16) | ((int64_t)data[pos + 2] << 8) |
                   data[pos + 3];
    if ((head & 0x7F) == 0) {
      if (pos + 4 + 34 > len) return kErrTruncated;
      BitReader r(data, len, pos + 4);
      out->min_blocksize = r.read(16);
      out->max_blocksize = r.read(16);
      r.read(24);
      r.read(24);
      out->sample_rate = r.read(20);
      out->channels = r.read(3) + 1;
      out->bits_per_sample = r.read(5) + 1;
      out->total_samples = r.read(36);
      have_info = true;
    }
    pos += 4 + blen;
    if (head & 0x80) {
      out->first_frame = pos;
      return have_info ? 0 : kErrNoStreamInfo;
    }
  }
  return kErrNoStreamInfo;
}

int read_utf8_number(BitReader& r, uint64_t* out) {
  uint64_t first = r.read(8);
  if (first < 0x80) { *out = first; return 0; }
  int nbytes = 0;
  uint64_t mask = 0x80;
  while (first & mask) { ++nbytes; mask >>= 1; }
  if (nbytes < 2 || nbytes > 7) return kErrBadStream;
  uint64_t value = first & (mask - 1);
  for (int i = 0; i < nbytes - 1; ++i) {
    uint64_t cont = r.read(8);
    if ((cont & 0xC0) != 0x80) return kErrBadStream;
    value = (value << 6) | (cont & 0x3F);
  }
  *out = value;
  return 0;
}

int read_residual(BitReader& r, int64_t blocksize, int order, int64_t* res) {
  int method = (int)r.read(2);
  if (method > 1) return kErrReserved;
  int pbits = method == 0 ? 4 : 5;
  uint32_t escape = (1u << pbits) - 1;
  int porder = (int)r.read(4);
  int64_t nparts = (int64_t)1 << porder;
  if (blocksize % nparts) return kErrBadStream;
  int64_t psize = blocksize >> porder;
  int64_t idx = 0;
  for (int64_t p = 0; p < nparts; ++p) {
    int64_t count = (p == 0) ? psize - order : psize;
    if (count < 0) return kErrBadStream;
    uint32_t param = (uint32_t)r.read(pbits);
    if (param == escape) {
      int nbits = (int)r.read(5);
      for (int64_t i = 0; i < count; ++i)
        res[idx++] = nbits ? r.read_signed(nbits) : 0;
    } else {
      for (int64_t i = 0; i < count; ++i) {
        uint64_t q = (uint64_t)r.read_unary();
        uint64_t u = (q << param) | (param ? r.read(param) : 0);
        res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (r.overrun) return kErrTruncated;
  }
  return 0;
}

int decode_subframe(BitReader& r, int64_t blocksize, int bps, int64_t* x,
                    std::vector<int64_t>& scratch) {
  if (r.read(1)) return kErrBadStream;
  int type_code = (int)r.read(6);
  int wasted = 0;
  if (r.read(1)) wasted = (int)r.read_unary() + 1;
  int ebps = bps - wasted;
  if (ebps <= 0) return kErrBadStream;

  if (type_code == 0) {
    int64_t v = r.read_signed(ebps);
    for (int64_t i = 0; i < blocksize; ++i) x[i] = v;
  } else if (type_code == 1) {
    for (int64_t i = 0; i < blocksize; ++i) x[i] = r.read_signed(ebps);
  } else if (type_code >= 8 && type_code <= 12) {
    int order = type_code - 8;
    if (order > blocksize) return kErrBadStream;
    for (int i = 0; i < order; ++i) x[i] = r.read_signed(ebps);
    scratch.resize(blocksize - order);
    int rc = read_residual(r, blocksize, order, scratch.data());
    if (rc) return rc;
    const int64_t* res = scratch.data();
    switch (order) {
      case 0:
        for (int64_t i = 0; i < blocksize; ++i) x[i] = res[i];
        break;
      case 1:
        for (int64_t i = 1; i < blocksize; ++i) x[i] = x[i - 1] + res[i - 1];
        break;
      case 2:
        for (int64_t i = 2; i < blocksize; ++i)
          x[i] = 2 * x[i - 1] - x[i - 2] + res[i - 2];
        break;
      case 3:
        for (int64_t i = 3; i < blocksize; ++i)
          x[i] = 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3] + res[i - 3];
        break;
      case 4:
        for (int64_t i = 4; i < blocksize; ++i)
          x[i] = 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4] + res[i - 4];
        break;
    }
  } else if (type_code >= 32) {
    int order = type_code - 31;
    if (order > blocksize) return kErrBadStream;
    for (int i = 0; i < order; ++i) x[i] = r.read_signed(ebps);
    int precision = (int)r.read(4) + 1;
    if (precision == 16) return kErrBadStream;
    int shift = (int)r.read_signed(5);
    if (shift < 0) return kErrBadStream;
    int64_t qcoefs[32];
    for (int i = 0; i < order; ++i) qcoefs[i] = r.read_signed(precision);
    scratch.resize(blocksize - order);
    int rc = read_residual(r, blocksize, order, scratch.data());
    if (rc) return rc;
    const int64_t* res = scratch.data();
    for (int64_t i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += qcoefs[j] * x[i - 1 - j];
      x[i] = (pred >> shift) + res[i - order];
    }
  } else {
    return kErrReserved;
  }
  if (r.overrun) return kErrTruncated;
  if (wasted)
    for (int64_t i = 0; i < blocksize; ++i) x[i] <<= wasted;
  return 0;
}

}  // namespace

extern "C" {

// out7: sample_rate, channels, bits_per_sample, total_samples,
//       min_blocksize, max_blocksize, first_frame_offset
int w2l_flac_parse_info(const uint8_t* data, int64_t len, int64_t* out7) {
  StreamInfo info;
  int rc = parse_info(data, len, &info);
  if (rc) return rc;
  out7[0] = info.sample_rate;
  out7[1] = info.channels;
  out7[2] = info.bits_per_sample;
  out7[3] = info.total_samples;
  out7[4] = info.min_blocksize;
  out7[5] = info.max_blocksize;
  out7[6] = info.first_frame;
  return 0;
}

// Decode the whole stream into `out` (interleaved int32, capacity `cap`
// per-channel sample counts x channels).  flags bit0 = verify CRCs.
// Returns the number of per-channel samples decoded, or a negative error.
int64_t w2l_flac_decode_all(const uint8_t* data, int64_t len, int32_t* out,
                        int64_t cap, int flags) {
  StreamInfo info;
  int rc = parse_info(data, len, &info);
  if (rc) return rc;
  const bool verify = flags & 1;
  int64_t pos = info.first_frame;
  int64_t total = 0;
  std::vector<int64_t> ch0, ch1, scratch;
  while (pos + 2 <= len) {
    BitReader r(data, len, pos);
    if (r.read(14) != 0x3FFE) return kErrBadSync;
    if (r.read(1)) return kErrReserved;
    r.read(1);  // blocking strategy
    int bs_code = (int)r.read(4);
    int sr_code = (int)r.read(4);
    int assignment = (int)r.read(4);
    int ss_code = (int)r.read(3);
    if (r.read(1)) return kErrReserved;
    uint64_t number;
    rc = read_utf8_number(r, &number);
    if (rc) return rc;
    int64_t blocksize;
    if (bs_code == 0) return kErrReserved;
    else if (bs_code == 1) blocksize = 192;
    else if (bs_code <= 5) blocksize = 576ll << (bs_code - 2);
    else if (bs_code == 6) blocksize = (int64_t)r.read(8) + 1;
    else if (bs_code == 7) blocksize = (int64_t)r.read(16) + 1;
    else blocksize = 256ll << (bs_code - 8);
    if (sr_code == 12) r.read(8);
    else if (sr_code == 13 || sr_code == 14) r.read(16);
    else if (sr_code == 15) return kErrReserved;
    int64_t header_end = r.byte;
    uint64_t hcrc = r.read(8);
    if (r.overrun) return kErrTruncated;
    if (verify && crc8(data + pos, header_end - pos) != hcrc) return kErrCrc8;

    static const int kSampleSize[8] = {0, 8, 12, 0, 16, 20, 24, 32};
    int bps = kSampleSize[ss_code];
    if (bps == 0) bps = (int)info.bits_per_sample;

    int channels;
    if (assignment < 8) {
      channels = assignment + 1;
      if (channels != (int)info.channels) return kErrBadStream;
      if (total + blocksize > cap) return kErrCapacity;
      ch0.resize(blocksize);
      for (int c = 0; c < channels; ++c) {
        rc = decode_subframe(r, blocksize, bps, ch0.data(), scratch);
        if (rc) return rc;
        int32_t* dst = out + total * channels + c;
        for (int64_t i = 0; i < blocksize; ++i) dst[i * channels] = (int32_t)ch0[i];
      }
    } else if (assignment <= 10) {
      channels = 2;
      if (info.channels != 2) return kErrBadStream;
      if (total + blocksize > cap) return kErrCapacity;
      ch0.resize(blocksize);
      ch1.resize(blocksize);
      int bits0 = bps + (assignment == 9 ? 1 : 0);
      int bits1 = bps + (assignment != 9 ? 1 : 0);
      rc = decode_subframe(r, blocksize, bits0, ch0.data(), scratch);
      if (rc) return rc;
      rc = decode_subframe(r, blocksize, bits1, ch1.data(), scratch);
      if (rc) return rc;
      int32_t* dst = out + total * 2;
      for (int64_t i = 0; i < blocksize; ++i) {
        int64_t left, right;
        if (assignment == 8) {          // left/side
          left = ch0[i];
          right = ch0[i] - ch1[i];
        } else if (assignment == 9) {   // right/side
          left = ch0[i] + ch1[i];
          right = ch1[i];
        } else {                        // mid/side
          int64_t side = ch1[i];
          int64_t m2 = (ch0[i] << 1) | (side & 1);
          left = (m2 + side) >> 1;
          right = (m2 - side) >> 1;
        }
        dst[i * 2] = (int32_t)left;
        dst[i * 2 + 1] = (int32_t)right;
      }
    } else {
      return kErrReserved;
    }
    r.align();
    if (r.byte + 2 > len) return kErrTruncated;
    uint16_t fcrc = (uint16_t)((data[r.byte] << 8) | data[r.byte + 1]);
    if (verify && crc16(data + pos, r.byte - pos) != fcrc) return kErrCrc16;
    pos = r.byte + 2;
    total += blocksize;
    if (info.total_samples && total >= info.total_samples) break;
  }
  if (info.total_samples && total > info.total_samples) total = info.total_samples;
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Encoder (fixed predictors + Rice): what make_offline_corpus writes its
// FLAC corpus with.  The Python encoder in data/flac.py is richer (LPC,
// stereo decorrelation, forced paths) but loops per sample in Python.
// ---------------------------------------------------------------------------

namespace {

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t byte = 0;
  int bit = 0;  // bits already used in out[byte]
  bool overflow = false;

  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}

  inline void write(uint64_t value, int bits) {
    while (bits > 0) {
      if (byte >= cap) { overflow = true; return; }
      if (bit == 0) out[byte] = 0;
      int avail = 8 - bit;
      int take = bits < avail ? bits : avail;
      uint8_t chunk = (uint8_t)((value >> (bits - take)) & ((1u << take) - 1));
      out[byte] |= chunk << (avail - take);
      bit += take;
      bits -= take;
      if (bit == 8) { bit = 0; ++byte; }
    }
  }

  inline void write_unary(int64_t n) {
    while (n >= 32) { write(0, 32); n -= 32; }
    write(1, (int)n + 1);
  }

  inline void align() { if (bit) write(0, 8 - bit); }
};

inline uint64_t zigzag64(int64_t v) {
  return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}

void write_utf8_number(BitWriter& w, uint64_t value) {
  if (value < 0x80) { w.write(value, 8); return; }
  static const int kBits[] = {11, 16, 21, 26, 31, 36};
  for (int i = 0; i < 6; ++i) {
    int nbytes = i + 2;
    if (value < (1ull << kBits[i])) {
      uint64_t lead = (0xFFu << (8 - nbytes)) & 0xFF;
      w.write(lead | (value >> (6 * (nbytes - 1))), 8);
      for (int j = nbytes - 2; j >= 0; --j)
        w.write(0x80 | ((value >> (6 * j)) & 0x3F), 8);
      return;
    }
  }
}

int best_rice_param(const uint64_t* uz, int64_t n, int64_t* cost_out) {
  if (n == 0) { *cost_out = 0; return 0; }
  uint64_t sum = 0;
  for (int64_t i = 0; i < n; ++i) sum += uz[i];
  double mean = (double)sum / (double)n;
  int guess = 0;
  while (guess < 30 && (1ull << (guess + 1)) < (uint64_t)(mean + 1)) ++guess;
  int best = guess;
  int64_t best_cost = INT64_MAX;
  for (int p = guess > 0 ? guess - 1 : 0; p <= guess + 2 && p <= 30; ++p) {
    int64_t c = 0;
    for (int64_t i = 0; i < n; ++i) c += (int64_t)(uz[i] >> p);
    c += n * (p + 1);
    if (c < best_cost) { best_cost = c; best = p; }
  }
  *cost_out = best_cost;
  return best;
}

}  // namespace

extern "C" {

// Encode interleaved int32 PCM (mono or independent channels) to FLAC with
// fixed predictors.  Returns bytes written or a negative error.
int64_t w2l_flac_encode_fixed(const int32_t* samples, int64_t n, int channels,
                          int64_t sample_rate, int bps, int64_t blocksize,
                          const uint8_t* md5_16, uint8_t* out, int64_t cap) {
  if (channels < 1 || channels > 8 || bps < 4 || bps > 32) return kErrBadStream;
  BitWriter w(out, cap);
  w.write(0x664C6143u, 32);  // "fLaC"
  // STREAMINFO (last metadata block). min/max framesize left 0 (unknown).
  w.write(0x80, 8);
  w.write(34, 24);
  int64_t min_bs = n < blocksize && n > 0 ? n : blocksize;
  int64_t last_bs = n % blocksize ? n % blocksize : blocksize;
  if (n > 0 && last_bs < min_bs) min_bs = last_bs;
  w.write((uint64_t)min_bs, 16);
  w.write((uint64_t)blocksize, 16);
  w.write(0, 24);
  w.write(0, 24);
  w.write((uint64_t)sample_rate, 20);
  w.write((uint64_t)(channels - 1), 3);
  w.write((uint64_t)(bps - 1), 5);
  w.write((uint64_t)n, 36);
  for (int i = 0; i < 16; ++i) w.write(md5_16 ? md5_16[i] : 0, 8);

  std::vector<int64_t> x, res[5];
  std::vector<uint64_t> uz;
  int64_t frame_index = 0;
  for (int64_t start = 0; start < n; start += blocksize, ++frame_index) {
    int64_t bs = n - start < blocksize ? n - start : blocksize;
    int64_t header_start = w.byte;
    w.write(0x3FFE, 14);
    w.write(0, 1);
    w.write(0, 1);  // fixed blocksize strategy
    int bs_code;
    switch (bs) {
      case 192: bs_code = 1; break;
      case 576: bs_code = 2; break;
      case 1152: bs_code = 3; break;
      case 2304: bs_code = 4; break;
      case 4608: bs_code = 5; break;
      case 256: bs_code = 8; break;
      case 512: bs_code = 9; break;
      case 1024: bs_code = 10; break;
      case 2048: bs_code = 11; break;
      case 4096: bs_code = 12; break;
      case 8192: bs_code = 13; break;
      case 16384: bs_code = 14; break;
      case 32768: bs_code = 15; break;
      default: bs_code = bs <= 256 ? 6 : 7;
    }
    w.write((uint64_t)bs_code, 4);
    int sr_code;
    switch (sample_rate) {
      case 88200: sr_code = 1; break;
      case 176400: sr_code = 2; break;
      case 192000: sr_code = 3; break;
      case 8000: sr_code = 4; break;
      case 16000: sr_code = 5; break;
      case 22050: sr_code = 6; break;
      case 24000: sr_code = 7; break;
      case 32000: sr_code = 8; break;
      case 44100: sr_code = 9; break;
      case 48000: sr_code = 10; break;
      case 96000: sr_code = 11; break;
      default: sr_code = sample_rate < 65536 ? 13 : 0;
    }
    w.write((uint64_t)sr_code, 4);
    w.write((uint64_t)(channels - 1), 4);
    int ss_code;
    switch (bps) {
      case 8: ss_code = 1; break;
      case 12: ss_code = 2; break;
      case 16: ss_code = 4; break;
      case 20: ss_code = 5; break;
      case 24: ss_code = 6; break;
      case 32: ss_code = 7; break;
      default: ss_code = 0;
    }
    w.write((uint64_t)ss_code, 3);
    w.write(0, 1);
    write_utf8_number(w, (uint64_t)frame_index);
    if (bs_code == 6) w.write((uint64_t)(bs - 1), 8);
    else if (bs_code == 7) w.write((uint64_t)(bs - 1), 16);
    if (sr_code == 13) w.write((uint64_t)sample_rate, 16);
    if (w.overflow) return kErrCapacity;
    w.align();  // header is always whole bytes here
    w.write(crc8(out + header_start, w.byte - header_start), 8);

    for (int c = 0; c < channels; ++c) {
      x.resize(bs);
      for (int64_t i = 0; i < bs; ++i) x[i] = samples[(start + i) * channels + c];
      // Constant subframe?
      bool constant = true;
      for (int64_t i = 1; i < bs && constant; ++i) constant = x[i] == x[0];
      if (constant) {
        w.write(0, 1); w.write(0, 6); w.write(0, 1);
        w.write((uint64_t)x[0] & ((1ull << bps) - 1), bps);
        continue;
      }
      // Fixed orders 0..4: pick by sum |residual| proxy.
      int max_order = bs - 1 < 4 ? (int)(bs - 1) : 4;
      res[0].assign(x.begin(), x.end());
      unsigned best_order = 0;
      double best_sum = 1e300;
      for (int o = 0; o <= max_order; ++o) {
        if (o > 0) {
          res[o].resize(bs - o);
          for (int64_t i = 0; i < bs - o; ++i)
            res[o][i] = res[o - 1][i + 1] - res[o - 1][i];
        }
        double s = 0;
        for (int64_t v_i = 0; v_i < (int64_t)res[o].size(); ++v_i)
          s += (double)(res[o][v_i] < 0 ? -res[o][v_i] : res[o][v_i]);
        if (s < best_sum) { best_sum = s; best_order = o; }
      }
      int order = best_order;
      const std::vector<int64_t>& r = res[order];
      w.write(0, 1); w.write((uint64_t)(8 + order), 6); w.write(0, 1);
      for (int i = 0; i < order; ++i)
        w.write((uint64_t)x[i] & ((1ull << bps) - 1), bps);
      // Residual: partition order up to 3 where divisible.
      int porder = 0;
      while (porder < 3 && bs % (1ll << (porder + 1)) == 0 &&
             (bs >> (porder + 1)) > order)
        ++porder;
      uz.resize(r.size());
      for (size_t i = 0; i < r.size(); ++i) uz[i] = zigzag64(r[i]);
      // Pick params per partition; RICE2 if any param needs >= 15.
      int64_t nparts = 1ll << porder;
      int64_t psize = bs >> porder;
      int params[8];
      bool need_rice2 = false;
      int64_t off = 0;
      for (int64_t p = 0; p < nparts; ++p) {
        int64_t count = p == 0 ? psize - order : psize;
        int64_t cost;
        params[p] = best_rice_param(uz.data() + off, count, &cost);
        if (params[p] >= 15) need_rice2 = true;
        off += count;
      }
      int method = need_rice2 ? 1 : 0;
      int pbits = need_rice2 ? 5 : 4;
      w.write((uint64_t)method, 2);
      w.write((uint64_t)porder, 4);
      off = 0;
      for (int64_t p = 0; p < nparts; ++p) {
        int64_t count = p == 0 ? psize - order : psize;
        int param = params[p];
        w.write((uint64_t)param, pbits);
        for (int64_t i = 0; i < count; ++i) {
          uint64_t u = uz[off + i];
          w.write_unary((int64_t)(u >> param));
          if (param) w.write(u & ((1ull << param) - 1), param);
        }
        off += count;
        if (w.overflow) return kErrCapacity;
      }
    }
    w.align();
    if (w.overflow) return kErrCapacity;
    uint16_t fcrc = crc16(out + header_start, w.byte - header_start);
    w.write(fcrc, 16);
  }
  if (w.overflow) return kErrCapacity;
  return w.byte;
}

}  // extern "C"
