"""Build a speech corpus offline: formant-synthesized utterances written as
FLAC (or WAV), with CSV manifests in pandas' layout.

    python -m wav2letter_pytorch_tpu_torch.make_offline_corpus \
        --root /data/corpus [--n-train 3000 --n-val 200 --n-test 200 \
        --sample-rate 16000 --seed 0 --wav --lang english|hebrew \
        --snr-db 18,38 --min-duration 0 --splits train,val,test]

The port's copy of the JAX package's ``scripts/make_offline_corpus.py``:
the same numpy synthesis (source-filter letters, per-utterance speakers,
coarticulation, noise at a random SNR, sentences from a 200-word
vocabulary, each split seeded apart: train ``seed``, val ``seed + 1``,
test ``seed + 2``) and the same flags, so the same seeds write the same
corpus byte for byte. FLAC goes through the host library's C++ encoder
(``data/flac_native.py``) from ``round(audio * 32767)``; ``--wav``
through ``data/audio_io.write_wav``. Layout:

    <root>/{train,val,test}/utt<i>.flac
    <root>/{train,val,test}_manifest.csv
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# ---------------------------------------------------------------------------
# Letter -> acoustic spec. Formant values are textbook male-voice targets;
# consonant classes get the articulation that matters for separability in a
# log-mel front end (burst/fricative spectra, nasal murmur, glides).
# ---------------------------------------------------------------------------

VOWELS = {
    'a': (730, 1090, 2440), 'e': (530, 1840, 2480), 'i': (270, 2290, 3010),
    'o': (570, 840, 2410), 'u': (300, 870, 2240),
}
GLIDES = {  # voiced, vowel-like but shorter/weaker
    'l': (380, 1200, 2600), 'r': (420, 1300, 1600), 'w': (330, 700, 2300),
    'y': (290, 2100, 2900), 'h': None,  # h handled as aspiration noise
}
NASALS = {'m': (250, 1000, 2200), 'n': (250, 1450, 2500)}
VOICED_FRIC = {'v': 4000, 'z': 5500, 'j': 3000}          # noise + voicing
UNVOICED_FRIC = {'f': 4500, 's': 6200, 'x': 3400, 'c': 3200, 'q': 2000}
PLOSIVES = {  # burst center frequency; voiced ones get a voice bar
    'p': (800, False), 'b': (800, True), 't': (4000, False),
    'd': (4000, True), 'k': (2200, False), 'g': (2200, True),
}

WORDS = """the of and to in is you that it he was for on are as with his they
at be this have from or one had by word but not what all were we when your can
said there use an each which she do how their if will up other about out many
then them these so some her would make like him into time has look two more
write go see number no way could people my than first water been call who oil
its now find long down day did get come made may part over new sound take only
little work know place year live me back give most very after thing our just
name good sentence man think say great where help through much before line
right too mean old any same tell boy follow came want show also around form
three small set put end does another well large must big even such because
turn here why ask went men read need land different home us move try kind hand
picture again change off play spell air away animal house point page letter
mother answer found study still learn should america world""".split()


# ---------------------------------------------------------------------------
# Hebrew (modern Israeli pronunciation, consonantal ktiv-haser orthography).
# Each Hebrew letter borrows the closest acoustic spec above; sounds English
# lacks get their own pseudo-letter entries. Final forms (ך ם ן ץ) share the
# base letter's acoustics — telling them apart is a genuinely positional task
# (they occur only word-finally) — except ף, which is /f/ (word-final פ
# spirantizes in Modern Hebrew) and so is acoustically distinct. Exercises
# the hebrew label set and its final forms end to end.
# ---------------------------------------------------------------------------
UNVOICED_FRIC['š'] = 2800.0    # ש /ʃ/
UNVOICED_FRIC['ţ'] = 5000.0    # צ ץ /ts/
PLOSIVES['ŧ'] = (3000, False)  # ת /t/ (burst distinct from ט)

HEBREW_TO_PHONE = {
    'א': 'a', 'ב': 'b', 'ג': 'g', 'ד': 'd', 'ה': 'h', 'ו': 'v', 'ז': 'z',
    'ח': 'x', 'ט': 't', 'י': 'y', 'כ': 'k', 'ל': 'l', 'מ': 'm', 'נ': 'n',
    'ס': 's', 'ע': 'o', 'פ': 'p', 'צ': 'ţ', 'ק': 'q', 'ר': 'r', 'ש': 'š',
    'ת': 'ŧ', 'ך': 'k', 'ם': 'm', 'ן': 'n', 'ף': 'f', 'ץ': 'ţ', ' ': ' ',
}

HEBREW_WORDS = """שלום מה מי אני אתה הוא היא אנחנו הם בית ספר מים אור יום
לילה שנה עיר דרך ילד ילדה אבא אמא טוב גדול קטן חדש ישן אחד שלוש ארבע חמש שש
שבע תשע עשר איש אשה ראש יד רגל עין לב שמש ירח כוכב ארץ שמים עץ פרח צפור דג
כלב חתול סוס לחם חלב דבש מלך מלכה עם שפה עבודה זמן מקום דבר קול שם בן בת אח
אחות משפחה חבר שיר ספור תפוח ענב רמון זית שמן יין כסף זהב אבן הר ים נהר גשם
רוח אש אדמה שדה גן דלת חלון שלחן כסא מטה אהבה שמחה אמת שלם חי רץ הלך בא יצא
עלה ירד ראה שמע אמר כתב קרא למד אכל שתה ישב עמד נתן לקח""".split()

LANG_TABLES = {
    'english': (WORDS, None),
    'hebrew': (HEBREW_WORDS, HEBREW_TO_PHONE),
}


def _formant_gain(freqs, formants, scale, tilt_db_oct=-6.0):
    """|H(f)| of a cascade of resonance peaks plus spectral tilt."""
    gain = np.zeros_like(freqs)
    for i, f0 in enumerate(formants):
        fc = f0 * scale
        bw = 60.0 + 0.05 * fc
        peak = 1.0 / (1.0 + ((freqs - fc) / bw) ** 2)
        gain += peak * (0.9 ** i)
    tilt = 10 ** (tilt_db_oct / 20.0 * np.log2(np.maximum(freqs, 60) / 300))
    return gain * tilt


def _noise_gain(freqs, center, width=1500.0):
    return np.exp(-0.5 * ((freqs - center) / width) ** 2) + 0.02


def _pulse_train(n, f0_curve, sr, rng):
    """Glottal source: impulses at (jittered) pitch periods, differentiated
    to a -6 dB/oct source spectrum."""
    src = np.zeros(n)
    t = 0.0
    while t < n - 1:
        i = int(t)
        src[i] = 1.0
        period = sr / max(f0_curve[min(i, n - 1)], 40.0)
        t += period * (1.0 + 0.01 * rng.standard_normal())
    # leaky integration of impulses -> decaying pulses (soft glottal shape)
    k = int(0.004 * sr)
    shape = np.exp(-np.arange(k) / (0.001 * sr))
    return np.convolve(src, shape)[:n]


def _shape(src, sr, gain):
    """Zero-phase spectral shaping of a segment by |H| sampled on rfft bins."""
    n = len(src)
    spec = np.fft.rfft(src)
    freqs = np.fft.rfftfreq(n, d=1.0 / sr)
    return np.fft.irfft(spec * gain(freqs), n=n)


def render_letter(ch, n, sr, speaker, f0_curve, rng):
    """One letter segment of n samples."""
    fs = speaker['formant_scale']
    if ch == ' ':
        return np.zeros(n)
    if ch == "'":
        return np.zeros(n)  # glottal stop: silence
    if ch in VOWELS or ch in GLIDES or ch in NASALS:
        if ch == 'h':
            noise = rng.standard_normal(n)
            return 0.25 * _shape(noise, sr, lambda f: _noise_gain(f, 1500,
                                                                  2500))
        table = VOWELS.get(ch) or GLIDES.get(ch) or NASALS.get(ch)
        src = _pulse_train(n, f0_curve, sr, rng)
        amp = 1.0 if ch in VOWELS else 0.55
        out = _shape(src, sr, lambda f: _formant_gain(f, table, fs))
        if ch in NASALS:  # anti-resonance dampens highs
            out = _shape(out, sr, lambda f: 1.0 / (1.0 + (f / 2500) ** 2))
        return amp * out
    if ch in VOICED_FRIC:
        src = _pulse_train(n, f0_curve, sr, rng)
        voiced = _shape(src, sr,
                        lambda f: _formant_gain(f, (300, 1400, 2500), fs))
        noise = _shape(rng.standard_normal(n), sr,
                       lambda f: _noise_gain(f, VOICED_FRIC[ch] * fs))
        return 0.4 * voiced + 0.35 * noise
    if ch in UNVOICED_FRIC:
        noise = _shape(rng.standard_normal(n), sr,
                       lambda f: _noise_gain(f, UNVOICED_FRIC[ch] * fs))
        return 0.5 * noise
    if ch in PLOSIVES:
        center, voiced = PLOSIVES[ch]
        out = np.zeros(n)
        burst_n = min(max(int(0.025 * sr), 8), n)
        closure = n - burst_n
        burst = _shape(rng.standard_normal(burst_n), sr,
                       lambda f: _noise_gain(f, center * fs, 1200))
        env = np.exp(-np.arange(burst_n) / (0.008 * sr))
        out[closure:] = 0.9 * burst * env
        if voiced and closure > 8:
            bar = _pulse_train(closure, f0_curve[:closure], sr, rng)
            out[:closure] = 0.12 * _shape(
                bar, sr, lambda f: 1.0 / (1.0 + (f / 400) ** 2))
        return out
    raise ValueError(f'no acoustics for letter {ch!r}')


def render_utterance(text, sr, rng, snr_range=(18.0, 38.0), phone_map=None):
    speaker = {
        'f0': float(rng.uniform(85, 230)),
        'formant_scale': float(rng.uniform(0.88, 1.15)),
        'rate': float(rng.uniform(0.85, 1.2)),
        'gain': float(rng.uniform(0.6, 1.0)),
    }
    base_letter_s = 0.075
    gap_s = 0.012
    segs = []
    # Segment lengths first (for the utterance-level f0 declination).
    lens = []
    for ch in text:
        dur = base_letter_s * speaker['rate'] * rng.uniform(0.75, 1.3)
        if ch == ' ':
            dur = 0.06 * speaker['rate']
        lens.append(int(dur * sr))
    total = sum(lens) + int(gap_s * sr) * len(text)
    decl = np.linspace(1.1, 0.85, total)  # pitch declination over utterance
    f0_all = speaker['f0'] * decl * (
        1 + 0.03 * np.sin(2 * np.pi * np.arange(total) * 3.0 / sr))
    pos = 0
    xfade = int(0.010 * sr)
    out = np.zeros(total)
    for ch, n in zip(text, lens):
        phone = phone_map[ch] if phone_map else ch
        seg = render_letter(phone, n, sr, speaker, f0_all[pos:pos + n], rng)
        # crossfade into place (coarticulation-ish blending at boundaries)
        a, b = pos, pos + n
        if a >= xfade and n > 2 * xfade:
            ramp = np.linspace(0, 1, xfade)
            seg[:xfade] *= ramp
            out[a - xfade // 2:a - xfade // 2 + xfade] *= (1 - ramp)
            a -= xfade // 2
            b -= xfade // 2
        out[a:b] += seg[:b - a]
        pos += n + int(gap_s * sr)
    # Loudness normalize, then add noise at a random SNR.
    rms = np.sqrt(np.mean(out ** 2)) + 1e-9
    out = out / rms * 0.08 * speaker['gain']
    snr_db = rng.uniform(*snr_range)
    noise_rms = 0.08 * speaker['gain'] * 10 ** (-snr_db / 20)
    out = out + noise_rms * rng.standard_normal(total)
    return np.clip(out, -0.99, 0.99).astype(np.float32)


def make_sentence(rng, words=WORDS):
    n = int(rng.integers(3, 9))
    return ' '.join(rng.choice(words) for _ in range(n))


def write_utt(path, audio, sr, use_wav):
    if use_wav:
        from .data.audio_io import write_wav
        write_wav(path, audio, sr)
        return
    from .data.flac_native import encode_native
    pcm = np.round(audio * 32767).astype(np.int32)
    with open(path, 'wb') as f:
        f.write(encode_native(pcm, sr))


def build_split(root, split, n, sr, seed, use_wav,
                snr_range=(18.0, 38.0), lang='english',
                min_duration=0.0):
    from .data.prepare_librispeech import write_csv_manifest
    rng = np.random.default_rng(seed)
    d = os.path.join(root, split)
    os.makedirs(d, exist_ok=True)
    rows = []
    ext = 'wav' if use_wav else 'flac'
    words, phone_map = LANG_TABLES[lang]
    for i in range(n):
        text = make_sentence(rng, words)
        audio = render_utterance(text, sr, rng, snr_range=snr_range,
                                 phone_map=phone_map)
        # --min-duration: extend the sentence until the rendered audio is
        # long enough (e.g. past a streamer's prime window, so streaming
        # evals stream instead of taking the offline fallback).
        while min_duration and audio.shape[0] < min_duration * sr:
            text = text + ' ' + make_sentence(rng, words)
            audio = render_utterance(text, sr, rng, snr_range=snr_range,
                                     phone_map=phone_map)
        path = os.path.abspath(os.path.join(d, f'utt{i}.{ext}'))
        write_utt(path, audio, sr, use_wav)
        rows.append((path, text))
        if (i + 1) % 200 == 0:
            print(f'{split}: {i + 1}/{n}')
    manifest = os.path.join(root, f'{split}_manifest.csv')
    write_csv_manifest(rows, manifest)
    return manifest


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root', required=True)
    parser.add_argument('--n-train', type=int, default=3000)
    parser.add_argument('--n-val', type=int, default=200)
    parser.add_argument('--n-test', type=int, default=200)
    parser.add_argument('--sample-rate', type=int, default=16000)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--wav', action='store_true',
                        help='write WAV instead of FLAC')
    parser.add_argument('--splits', default='train,val,test',
                        help='which splits to build (comma list)')
    parser.add_argument('--snr-db', default='18,38',
                        help='per-utterance SNR range in dB, "lo,hi" — '
                             'e.g. 0,10 builds a noise-robustness eval set')
    parser.add_argument('--lang', default='english',
                        choices=sorted(LANG_TABLES),
                        help='transcript language (hebrew exercises the '
                             'hebrew label set incl. final letter forms)')
    parser.add_argument('--min-duration', type=float, default=0.0,
                        help='minimum utterance length in seconds; short '
                             'draws are extended with more words (w2l-20 '
                             'streaming prime window is 4.22 s — use ~6 '
                             'for streaming evals that actually stream)')
    args = parser.parse_args(argv)
    lo, hi = (float(x) for x in args.snr_db.split(','))
    wanted = {x.strip() for x in args.splits.split(',') if x.strip()}
    manifests = {}
    for split, n, seed in (('train', args.n_train, args.seed),
                           ('val', args.n_val, args.seed + 1),
                           ('test', args.n_test, args.seed + 2)):
        if split not in wanted:
            continue
        manifests[split] = build_split(args.root, split, n, args.sample_rate,
                                       seed, args.wav, snr_range=(lo, hi),
                                       lang=args.lang,
                                       min_duration=args.min_duration)
        print(f'{split}: {manifests[split]}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
