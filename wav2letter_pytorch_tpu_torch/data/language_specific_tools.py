"""Hebrew final-letter forms: word-final normal letters to their final
forms and back (the same maps as the JAX package's module)."""

_NORMAL_TO_FINAL = [('צ', 'ץ'), ('פ', 'ף'), ('כ', 'ך'), ('מ', 'ם'), ('נ', 'ן')]


def _convert(strings, pairs):
    if isinstance(strings, list):
        return [_convert(s, pairs) for s in strings]
    # A space appended so that a letter ending the string is word-final
    # like one followed by a space.
    res = strings + ' '
    for src, dst in pairs:
        res = res.replace(src + ' ', dst + ' ')
    return res[:-1]


def hebrew_normal_to_final(strings):
    return _convert(strings, _NORMAL_TO_FINAL)


def hebrew_final_to_normal(strings):
    return _convert(strings, [(b, a) for a, b in _NORMAL_TO_FINAL])
