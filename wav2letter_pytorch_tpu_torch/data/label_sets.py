"""Label sets (alphabets) for CTC models.

English (upper/lower) and Hebrew alphabets, with the CTC blank ``'_'`` at
index 0 and a trailing space appended to every set (the English sets have
29 symbols). Same contents as ``wav2letter_pytorch_tpu.data.label_sets``.
"""

_ENGLISH_BASE = ["'", 'A', 'B', 'C', 'D', 'E', 'F', 'G', 'H', 'I', 'J',
                 'K', 'L', 'M', 'N', 'O', 'P', 'Q', 'R', 'S', 'T', 'U', 'V',
                 'W', 'X', 'Y', 'Z']

_HEBREW_BASE = ['א', 'ב', 'ג', 'ד', 'ה', 'ו', 'ז', 'ח', 'ט', 'י', 'כ', 'ל',
                'מ', 'נ', 'ס', 'ע', 'פ', 'צ', 'ק', 'ר', 'ש', 'ת', 'ן', 'ף',
                'ץ', 'ם', 'ך']

BLANK = '_'
SPACE = ' '


def _with_blank_and_space(base):
    return [BLANK] + list(base) + [SPACE]


english_labels = _with_blank_and_space(_ENGLISH_BASE)
english_lowercase_labels = _with_blank_and_space(s.lower() for s in _ENGLISH_BASE)
hebrew_labels = _with_blank_and_space(_HEBREW_BASE)

labels_map = {
    'english': english_labels,
    'english_lowercase': english_lowercase_labels,
    'hebrew': hebrew_labels,
}


def resolve_labels(labels):
    """Return a concrete label list from either a set name or a list."""
    if isinstance(labels, str):
        return list(labels_map[labels])
    return list(labels)
