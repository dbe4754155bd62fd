"""Edit distance in plain Python (Wagner-Fischer, two rolling rows).

The JAX package's native C++ library is not ported yet.
"""

from __future__ import annotations


def distance(a, b) -> int:
    """Levenshtein distance between two strings or integer sequences."""
    a, b = list(a), list(b)
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        curr = [i] + [0] * len(b)
        for j, cb in enumerate(b, start=1):
            curr[j] = min(prev[j] + 1, curr[j - 1] + 1,
                          prev[j - 1] + (ca != cb))
        prev = curr
    return prev[-1]
