"""Corpus-level ratio accumulation for WER/CER."""

from __future__ import annotations


class RatioAccumulator:
    """Corpus-level (numerator, denominator) accumulation across batches."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.denoms: dict[str, float] = {}

    def add(self, key: str, num: float, denom: float):
        self.sums[key] = self.sums.get(key, 0.0) + num
        self.denoms[key] = self.denoms.get(key, 0.0) + denom

    def ratios(self) -> dict:
        return {k: self.sums[k] / max(self.denoms[k], 1e-12)
                for k in self.sums}
