"""Shared acoustic-model pieces."""

from __future__ import annotations

import torch


def hardtanh_0_20(x: torch.Tensor) -> torch.Tensor:
    """clamp(0, 20) activation."""
    return torch.clamp(x, 0.0, 20.0)


def same_pad_amount(t_in: int, kernel: int, stride: int,
                    dilation: int) -> tuple[int, int]:
    """SAME padding (left, right) for a 1-D conv over a length-``t_in``
    axis: ceil(t_in / stride) output frames, the odd sample on the right."""
    out_t = (t_in + stride - 1) // stride
    pad = max(0, (out_t - 1) * stride + (kernel - 1) * dilation + 1 - t_in)
    return pad // 2, pad - pad // 2
