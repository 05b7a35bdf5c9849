"""The wavefront helpers of allwave_tpu/wfa/batch.py that the wavefront
checkpoint-replay engine (wfa/wf_segmented.py) uses, in PyTorch.

Conventions are the reference's: pattern = query (v), text = target
(h), diagonal k = h - v, a wavefront stores the offset h per diagonal,
NULL marks a diagonal with no value. The rest of the reference's
batch.py serves its one-shot BatchWavefrontAligner, which the port does
not carry.
"""

from __future__ import annotations

import torch

from .segmented import expand_runs_to_cigar  # noqa: F401  (re-exported)

NULL = -(2**30)

# op codes of the run buffers (the core.types byte values)
_OP_M = ord("M")
_OP_X = ord("X")
_OP_I = ord("I")
_OP_D = ord("D")


def _shift_right(a: torch.Tensor) -> torch.Tensor:
    """Along the last (diagonal) axis: out[..., c] = a[..., c-1], NULL in."""
    return torch.cat([torch.full_like(a[..., :1], NULL), a[..., :-1]], -1)


def _shift_left(a: torch.Tensor) -> torch.Tensor:
    """out[..., c] = a[..., c+1], NULL in."""
    return torch.cat([a[..., 1:], torch.full_like(a[..., :1], NULL)], -1)


def _band_geometry(qlens: torch.Tensor, tlens: torch.Tensor, K: int):
    """(k_end, k0): the band covers diagonals [k0, k0+K), always holding
    0 and k_end = tlen - qlen, with the slack split evenly. Unlike the
    dense engine's band_geometry (wfa/dense.py), k0 is not even-aligned."""
    k_end = tlens - qlens
    slack = torch.div(K - 1 - k_end.abs(), 2, rounding_mode="floor")
    return k_end, k_end.clamp(max=0) - slack


def _make_masks(qlens: torch.Tensor, tlens: torch.Tensor, k0: torch.Tensor, K: int):
    """(ks, h_max), both (B, K): each band diagonal's k and the largest
    offset it can hold, min(tlen, qlen + k); -1 on diagonals outside
    [-qlen, tlen]."""
    ks = k0[:, None] + torch.arange(K, dtype=k0.dtype, device=k0.device)[None, :]
    h_max = torch.minimum(tlens[:, None], qlens[:, None] + ks)
    valid = (ks >= -qlens[:, None]) & (ks <= tlens[:, None])
    return ks, torch.where(valid, h_max, -1)
