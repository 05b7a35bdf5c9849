"""Set-intersection counts on the device, for orientation and MinHash.

Both reference bodies (allwave_tpu/orient/orientation.py `_decide_device`
and allwave_tpu/sketch/minhash.py `_membership_counts`) turn sketch hash
sets into int8 membership rows over dense ids and get every pairwise
intersection count from one int8 x int8 -> int32 product. The reference
computes that product with XLA `dot_general`, outside any Pallas kernel;
here it is `torch._int_mm`, on the CPU as on the card. Counts are exact
integers: no floating-point product may stand in for it (an fp16
product may be reduced in fp16, exact only up to 2048).

The gates that choose this route (`OrientationIndex.orient_batch`,
`minhash.pairwise_intersection_counts`) keep the reference's order of
routes and its budget checks; the thresholds below replace the
reference's `utils/devlat.calibrated_threshold(192, 48, 384)` and
`(512, 128, 1024)`, which calibrate a TPU's link and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


#: full-matrix orientation requests (OrientationIndex.orient_batch) run
#: on a CUDA device from this many sets, MinHash distance matrices
#: (minhash.pairwise_intersection_counts) from COUNT_DEVICE_MIN_N: smoke
#: phase 17's crossovers on the card with the route's one-time set-up in
#: a fresh process (cuBLASLt's int8 path, the lazily loaded kernels)
#: added to the device's time (PERF.md, "Orientation and MinHash
#: thresholds")
ORIENT_DEVICE_MIN_N = 512
COUNT_DEVICE_MIN_N = 384


class OverBudget(MemoryError):
    """The membership matrix would exceed the device budget. Raised by
    the host checks before anything is allocated on the device; the
    gates catch this error and no other."""


@dataclass
class RouteCount:
    """Requests served by each route: for orientation `device`,
    `submatrix`, `native` and `numpy`; for MinHash counts `device` and
    `numpy`."""

    counts: dict = field(default_factory=dict)

    def took(self, route: str) -> None:
        self.counts[route] = self.counts.get(route, 0) + 1

    def reset(self) -> None:
        self.counts.clear()


orient_routes = RouteCount()
count_routes = RouteCount()


def membership_counts(codes: np.ndarray, U: int, n_cols: int, device) -> torch.Tensor:
    """(R, n_cols) int32 on `device`: [i, j] = |set_i ∩ set_j| for the
    sets of code rows i < R and j < n_cols.

    codes: (R, S) int32 dense ids in [0, U], one set a row, padded with
    the sentinel U. The int8 membership rows are built on the device by
    scatter; the sentinel's column is then cleared, which drops it as
    the reference's `.at[rows, codes].set(1, mode="drop")` does. Rows
    and columns are padded for `torch._int_mm` (more than 16 rows, inner
    and outer sizes multiples of 8, and 16-byte row strides); zero
    padding changes no count. The right operand is `m[:n_cols].t()`, a
    transposed view of contiguous rows (the product's TN layout)."""
    R = codes.shape[0]
    r_pad = max(-(-R // 8) * 8, 24)
    c_pad = -(-n_cols // 8) * 8
    u_pad = -(-(U + 1) // 64) * 64
    idx = torch.from_numpy(np.ascontiguousarray(codes)).to(device).long()
    m = torch.zeros((r_pad, u_pad), dtype=torch.int8, device=device)
    m[:R].scatter_(1, idx, 1)
    m[:, U] = 0
    return torch._int_mm(m, m[:c_pad].t())[:R, :n_cols]
