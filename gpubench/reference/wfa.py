"""Exact global gap-affine and two-piece-affine alignment with its CIGAR,
in plain PyTorch: the wavefront recurrences (Marco-Sola et al. 2021),
vectorized over the diagonals of a level and over a batch of pairs, with
the full history kept for the traceback.

The result is the canonical alignment of the repository's tie-break
contract (docs/TIEBREAK.md): match runs are maximal; at an M cell the
predecessors rank X > I1 > I2 > D1 > D2; inside a gap, extending beats
opening. `band=B` confines the alignment to B diagonals beyond the hull
[0, k_end] of each pair, with no escalation: a fixed-band aligner, the
control that breaks the exact-score guarantee wherever a pair's optimal
path leaves the band.

Conventions: pattern = query (index v), text = target (index h),
diagonal k = h - v, offsets store h; op codes are the WFA2 ones (M, X,
I consumes the text, D consumes the query). An offset is valid when it is
>= 0; NULL and NULL plus a few steps are invalid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

NULL = -(1 << 30)
OP_M, OP_X, OP_I, OP_D = ord("M"), ord("X"), ord("I"), ord("D")
_C_M, _C_I1, _C_D1, _C_I2, _C_D2 = range(5)
#: first window of the match extension, then the window for the lanes
#: that matched all of it
_EXT_FIRST = 16
_EXT_MORE = 1024
#: int32 elements a block of the history's store: one allocation holds
#: many levels (an allocation a level costs the device a cudaMalloc each)
_STORE_BLOCK = 1 << 24


@dataclass(frozen=True)
class Penalties:
    x: int
    o1: int
    e1: int
    o2: int
    e2: int
    two_piece: bool

    @property
    def max_lookback(self) -> int:
        c = [self.x, self.o1 + self.e1, self.e1]
        if self.two_piece:
            c += [self.o2 + self.e2, self.e2]
        return max(c)

    def gap_cost(self, length: int) -> int:
        c = self.o1 + self.e1 * length
        if self.two_piece:
            c = min(c, self.o2 + self.e2 * length)
        return c

    def reach(self, level: int) -> int:
        """The farthest diagonal a score level can hold: a path to
        diagonal k has gaps of |k| bases at least, and a gap cost is
        subadditive, so it costs gap_cost(|k|) at least."""
        best = max(0, (level - self.o1) // self.e1)
        if self.two_piece:
            best = max(best, (level - self.o2) // self.e2)
        return best


def penalties(scores: str) -> Penalties:
    """The CLI's `-s match,mismatch,open,extend[,open2,extend2]`, resolved
    as allwave resolves it (types.rs:105-117): match must be 0; a second
    gap piece makes it two-piece; open == extend == mismatch is edit
    distance, whose gap costs mismatch + mismatch per base."""
    v = [int(s) for s in scores.split(",")]
    if len(v) not in (4, 6) or v[0] != 0 or v[1] <= 0 or v[3] <= 0:
        raise ValueError(f"unsupported scores {scores!r}")
    if len(v) == 6:
        if v[5] <= 0:
            raise ValueError(f"unsupported scores {scores!r}")
        return Penalties(v[1], v[2], v[3], v[4], v[5], True)
    return Penalties(v[1], v[2], v[3], 0, 0, False)


def _pad(seqs: List[bytes], fill: int, width: int, device) -> torch.Tensor:
    out = np.full((len(seqs), width), fill, dtype=np.uint8)
    for r, s in enumerate(seqs):
        out[r, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return torch.from_numpy(out).to(device)


class _Batch:
    """The forward wavefronts of a batch of pairs, level by level. Every
    level's five components (three for one-piece) live on one full-width
    row per pair, diagonal k at column c + k; a level computes only the
    columns of its reach."""

    def __init__(self, pairs, pen: Penalties, device, band: Optional[int] = None):
        self.pen = pen
        self.dev = device
        self.P = len(pairs)
        self.plen = np.array([len(p) for p, _ in pairs], dtype=np.int64)
        self.tlen = np.array([len(t) for _, t in pairs], dtype=np.int64)
        pm, tm = int(self.plen.max()), int(self.tlen.max())
        self.c = pm + 1
        self.W = pm + tm + 3
        self.ncomp = 5 if pen.two_piece else 3
        self.depth = pen.max_lookback + 1
        self.ring = torch.full((self.depth, self.ncomp, self.P, self.W), NULL,
                               dtype=torch.int32, device=device)
        k = torch.arange(self.W, device=device, dtype=torch.int64) - self.c
        pl = torch.from_numpy(self.plen).to(device)[:, None]
        tl = torch.from_numpy(self.tlen).to(device)[:, None]
        # an offset above h_max leaves the matrix; -1 closes the columns
        # outside [-plen, tlen]
        hmax = torch.minimum(tl, pl + k)
        inside = (k >= -pl) & (k <= tl)
        # the columns any level may fill: all, or the bands' union
        self.cols = (1, self.W - 1)
        if band is not None:
            kend = tl - pl
            inside &= (k >= torch.clamp(kend, max=0) - band) & (k <= torch.clamp(kend, min=0) + band)
            kend_np = self.tlen - self.plen
            self.cols = (max(1, self.c + int(np.minimum(kend_np, 0).min()) - band),
                         min(self.W - 1, self.c + int(np.maximum(kend_np, 0).max()) + band + 1))
        self.hmax = torch.where(inside, hmax, torch.full_like(hmax, -1)).to(torch.int32)
        self.k64 = k
        self.ar_first = torch.arange(_EXT_FIRST, device=device, dtype=torch.int64)
        # query padded with 0, target with 1: the extension stops at the
        # ends without a test
        lp = pm + _EXT_MORE + 2
        lt = tm + _EXT_MORE + 2
        self.pat = _pad([p for p, _ in pairs], 0, lp, device)
        self.txt = _pad([t for _, t in pairs], 1, lt, device)
        self.lp, self.lt = lp, lt
        self.rows = torch.arange(self.P, device=device)
        self.end_col = torch.from_numpy(self.c + self.tlen - self.plen).to(device)
        self.tlen_t = torch.from_numpy(self.tlen).to(device).to(torch.int32)
        #: per level (lowest diagonal, [ncomp, P, width] offsets)
        self.history: List[Tuple[int, torch.Tensor]] = []
        self._store: List[torch.Tensor] = []
        self._used = 0

    def window(self, s: int) -> Tuple[int, int]:
        """(first column, end column) of level s; every valid offset of
        the level lies in these columns."""
        r = min(self.pen.reach(s), self.W)
        return max(self.c - r, self.cols[0]), min(self.c + r + 1, self.cols[1])

    def _extend(self, m: torch.Tensor, a: int, b: int) -> torch.Tensor:
        """Add to m, in place, the length of the match run from (v, h) on
        each diagonal of columns [a, b), up to the first window; returns
        the valid lanes that matched all of it. Invalid lanes stay
        invalid."""
        h64 = m.to(torch.int64)
        ar = self.ar_first
        iv = (h64 - self.k64[a:b]).clamp_(0, self.lp - _EXT_FIRST).unsqueeze(-1) + ar
        ih = h64.clamp(0, self.lt - _EXT_FIRST).unsqueeze(-1) + ar
        pc = self.pat.gather(1, iv.view(self.P, -1))
        tc = self.txt.gather(1, ih.view(self.P, -1))
        run = (pc == tc).view(self.P, b - a, _EXT_FIRST).cumprod(-1, dtype=torch.int32).sum(
            -1, dtype=torch.int32)
        m.add_(run)
        return (run == _EXT_FIRST) & (m >= 0)

    def _extend_more(self, h: torch.Tensor, more: torch.Tensor, a: int) -> None:
        """Finish the runs longer than the first window, in place, on the
        few lanes that have them."""
        p_i, w_i = more.nonzero(as_tuple=True)
        ar = torch.arange(_EXT_MORE, device=self.dev, dtype=torch.int64)
        pflat, tflat = self.pat.view(-1), self.txt.view(-1)
        while p_i.numel():
            hh = h[p_i, w_i].to(torch.int64)
            vv = hh - self.k64[a + w_i]
            iv = (p_i * self.lp + vv.clamp(0, self.lp - _EXT_MORE))[:, None] + ar
            ih = (p_i * self.lt + hh.clamp(0, self.lt - _EXT_MORE))[:, None] + ar
            run = (pflat[iv] == tflat[ih]).cumprod(-1, dtype=torch.int32).sum(-1, dtype=torch.int32)
            h[p_i, w_i] = (hh + run).to(torch.int32)
            go = run == _EXT_MORE
            p_i, w_i = p_i[go], w_i[go]

    def level(self, s: int) -> None:
        """Compute level s into its ring slot, extend its M and keep its
        window in the history."""
        pen = self.pen
        a, b = self.window(s)
        new = self.ring[s % self.depth]
        body = new[:, :, a:b]
        if s == 0:
            body.fill_(NULL)
            new[_C_M, :, self.c] = 0
        else:
            def src(lvl, comp, shift):
                if lvl < 0:
                    return None
                return self.ring[lvl % self.depth, comp, :, a + shift : b + shift]

            def gap(comp, o, e, shift):
                opn = src(s - o - e, _C_M, shift)
                ext = src(s - e, comp, shift)
                out = new[comp, :, a:b]
                if opn is None and ext is None:
                    out.fill_(NULL)
                    return
                if opn is None or ext is None:
                    out.copy_(opn if ext is None else ext)
                else:
                    torch.maximum(opn, ext, out=out)
                if shift < 0:  # an I step advances h
                    out.add_(1)

            gap(_C_I1, pen.o1, pen.e1, -1)
            gap(_C_D1, pen.o1, pen.e1, +1)
            if pen.two_piece:
                gap(_C_I2, pen.o2, pen.e2, -1)
                gap(_C_D2, pen.o2, pen.e2, +1)
            mis = src(s - pen.x, _C_M, 0)
            if mis is None:
                new[_C_M, :, a:b].fill_(NULL)
            else:
                torch.add(mis, 1, out=new[_C_M, :, a:b])
            body.masked_fill_(body > self.hmax[:, a:b], NULL)
            new[_C_M, :, a:b] = body.amax(0)
        m = new[_C_M, :, a:b]
        self._extend_more(m, self._extend(m, a, b), a)
        self.history.append((a - self.c, self._keep(body)))

    def _keep(self, body: torch.Tensor) -> torch.Tensor:
        n = body.numel()
        if not self._store or self._used + n > self._store[-1].numel():
            self._store.append(torch.empty(max(_STORE_BLOCK, n), dtype=torch.int32, device=self.dev))
            self._used = 0
        out = self._store[-1][self._used : self._used + n].view(body.shape)
        out.copy_(body)
        self._used += n
        return out

    def reached_end(self, out: torch.Tensor) -> None:
        """Per pair, whether the newest level's M reached the end cell."""
        s = len(self.history) - 1
        torch.eq(self.ring[s % self.depth, _C_M, self.rows, self.end_col], self.tlen_t, out=out)


class _History:
    """One pair's levels, copied to the host a block of diagonals at a
    time as the traceback asks for them."""

    _NAMES = {"m": _C_M, "i1": _C_I1, "d1": _C_D1, "i2": _C_I2, "d2": _C_D2}
    BLOCK = 256

    def __init__(self, batch: _Batch, p: int):
        self.batch = batch
        self.p = p
        self.cache = {}

    def get(self, s: int, comp: str, k: int) -> int:
        if s < 0 or s >= len(self.batch.history):
            return NULL
        c = self._NAMES[comp]
        if c >= self.batch.ncomp:
            return NULL
        klo, plane = self.batch.history[s]
        i = k - klo
        if not 0 <= i < plane.shape[-1]:
            return NULL
        key = (s, i // self.BLOCK)
        blk = self.cache.get(key)
        if blk is None:
            lo = key[1] * self.BLOCK
            blk = plane[:, self.p, lo : lo + self.BLOCK].cpu().numpy()
            self.cache[key] = blk
        v = int(blk[c, i % self.BLOCK])
        return v if v >= 0 else NULL


#: the predecessors of an M cell, first wins (docs/TIEBREAK.md)
TIEBREAK_M = ("X", "I1", "I2", "D1", "D2")
#: the order with the first insertion ahead of the mismatch: the port's
#: own test-only mutation of the tie-break, for the check's control
FLIPPED_M = ("I1", "X", "I2", "D1", "D2")


def _traceback(hist: _History, s: int, k_end: int, tlen: int,
               pen: Penalties, order=TIEBREAK_M) -> List[Tuple[int, int]]:
    """(op, length) runs from the start, by the tie-break contract."""
    get = hist.get
    rev: List[Tuple[int, int]] = []

    def emit(op, n):
        if n <= 0:
            return
        if rev and rev[-1][0] == op:
            rev[-1] = (op, rev[-1][1] + n)
        else:
            rev.append((op, n))

    k = k_end
    comp = "m"
    h = get(s, "m", k)
    if h != tlen:
        raise AssertionError("traceback: the end cell is not on the last level")
    while True:
        if comp == "m":
            if s == 0:
                if k != 0:
                    raise AssertionError("traceback: level 0 off the main diagonal")
                emit(OP_M, h)
                break
            mis = get(s - pen.x, "m", k)
            cand = {
                "X": mis + 1 if mis != NULL else NULL,
                "I1": get(s, "i1", k),
                "D1": get(s, "d1", k),
                "I2": get(s, "i2", k) if pen.two_piece else NULL,
                "D2": get(s, "d2", k) if pen.two_piece else NULL,
            }
            pre = max(cand.values())
            if pre == NULL:
                raise AssertionError("traceback: no predecessor at M")
            emit(OP_M, h - pre)
            h = pre
            choice = next(c for c in order if cand[c] == pre)
            if choice == "X":
                emit(OP_X, 1)
                s -= pen.x
                h -= 1
            else:
                comp = choice.lower()
        else:
            piece1 = comp[1] == "1"
            o, e = (pen.o1, pen.e1) if piece1 else (pen.o2, pen.e2)
            is_i = comp[0] == "i"
            kk = k - 1 if is_i else k + 1
            ext = get(s - e, comp, kk)
            opn = get(s - o - e, "m", kk)
            want = h - 1 if is_i else h
            chosen = None
            for g in ("ext", "open"):
                if g == "ext" and ext != NULL and ext == want:
                    chosen = g
                    break
                if g == "open" and opn != NULL and opn == want:
                    chosen = g
                    break
            if chosen is None:
                raise AssertionError("traceback: no gap predecessor")
            emit(OP_I if is_i else OP_D, 1)
            k = kk
            if is_i:
                h -= 1
            if chosen == "ext":
                s -= e
            else:
                s -= o + e
                comp = "m"
    return rev[::-1]


def align_batch(pairs, pen: Penalties, device="cpu", band: Optional[int] = None,
                max_level: Optional[int] = None, order=TIEBREAK_M, orders=None):
    """[(score, [(op, length), ...])] for each (query, target) bytes pair,
    computed together; `order` ranks an M cell's predecessors. With
    `orders`, one forward serves several tracebacks: [(score, [runs of
    each order])]."""
    batch = _Batch(pairs, pen, torch.device(device), band)
    P = batch.P
    if max_level is None:
        max_level = int(max(
            pen.x * min(p, t) + pen.gap_cost(abs(p - t) + 1) + pen.max_lookback + 1
            for p, t in zip(batch.plen, batch.tlen)))
    # which pairs reached their end cell, a row a level, read on the host
    # a block of levels at a time (a level's own wait is the extension's)
    block = 16
    hits = torch.zeros((block, P), dtype=torch.bool, device=batch.dev)
    final = [-1] * P
    s = 0
    while True:
        batch.level(s)
        batch.reached_end(hits[s % block])
        if s % block == block - 1 or s == max_level:
            rows = hits[: s % block + 1].cpu().numpy()
            for p in range(P):
                lv = np.flatnonzero(rows[:, p])
                if final[p] < 0 and lv.size:
                    final[p] = s - s % block + int(lv[0])
            if min(final) >= 0:
                break
            if s == max_level:
                raise RuntimeError(f"alignment exceeded level {max_level}")
        s += 1
    out = []
    for p in range(P):
        hist = _History(batch, p)
        walks = [_traceback(hist, final[p], int(batch.tlen[p] - batch.plen[p]),
                            int(batch.tlen[p]), pen, o) for o in (orders or (order,))]
        out.append((final[p], walks if orders else walks[0]))
    return out
