"""Throughput telemetry.

Replicates the reference's stderr progress contract exactly
(main.rs:16-28, 382-439, 456-473): rate-limited (>=1 s) lines of the form

    [12.3s] 450/1000 (45.0%) 36.5 alignments/sec ETA: 15.1s

a completion line without ETA, and a final "- Complete!" line. The line
format is asserted by the reference's own tests, so it is part of the
behavioral surface.
"""

from __future__ import annotations

import sys
import time


def format_duration(seconds: float) -> str:
    """Reference: main.rs:16-28."""
    if seconds < 60.0:
        return f"{seconds:.1f}s"
    if seconds < 3600.0:
        minutes = seconds // 60.0
        return f"{minutes:.0f}m{seconds % 60.0:.0f}s"
    hours = seconds // 3600.0
    minutes = (seconds % 3600.0) // 60.0
    return f"{hours:.0f}h{minutes:.0f}m"


class ProgressTracker:
    def __init__(self, total: int, enabled: bool = True, interactive: bool = False, out=None):
        self.total = total
        self.enabled = enabled
        self.interactive = interactive
        self.out = out if out is not None else sys.stderr
        self.start = time.monotonic()
        self.count = 0
        self._last_log = self.start

    BAR_WIDTH = 40

    def _draw_bar(self, now: float) -> None:
        """Interactive tty bar (the reference shows an indicatif bar when
        stderr is a tty and no -o is given, main.rs:329-341): one line
        redrawn in place with carriage returns, ~10 Hz."""
        elapsed = now - self.start
        frac = (self.count / self.total) if self.total else 1.0
        filled = int(frac * self.BAR_WIDTH)
        head = ">" if 0 < filled < self.BAR_WIDTH else ""
        bar = "=" * max(filled - (1 if head else 0), 0) + head
        bar = bar.ljust(self.BAR_WIDTH, "-")
        rate = self.count / elapsed if elapsed > 0 else 0.0
        remaining = self.total - self.count
        eta = format_duration(remaining / rate) if rate > 0 else "?"
        mins, secs = divmod(int(elapsed), 60)
        self.out.write(
            f"\r[{mins:02d}:{secs:02d}] [{bar}] {self.count}/{self.total} "
            f"({rate:.1f}/s, ETA {eta})\x1b[K"
        )
        self.out.flush()

    def update(self, n: int = 1) -> None:
        if not self.enabled:
            self.count += n
            return
        self.count += n
        now = time.monotonic()
        if self.interactive:
            if self.count == self.total or (now - self._last_log) >= 0.1:
                self._last_log = now
                self._draw_bar(now)
            return
        if self.count == self.total or (now - self._last_log) >= 1.0:
            self._last_log = now
            elapsed = now - self.start
            pct = (self.count / self.total * 100.0) if self.total else 100.0
            rate = self.count / elapsed if elapsed > 0 else 0.0
            if self.count == self.total:
                print(
                    f"[{elapsed:.1f}s] {self.count}/{self.total} ({pct:.1f}%) "
                    f"{rate:.1f} alignments/sec",
                    file=self.out,
                )
            else:
                remaining = self.total - self.count
                eta = format_duration(remaining / rate) if rate > 0 else "?"
                print(
                    f"[{elapsed:.1f}s] {self.count}/{self.total} ({pct:.1f}%) "
                    f"{rate:.1f} alignments/sec ETA: {eta}",
                    file=self.out,
                )

    def finish(self) -> None:
        if not self.enabled:
            return
        if self.interactive:
            self.out.write("\r\x1b[K")  # clear the bar line
        elapsed = time.monotonic() - self.start
        rate = self.total / elapsed if elapsed > 0 else 0.0
        print(
            f"[{elapsed:.1f}s] {self.total}/{self.total} (100.0%) "
            f"{rate:.1f} alignments/sec - Complete!",
            file=self.out,
        )
