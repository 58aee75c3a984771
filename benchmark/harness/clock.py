"""Set-up's parts on the wall clock, printed as they end."""
from __future__ import annotations

import sys
import time


class SetupClock:
    def __init__(self, t_start: float, label: str = ""):
        self.t_start, self.last, self.parts, self.label = t_start, t_start, {}, label

    def part(self, name: str) -> float:
        now = time.time()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.last
        self.last = now
        print(f"setup {self.label}{name}: {now - self.t_start:.3f} s from process start "
              f"(+{self.parts[name]:.3f})", file=sys.stderr, flush=True)
        return now

    def total(self) -> float:
        return time.time() - self.t_start
