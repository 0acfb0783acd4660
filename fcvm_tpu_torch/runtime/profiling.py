"""Phase timers (the reference's ``time.perf_counter()`` phase summary,
``source code/fcVM.py:1110-1140, 1620-1624``).

PyTorch returns before the device finishes, so a timer given ``sync``
(``torch.cuda.synchronize`` on a CUDA run) calls it before reading the clock
at the end of each phase: the phase then counts its device work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Optional


class PhaseTimers:
    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self._sync = sync
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def totals(self) -> dict:
        return dict(self._totals)
