"""Per-stage wall-clock timers."""

import collections
import contextlib
import threading
import time


class StageTimer:
    """Accumulates wall-clock seconds per named stage; safe to share
    between threads.

    ``sync`` (for instance torch.cuda.synchronize) runs before a stage's
    clock stops, so work a stage queued on the card counts in that stage
    and not in the next one that waits for it. The threaded runner sets it
    to None: there a wait would take in every thread's queued work.
    """

    def __init__(self, sync=None):
        self.sync = sync
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.add(name, time.perf_counter() - t0)

    def add(self, name, seconds):
        """One more call of ``name`` that took ``seconds``."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def reset(self):
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def mean_ms(self, name):
        with self._lock:
            c = self.counts.get(name, 0)
            return 1000.0 * self.totals.get(name, 0.0) / c if c else 0.0

    def summary(self):
        with self._lock:
            return {
                name: {
                    "count": self.counts[name],
                    "total_s": self.totals[name],
                    "mean_ms": 1000.0 * self.totals[name] / self.counts[name],
                }
                for name in sorted(self.totals)
            }
