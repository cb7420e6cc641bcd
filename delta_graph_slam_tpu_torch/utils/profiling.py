"""Per-stage wall-clock timers."""

import collections
import contextlib
import time


class StageTimer:
    """Accumulates wall-clock seconds per named stage.

    ``sync`` (for instance torch.cuda.synchronize) runs before a stage's
    clock stops, so work a stage queued on the card counts in that stage and
    not in the next one that waits for it.
    """

    def __init__(self, sync=None):
        self.sync = sync
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def mean_ms(self, name):
        c = self.counts[name]
        return 1000.0 * self.totals[name] / c if c else 0.0

    def summary(self):
        return {
            name: {
                "count": self.counts[name],
                "total_s": self.totals[name],
                "mean_ms": self.mean_ms(name),
            }
            for name in sorted(self.totals)
        }
