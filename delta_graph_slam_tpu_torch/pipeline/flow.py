"""Bounded queues and watermark flow control.

The reference paces offline playback by `read_until` watermark topics
(hdl_graph_slam's bag_player.py:147-163, with publishers at
scan_matching_odometry_nodelet.cpp:133-139 and others): a producer pauses
a topic until every consumer's advertised watermark passes the message
stamp. Here the same contract is a host-side primitive for the threaded
stage pipeline (pipeline/runner.py). A copy of the JAX package's
pipeline/flow.py, which imports no JAX: the port keeps its own.
"""

import collections
import threading


class Watermark:
    """Consumer-advertised progress: 'processed up to stamp'."""

    def __init__(self):
        self._stamps = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    def advertise(self, consumer: str, stamp: float):
        with self._cv:
            prev = self._stamps.get(consumer, float("-inf"))
            if stamp > prev:
                self._stamps[consumer] = stamp
                self._cv.notify_all()

    def min_stamp(self) -> float:
        with self._lock:
            if not self._stamps:
                return float("inf")
            return min(self._stamps.values())

    def wait_until(self, stamp: float, timeout=None) -> bool:
        """Block until every registered consumer has passed ``stamp``."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._stamps
                or min(self._stamps.values()) >= stamp,
                timeout=timeout,
            )


class BoundedQueue:
    """Thread-safe bounded FIFO with blocking put (backpressure)."""

    def __init__(self, maxlen=64):
        self.maxlen = maxlen
        self._q = collections.deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def put(self, item, timeout=None) -> bool:
        with self._not_full:
            ok = self._not_full.wait_for(
                lambda: len(self._q) < self.maxlen or self._closed,
                timeout=timeout,
            )
            if not ok or self._closed:
                return False
            self._q.append(item)
            self._not_empty.notify()
            return True

    def get(self, timeout=None):
        with self._not_empty:
            ok = self._not_empty.wait_for(
                lambda: self._q or self._closed, timeout=timeout
            )
            if not ok or (not self._q and self._closed):
                return None
            item = self._q.popleft()
            self._not_full.notify()
            return item

    def drain(self):
        with self._lock:
            items = list(self._q)
            self._q.clear()
            self._not_full.notify_all()
            return items

    def close(self):
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def __len__(self):
        with self._lock:
            return len(self._q)
