"""Bag abstraction + flow-controlled player.

A copy of the JAX package's io/bag.py (host numpy); the npz layout is the
same, so a bag written by either package loads in the other. A Bag is a
time-ordered list of typed messages (points / imu / gps / nmea / gt_pose)
loadable from .npz; BagPlayer reproduces bag_player.py's watermark pacing
(bag_player.py:54-66, 147-163): play realtime for the first ``realtime_s``
seconds, then as fast as consumers allow. A message on a flow-controlled
topic is released only once every consumer's advertised ``read_until``
watermark passes its stamp (pipeline/flow.py:Watermark).

``from_npz`` gathers the topics as a set, so messages of different topics
with equal stamps come out in an order that follows the interpreter's
string hashing (``PYTHONHASHSEED``), as in the reference.
"""

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..pipeline.flow import Watermark


@dataclasses.dataclass
class Message:
    stamp: float
    topic: str
    data: Any


class Bag:
    def __init__(self, messages: List[Message]):
        self.messages = sorted(messages, key=lambda m: m.stamp)

    def __len__(self):
        return len(self.messages)

    def __iter__(self):
        return iter(self.messages)

    def topics(self):
        return sorted({m.topic for m in self.messages})

    @classmethod
    def from_npz(cls, path) -> "Bag":
        """Layout: {topic}__stamps (N,) and {topic}__data (N,) object arrays."""
        z = np.load(path, allow_pickle=True)
        msgs = []
        topics = {k[: -len("__stamps")] for k in z.files if k.endswith("__stamps")}
        for t in topics:
            stamps = z[f"{t}__stamps"]
            data = z[f"{t}__data"]
            for s, d in zip(stamps, data):
                msgs.append(Message(float(s), t, d))
        return cls(msgs)

    def save_npz(self, path):
        arrays = {}
        for t in self.topics():
            ms = [m for m in self.messages if m.topic == t]
            arrays[f"{t}__stamps"] = np.asarray([m.stamp for m in ms])
            arrays[f"{t}__data"] = np.asarray([m.data for m in ms], object)
        np.savez_compressed(path, **arrays)


class BagPlayer:
    """Replay with read_until backpressure.

    handlers: {topic: callable(Message)}. flow_topics: topics subject to
    watermark gating (the reference gates the raw points topic).
    """

    def __init__(
        self,
        bag: Bag,
        handlers: Dict[str, Callable[[Message], None]],
        watermark: Optional[Watermark] = None,
        flow_topics=("points",),
        realtime_s: float = 0.0,
        rate: float = 0.0,
        wait_timeout: float = 30.0,
    ):
        self.bag = bag
        self.handlers = handlers
        self.watermark = watermark
        self.flow_topics = set(flow_topics)
        self.realtime_s = realtime_s
        self.rate = rate
        self.wait_timeout = wait_timeout

    def play(self, progress: Optional[Callable[[int, int], None]] = None):
        if not len(self.bag):
            return
        t0 = self.bag.messages[0].stamp
        wall0 = time.monotonic()
        n = len(self.bag)
        for k, msg in enumerate(self.bag):
            if self.rate > 0:
                target = (msg.stamp - t0) / self.rate
            elif self.realtime_s > 0 and msg.stamp - t0 < self.realtime_s:
                target = msg.stamp - t0
            else:
                target = None
            if target is not None:
                sleep = target - (time.monotonic() - wall0)
                if sleep > 0:
                    time.sleep(sleep)
            if self.watermark is not None and msg.topic in self.flow_topics:
                self.watermark.wait_until(msg.stamp, timeout=self.wait_timeout)
            h = self.handlers.get(msg.topic)
            if h is not None:
                h(msg)
            if progress is not None:
                progress(k + 1, n)
