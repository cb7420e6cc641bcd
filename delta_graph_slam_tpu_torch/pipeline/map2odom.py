"""map->odom transform re-broadcaster.

Counterpart of the JAX package's pipeline/map2odom.py, the equivalent of
map2odom_publisher.py: re-publishes the backend's latest odom2map estimate
into a TransformTable at a fixed rate (identity until the first update).
Here the "broadcast" is a thread stamping the shared transform table that
downstream consumers read. The SE2 estimate is lifted on the host
(geom/host.py:transform_2d_to_3d_np); nothing here touches the device.
"""

import threading

import numpy as np

from ..geom.host import transform_2d_to_3d_np
from ..io.tf_table import TransformTable


class Map2OdomPublisher:
    def __init__(self, table: TransformTable, backend=None, rate_hz=10.0,
                 map_frame="map", odom_frame="odom"):
        self.table = table
        self.backend = backend
        self.rate_hz = rate_hz
        self.map_frame = map_frame
        self.odom_frame = odom_frame
        self._stop = threading.Event()
        self._thread = None
        # identity until the first odom2map message (map2odom_publisher.py:21-24)
        self.table.set_static(map_frame, odom_frame, np.eye(4))

    def publish_once(self, stamp=None):
        if self.backend is None:
            return
        o2m = np.asarray(self.backend.trans_odom2map, float)
        self.table.set_static(self.map_frame, self.odom_frame,
                              transform_2d_to_3d_np(o2m))

    def start(self):
        def loop():
            period = 1.0 / self.rate_hz
            while not self._stop.is_set():
                self.publish_once()
                self._stop.wait(period)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
