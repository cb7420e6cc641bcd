"""Building manager: async OSM fetch, parse and range query (host code).

Rebuild of BuildingTools (building_tools.cpp): a background thread
downloads Overpass XML (way['building'](around:r,lat,lon), :51-57) into a
buffer recentered when the query leaves half the buffer radius (:44-46);
parseBuildings converts ways into Building entities, adding an SE2 vertex
with weak xy/yaw priors at level 1 and information I*0.001 (:137-148) for
each new way; the outline becomes a 2 cm-interpolated cloud + line list
(:166-196) on the manager's device; the building pose is the bbox center
with zero yaw (:259-284).

Providers: Overpass HTTP (online), a local XML file, or a static string;
the latter two make offline replays deterministic.
"""

import threading
import time
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..geom.interpolate import interpolate_segment
from ..geom.projection import mercator_from_gps
from ..lines.features import make_lines
from ..ops.cloud import MaskedCloud
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .building import Building


def parse_osm_xml(xml_text: str):
    """Parse OSM XML -> (nodes {id: (lat, lon)}, ways [(id, [nd_refs])])."""
    root = ET.fromstring(xml_text)
    nodes = {}
    ways = []
    for child in root:
        if child.tag == "node":
            nodes[child.attrib["id"]] = (
                float(child.attrib["lat"]), float(child.attrib["lon"])
            )
        elif child.tag == "way":
            refs = [nd.attrib["ref"] for nd in child if nd.tag == "nd"]
            ways.append((child.attrib["id"], refs))
    return nodes, ways


class OverpassProvider:
    """HTTP Overpass fetch (curlpp equivalent; 6 s timeout)."""

    def __init__(self, host="https://overpass-api.de", timeout=6.0):
        self.host = host
        self.timeout = timeout

    def __call__(self, lat, lon, radius) -> Optional[str]:
        import urllib.request
        import urllib.error

        url = (
            f"{self.host}/api/interpreter?data=way[%27building%27]"
            f"(around:{radius:.6f},{lat:.6f},{lon:.6f});%20(._;%3E;);out;"
        )
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                return r.read().decode("utf-8")
        except Exception as e:  # timeout / network -> skip update (:70-78)
            print(f"overpass fetch failed: {e}")
            return None


class FileProvider:
    """Offline OSM XML file (deterministic replays)."""

    def __init__(self, path):
        with open(path) as f:
            self.text = f.read()

    def __call__(self, lat, lon, radius):
        return self.text


class StaticProvider:
    def __init__(self, text):
        self.text = text

    def __call__(self, lat, lon, radius):
        return self.text


class BuildingManager:
    """getBuildings(gps) -> buildings within ``radius`` of the fix.

    graph_add_vertex / graph_add_prior_xy / graph_add_prior_yaw are
    callbacks into the backend's graph builder so the manager stays
    solver-agnostic.
    """

    def __init__(
        self,
        provider: Callable,
        origin,
        scale,
        graph_add_vertex=None,
        graph_add_prior_xy=None,
        graph_add_prior_yaw=None,
        radius: float = 35.0,
        buffer_radius: float = 120.0,
        interpolation_capacity: int = 4096,
        line_capacity: int = 16,
        synchronous: bool = False,
        device=DEFAULT_DEVICE,
    ):
        self.provider = provider
        self.origin = np.asarray(origin, float)
        self.scale = float(scale)
        self.radius = radius
        self.buffer_radius = buffer_radius
        self.interpolation_capacity = interpolation_capacity
        self.line_capacity = line_capacity
        self.graph_add_vertex = graph_add_vertex
        self.graph_add_prior_xy = graph_add_prior_xy
        self.graph_add_prior_yaw = graph_add_prior_yaw
        self.synchronous = synchronous
        self.device = resolve_device(device)

        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._nodes: Dict[str, tuple] = {}
        self._ways: List[tuple] = []
        self._way_pts: Dict[str, np.ndarray] = {}  # way_id -> ENU pts
        self._have_data = False
        self._buffer_center = np.zeros(2)
        self.buildings: List[Building] = []
        self.buildings_map: Dict[str, Building] = {}

    # ---- coordinate helpers -------------------------------------------
    def to_enu(self, lat, lon):
        xyz = np.asarray(
            mercator_from_gps(np.float64(lat), np.float64(lon), 0.0,
                              scale=self.scale)
        )
        return xyz[:2] - self.origin[:2]

    # ---- download ------------------------------------------------------
    def _download(self, lat, lon):
        p = self.to_enu(lat, lon)
        with self._lock:
            if self._have_data and np.linalg.norm(
                p - self._buffer_center
            ) < self.buffer_radius / 2.0:
                return
        text = self.provider(lat, lon, self.buffer_radius)
        if not text:
            return
        try:
            nodes, ways = parse_osm_xml(text)
        except ET.ParseError as e:
            print(f"osm xml parse error: {e}")
            return
        with self._lock:
            self._nodes = nodes
            self._ways = ways
            self._have_data = True
            self._buffer_center = p
            self._way_pts.clear()   # ENU cache keyed on download epoch

    def get_buildings(self, lat, lon, timeout=2.0) -> List[Building]:
        """BuildingTools::getBuildings (:14-30): (re)spawn the download
        thread if idle, poll briefly for first data, parse in range."""
        if self.synchronous:
            self._download(lat, lon)
        else:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._download, args=(lat, lon), daemon=True
                )
                self._thread.start()
            deadline = time.monotonic() + timeout
            while not self._have_data and time.monotonic() < deadline:
                time.sleep(0.1)
        return self._parse_buildings(lat, lon)

    def get_building_nodes(self) -> List[Building]:
        return [b for b in self.buildings if b.node_id is not None]

    # ---- parsing -------------------------------------------------------
    def _parse_buildings(self, lat, lon) -> List[Building]:
        with self._lock:
            if not self._have_data:
                return []
            nodes = self._nodes
            ways = list(self._ways)
        q = self.to_enu(lat, lon)
        in_range = []
        for way_id, refs in ways:
            pts = self._way_pts.get(way_id)
            if pts is None:
                # vectorized once per way per download epoch (the
                # per-keyframe re-projection of every node of every way
                # was pure host waste on the backend's critical path)
                ll = np.asarray([nodes[r] for r in refs if r in nodes],
                                np.float64).reshape(-1, 2)
                pts = (
                    mercator_from_gps(ll[:, 0], ll[:, 1], 0.0,
                                      scale=self.scale)[:, :2]
                    - self.origin[:2]
                ) if len(ll) else np.zeros((0, 2))
                self._way_pts[way_id] = pts
            if len(pts) == 0:
                continue
            if np.min(np.linalg.norm(pts - q, axis=1)) >= self.radius:
                continue
            if way_id in self.buildings_map:
                in_range.append(self.buildings_map[way_id])
                continue
            in_range.append(self._new_building(way_id, pts))
        return in_range

    def _new_building(self, way_id, pts) -> Building:
        # pose = bbox center, zero yaw (:259-284)
        center = (pts.min(0) + pts.max(0)) / 2.0
        pose = np.array([center[0], center[1], 0.0])

        # outline lines + 2 cm interpolated cloud (:166-196)
        a = pts[:-1]
        b = pts[1:]
        lines = make_lines(a, b, capacity=self.line_capacity, device=self.device)
        if len(a):
            a3 = np.concatenate([a, np.zeros((len(a), 1))], 1)
            b3 = np.concatenate([b, np.zeros((len(b), 1))], 1)
            per_seg = max(16, self.interpolation_capacity // max(len(a), 1))
            seg_pts, seg_mask = interpolate_segment(
                torch.as_tensor(a3, dtype=torch.float32, device=self.device),
                torch.as_tensor(b3, dtype=torch.float32, device=self.device),
                capacity=per_seg,
            )
            cloud = MaskedCloud(seg_pts.reshape(-1, 3), seg_mask.reshape(-1))
        else:
            cloud = MaskedCloud(torch.zeros((1, 3), device=self.device),
                                torch.zeros(1, dtype=torch.bool, device=self.device))

        node_id = None
        prior_ids = ()
        if self.graph_add_vertex is not None:
            node_id = self.graph_add_vertex(pose)
            # weak priors, level 1, info I*0.001 (:137-148)
            e1 = self.graph_add_prior_xy(node_id, pose[:2], 0.001)
            e2 = self.graph_add_prior_yaw(node_id, pose[2], 0.001)
            prior_ids = (e1, e2)

        b = Building(
            id=way_id, pose=pose, corners=pts, lines=lines, cloud=cloud,
            node_id=node_id, prior_edge_ids=prior_ids,
        )
        self.buildings.append(b)
        self.buildings_map[way_id] = b
        return b
