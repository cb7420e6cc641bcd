"""OpenStreetMap building-footprint constraint system.

Rebuild of BuildingTools/Building (building_tools.cpp, building.cpp): a
host-side Overpass client (with offline XML providers for deterministic
replay) feeding outline lines and clouds on the backend's device, plus the
Building entity whose lines/cloud re-pose by the current graph estimate
rotated about the building center.
"""

from .building import Building, building_map_transform
from .manager import (
    BuildingManager,
    OverpassProvider,
    FileProvider,
    StaticProvider,
    parse_osm_xml,
)

__all__ = [
    "Building", "building_map_transform",
    "BuildingManager", "OverpassProvider", "FileProvider", "StaticProvider",
    "parse_osm_xml",
]
