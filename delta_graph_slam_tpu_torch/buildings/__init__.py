"""OpenStreetMap building footprints: the host-side manager.

The download, parse and range query of BuildingTools (building_tools.cpp).
The Building entity and its graph vertex come with the line-feature
matcher in slice 3 of the port; until then a world with buildings in
range raises instead of being skipped.
"""

from .manager import (
    BuildingManager,
    OverpassProvider,
    FileProvider,
    StaticProvider,
    parse_osm_xml,
)

__all__ = [
    "BuildingManager", "OverpassProvider", "FileProvider", "StaticProvider",
    "parse_osm_xml",
]
