"""Map building and the tile correspondence engine (port of elimaloc_tpu.map)."""

from .builder import BuiltMap, build_voxel_map  # noqa: F401
from .grid import voxel_downsample  # noqa: F401
from .tiles import (  # noqa: F401
    HostTileMap,
    TileMap,
    TileQueryBudget,
    assign_slots,
    build_tile_map,
    load_tile_map,
    nearest_point_slots,
    shift_window,
)
