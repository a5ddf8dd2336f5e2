"""Map building, PCD I/O, the hash grid and the tile correspondence engine
(port of elimaloc_tpu.map)."""

from .builder import BuiltMap, build_voxel_map  # noqa: F401
from .builder import find_ground_height as find_ground_height_host  # noqa: F401
from .builder import voxel_downsample_host  # noqa: F401
from .pcd import (  # noqa: F401
    parse_origin_from_filename,
    read_pcd,
    read_pcd_points,
    write_pcd,
)
from .grid import (  # noqa: F401
    MapGrid,
    OFFSETS_7,
    OFFSETS_27,
    find_ground_height,
    lookup,
    point_to_voxel,
    query_all_voxel_cov,
    query_nearest_point,
    query_nearest_point_cov,
    query_nearest_voxel_cov,
    to_device,
    voxel_downsample,
)
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
