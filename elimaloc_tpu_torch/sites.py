"""Per-site deployment presets — the launch-file equivalent (a copy of
``elimaloc_tpu.sites`` on the port's config).

The reference selects a geodetic origin and map path per location through
roslaunch arguments (reference: src/app/localization/ekf_localization/launch/
ekf_localization.launch:6-38 and src/app/localization/pcm_matching/launch/
pcm_matching.launch:6-24). Here each site is a preset applied onto an
:class:`~elimaloc_tpu_torch.config.ElimalocConfig`; the CLI exposes it as
``--site`` (``elimaloc_tpu_torch.cli replay --site kcity ...``).

Reference map filenames encode the origin (``lat_lon_hgt_name.pcd``) and
``map/pcd.py:parse_origin_from_filename`` recovers it — a preset's
``map_path`` is a default, not a requirement.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .config import ElimalocConfig


@dataclasses.dataclass(frozen=True)
class SitePreset:
    name: str
    ref_latitude: float
    ref_longitude: float
    ref_height: float
    map_path: Optional[str] = None


# Values from ekf_localization.launch:6-19 / pcm_matching.launch:6-16.
SITES: Dict[str, SitePreset] = {
    s.name: s
    for s in (
        SitePreset(
            "kcity", 37.23855064, 126.77253029, 0.0,
            "resources/map/pcm/"
            "37.238551_126.772530_0.000000_kcity_1203_filtered_02.pcd",
        ),
        SitePreset(
            "katri", 37.23855064, 126.77253029, 0.0,
            "resources/map/pcm/"
            "37.238551_126.772530_0.000000_kcity_1203_filtered_02.pcd",
        ),
        SitePreset(
            "pangyo", 37.394776, 127.111158, 40.0,
            "resources/map/pcm/37.394776_127.111158_40.000000_pangyo.pcd",
        ),
        SitePreset(
            "hanyang", 37.5582, 127.0445, 66.0,
            "resources/map/pcm/37.558200_127.044500_66.000000_hanyang_02m.pcd",
        ),
        SitePreset("stairs", 37.23855064, 126.77253029, 0.0,
                   "resources/map/pcm/stairs_bob.pcd"),
    )
}


def apply_site(cfg: ElimalocConfig, site: str) -> SitePreset:
    """Apply a site preset's geodetic origin to ``cfg`` (in place) and
    return the preset (for its default map path)."""
    try:
        preset = SITES[site]
    except KeyError:
        raise ValueError(
            f"unknown site {site!r}; available: {sorted(SITES)}"
        ) from None
    cfg.ekf.ref_latitude = preset.ref_latitude
    cfg.ekf.ref_longitude = preset.ref_longitude
    cfg.ekf.ref_height = preset.ref_height
    return preset
