"""Geodetic <-> local-Cartesian (ENU) and UTM projection on the WGS84
ellipsoid — a copy of ``elimaloc_tpu/ops/geo.py`` (the port never imports the
JAX package; its module imports jax).

Replacement for the GeographicLib ``LocalCartesian`` forward/reverse used by
the reference EKF node (reference: src/app/localization/ekf_localization/
src/ekf_localization.cpp:412-418, 643-648), from the standard geodetic <->
ECEF equations; the reverse uses Bowring's iteration, accurate to
sub-millimeter at vehicle scales. This is host code: every function takes
an ``xp`` array-module argument that defaults to NumPy, and computes in
float64 (ECEF magnitudes are ~6.4e6 m, so the ENU subtraction cancels to
sub-meter garbage in float32).
"""

from __future__ import annotations

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)


def _geodetic_to_ecef(lat_deg, lon_deg, h, xp=np):
    lat = xp.deg2rad(lat_deg)
    lon = xp.deg2rad(lon_deg)
    sl, cl = xp.sin(lat), xp.cos(lat)
    n = _A / xp.sqrt(1.0 - _E2 * sl * sl)
    x = (n + h) * cl * xp.cos(lon)
    y = (n + h) * cl * xp.sin(lon)
    z = (n * (1.0 - _E2) + h) * sl
    return xp.stack([x, y, z], axis=-1)


def _ecef_to_geodetic(xyz, xp=np):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = xp.arctan2(y, x)
    p = xp.sqrt(x * x + y * y)
    # Bowring-style fixed-point iteration on latitude (5 iters ~ f64 precision).
    lat = xp.arctan2(z, p * (1.0 - _E2))
    for _ in range(5):
        sl = xp.sin(lat)
        n = _A / xp.sqrt(1.0 - _E2 * sl * sl)
        h = p / xp.cos(lat) - n
        lat = xp.arctan2(z, p * (1.0 - _E2 * n / (n + h)))
    sl = xp.sin(lat)
    n = _A / xp.sqrt(1.0 - _E2 * sl * sl)
    h = p / xp.cos(lat) - n
    return xp.rad2deg(lat), xp.rad2deg(lon), h


def _enu_basis(lat_deg, lon_deg, xp=np):
    lat = xp.deg2rad(lat_deg)
    lon = xp.deg2rad(lon_deg)
    sl, cl = xp.sin(lat), xp.cos(lat)
    so, co = xp.sin(lon), xp.cos(lon)
    east = xp.stack([-so, co, xp.zeros_like(so)], axis=-1)
    north = xp.stack([-sl * co, -sl * so, cl], axis=-1)
    up = xp.stack([cl * co, cl * so, sl], axis=-1)
    return xp.stack([east, north, up], axis=-2)  # rows are E,N,U


def project_gps_point(lat, lon, height, ref_lat, ref_lon, ref_height, xp=np):
    """(lat, lon, h) -> local ENU xyz relative to the reference origin.

    Equivalent of GeographicLib LocalCartesian::Forward as used by
    ProjectGpsPoint (ekf_localization.cpp:643-648).
    """
    ecef = _geodetic_to_ecef(
        xp.asarray(lat), xp.asarray(lon), xp.asarray(height), xp
    )
    ecef0 = _geodetic_to_ecef(
        xp.asarray(ref_lat), xp.asarray(ref_lon), xp.asarray(ref_height), xp
    )
    basis = _enu_basis(ref_lat, ref_lon, xp)
    return xp.einsum("...ij,...j->...i", basis, ecef - ecef0)


def unproject_local_point(xyz, ref_lat, ref_lon, ref_height, xp=np):
    """Local ENU xyz -> (lat, lon, h); LocalCartesian::Reverse equivalent
    (ekf_localization.cpp:412-418)."""
    ecef0 = _geodetic_to_ecef(
        xp.asarray(ref_lat), xp.asarray(ref_lon), xp.asarray(ref_height), xp
    )
    basis = _enu_basis(ref_lat, ref_lon, xp)
    ecef = ecef0 + xp.einsum("...ji,...j->...i", basis, xp.asarray(xyz))
    return _ecef_to_geodetic(ecef, xp)


# ---- UTM (transverse Mercator, Karney series) -------------------------------
#
# The reference parses ``projection_mode = Cartesian | UTM``
# (ekf_localization.cpp:253, localization.ini:14) and includes
# GeographicLib/UTMUPS.hpp, but never actually dispatches on it — UTM is dead
# config upstream. We implement it for real: 3rd-order Krueger/Karney series
# (mm-level inside a zone), standard UTM scale/offsets.

_K0 = 0.9996
_E = _E2 ** 0.5
_N3 = _F / (2.0 - _F)  # third flattening n
_A_TM = _A / (1.0 + _N3) * (1.0 + _N3**2 / 4.0 + _N3**4 / 64.0)
_ALPHA = (
    _N3 / 2.0 - 2.0 * _N3**2 / 3.0 + 5.0 * _N3**3 / 16.0,
    13.0 * _N3**2 / 48.0 - 3.0 * _N3**3 / 5.0,
    61.0 * _N3**3 / 240.0,
)
_BETA = (
    _N3 / 2.0 - 2.0 * _N3**2 / 3.0 + 37.0 * _N3**3 / 96.0,
    _N3**2 / 48.0 + _N3**3 / 15.0,
    17.0 * _N3**3 / 480.0,
)


def utm_zone(lon_deg) -> int:
    """Standard 6-degree UTM zone (no Norway/Svalbard exceptions — the
    reference never exercises UTM at all, see module comment)."""
    import math

    return int(math.floor((float(lon_deg) + 180.0) / 6.0)) % 60 + 1


def utm_forward(lat_deg, lon_deg, zone: int | None = None, xp=np):
    """(lat, lon) -> (easting, northing, zone). Southern-hemisphere points get
    the 10,000 km false northing, as in GeographicLib UTMUPS::Forward.
    Meter-scale UTM offsets need float64."""
    lat_deg = xp.asarray(lat_deg, xp.float64)
    lon_deg = xp.asarray(lon_deg, xp.float64)
    if zone is None:
        zone = utm_zone(xp.reshape(lon_deg, (-1,))[0])
    lon0 = -183.0 + 6.0 * zone
    lat = xp.deg2rad(lat_deg)
    lam = xp.deg2rad(lon_deg - lon0)
    sphi = xp.sin(lat)
    # conformal latitude
    t = xp.sinh(xp.arctanh(sphi) - _E * xp.arctanh(_E * sphi))
    xi0 = xp.arctan2(t, xp.cos(lam))
    eta0 = xp.arcsinh(xp.sin(lam) / xp.sqrt(t * t + xp.cos(lam) ** 2))
    xi, eta = xi0, eta0
    for j, a in enumerate(_ALPHA, start=1):
        xi = xi + a * xp.sin(2 * j * xi0) * xp.cosh(2 * j * eta0)
        eta = eta + a * xp.cos(2 * j * xi0) * xp.sinh(2 * j * eta0)
    easting = 500000.0 + _K0 * _A_TM * eta
    northing = _K0 * _A_TM * xi + xp.where(lat_deg < 0.0, 1e7, 0.0)
    return easting, northing, zone


def utm_reverse(easting, northing, zone: int, southern: bool = False,
                xp=np):
    """(easting, northing, zone) -> (lat, lon); UTMUPS::Reverse equivalent."""
    easting = xp.asarray(easting, xp.float64)
    northing = xp.asarray(northing, xp.float64)
    xi0 = (northing - (1e7 if southern else 0.0)) / (_K0 * _A_TM)
    eta0 = (easting - 500000.0) / (_K0 * _A_TM)
    xi, eta = xi0, eta0
    for j, b in enumerate(_BETA, start=1):
        xi = xi - b * xp.sin(2 * j * xi0) * xp.cosh(2 * j * eta0)
        eta = eta - b * xp.cos(2 * j * xi0) * xp.sinh(2 * j * eta0)
    lam = xp.arctan2(xp.sinh(eta), xp.cos(xi))
    chi = xp.arcsin(xp.sin(xi) / xp.cosh(eta))  # conformal latitude
    e2, e4, e6, e8 = _E2, _E2**2, _E2**3, _E2**4
    lat = (
        chi
        + (e2 / 2 + 5 * e4 / 24 + e6 / 12 + 13 * e8 / 360) * xp.sin(2 * chi)
        + (7 * e4 / 48 + 29 * e6 / 240 + 811 * e8 / 11520) * xp.sin(4 * chi)
        + (7 * e6 / 120 + 81 * e8 / 1120) * xp.sin(6 * chi)
        + (4279 * e8 / 161280) * xp.sin(8 * chi)
    )
    lon0 = -183.0 + 6.0 * zone
    return xp.rad2deg(lat), lon0 + xp.rad2deg(lam)


def project_gps_point_utm(lat, lon, height, ref_lat, ref_lon, ref_height,
                          xp=np):
    """UTM-plane local projection: the point's UTM coordinates minus the
    reference origin's, in the origin's zone (projection_mode = UTM,
    localization.ini:14 — dead config in the reference, live here)."""
    zone = utm_zone(ref_lon)
    e0, n0, _ = utm_forward(ref_lat, ref_lon, zone=zone, xp=xp)
    e1, n1, _ = utm_forward(lat, lon, zone=zone, xp=xp)
    return xp.stack(
        xp.broadcast_arrays(
            e1 - e0, n1 - n0, xp.asarray(height, xp.float64) - ref_height
        ),
        axis=-1,
    )


def unproject_local_point_utm(xyz, ref_lat, ref_lon, ref_height, xp=np):
    """Inverse of :func:`project_gps_point_utm`."""
    xyz = xp.asarray(xyz, xp.float64)
    zone = utm_zone(ref_lon)
    e0, n0, _ = utm_forward(ref_lat, ref_lon, zone=zone, xp=xp)
    southern = float(ref_lat) < 0.0
    lat, lon = utm_reverse(xyz[..., 0] + e0, xyz[..., 1] + n0, zone, southern,
                           xp=xp)
    return lat, lon, xyz[..., 2] + ref_height
