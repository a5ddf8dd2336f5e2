"""elimaloc_tpu_torch — the PyTorch + CUDA port of elimaloc_tpu.

A second package beside ``elimaloc_tpu`` (the JAX reference, which it never
imports). It ports the localization runtime: the IMU EKF chain and ring
pushes, the CAN and GPS updates, deskew, pose sync, voxel downsample,
tile-slot assignment, the GN/LM registration loop (P2P, GICP, VGICP,
AVGICP), covariance shaping, latency compensation and the EKF PCM update,
driven three ways (the event loop ``run``, the online frame loop
``run_frames``, the whole-log ``run_fused``), on a full map or an active
window of a disk-backed one (``map_window_radius``), with relocalization
(``initialize_at``), config hot reload and the geodetic projection, and
fleet replay (``run_fused_fleet``: B logs in one frame loop, every method
on either backend, with or without radar covariances and CAN + GPS, with
or without the IMU chain; each kernel of the frame launched once for all
lanes).

The hot ops the JAX package laid out by hand for the TPU run as
hand-written CUDA kernels on Hopper (csrc/; see ``kernels``): the loop
kernels (one cooperative launch a registration, or a fleet frame's
registrations: A, E, F, G, the tile search + Gauss-Newton kernel of each
ICP method, or Q on the hash grid, with M's step, every GN iteration; A,
E, F, G, Q and M alone are the loops' references, and A, E, F and G, after
B, also serve the tile map's one-shot queries), B (slot
assignment), C (voxel downsample), D (deskew), H (the frame's IMU stage), I (the CAN and GPS
updates), J (the ring pushes), K (the ring queries at a scan's times), L
(the PCM measurement), M (the GN step), N (the window shift), O (the CA
tick), P (the radar covariances), Q (the hash grid's search and queries),
R (the ground probe), S (the scan's end: L's measurement, the PCM
update and the frame's published outputs in one launch), T (the scan's
front: the range gate, the scan times, K's ring queries and D's deskew in
one host call), U (the tick mode's CA tick: O's body and J's ego push in
one launch), V (the tick mode's IMU-only intake in one launch), W (the
CAN and GPS updates, I redesigned: I stays as its reference), X (the
radar covariances, P redesigned: P stays as its reference), Y (the hash
grid's four queries, Q's query entry redesigned) and Z (the ground probe,
R redesigned). On CPU tensors their plain PyTorch versions run instead.
``LocalizationPipeline`` runs on the card unless given ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# Counterpart of elimaloc_tpu/__init__.py:12-23. Pose composes carry ~100 m
# translations: in TF32 (10-bit mantissa) or bf16 a centimetre ICP step
# rounds back into the same pose and registration freezes. Every f32 matmul
# and convolution of the port runs in full f32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import config  # noqa: E402,F401
from .config import (  # noqa: E402,F401
    CalibConfig,
    ElimalocConfig,
    EkfConfig,
    GnssSource,
    GpsType,
    IcpMethod,
    PcmConfig,
    ShapeBudget,
)
