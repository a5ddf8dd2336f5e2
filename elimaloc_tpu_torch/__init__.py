"""elimaloc_tpu_torch — the PyTorch + CUDA port of elimaloc_tpu.

A second package beside ``elimaloc_tpu`` (the JAX reference, which it never
imports). It ports the fused P2P localization slice: the IMU EKF chain and
ring pushes, deskew, pose sync, voxel downsample, tile-slot assignment, the
GN/LM P2P registration loop, covariance shaping, latency compensation and
the EKF PCM update. The four hot ops the JAX package laid out by hand for
the TPU run as hand-written CUDA kernels on Hopper (csrc/); on CPU tensors
their plain PyTorch versions run instead.
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
