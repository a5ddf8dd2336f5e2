"""27-state error-state EKF (port of elimaloc_tpu.ekf, main-path half)."""

from .filter import (  # noqa: F401
    EkfFlags,
    ego_state,
    init_state,
    predict_imu,
    update_gnss,
)
from .state import EkfParams, EkfState, GnssMeas, ImuMeas, make_params  # noqa: F401
