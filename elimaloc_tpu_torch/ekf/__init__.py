"""27-state error-state EKF (port of elimaloc_tpu.ekf)."""

from .filter import (  # noqa: F401
    EkfFlags,
    ego_state,
    imu_calibration,
    init_state,
    predict,
    predict_imu,
    update_can,
    update_chain,
    update_gnss,
    update_gps,
)
from .state import (  # noqa: F401
    CanMeas,
    EkfParams,
    EkfState,
    GnssMeas,
    ImuMeas,
    STATE_ORDER,
    make_params,
)
