"""The plain versions of kernels W and X where their inputs changed form:
elimaloc_tpu_torch against itself and against the JAX package.

* ``update_chain_plain`` with ``valid`` None (every sample valid, no
  select: the event loop's one-sample CAN and GPS steps pass no mask, so
  no mask tensor is made) equals the explicit all-true mask bit for bit,
  and matches JAX's ``can_step`` / ``gps_step`` per sample (NAVSATFIX
  3-DOF and ODOMETRY 6-DOF): float64 atol 1e-10, float32 1e-5, on P of
  order 1e-2 (tests/test_torch_joseph.py's pattern and bounds).
* ``runtime.can_step`` / ``gps_step`` on the CPU equal ``update_chain_plain``
  on the sub-batch of one with an all-true mask, bit for bit.
* ``icp.radar_points`` (the hash backend's radar rows in query order, now
  given to ``radar_slots`` as no index and no mask) equals the
  ``arange`` / ``ones`` slot form it replaced, bit for bit
  (tests/test_torch_radar.py holds ``radar_point_cov`` to JAX's).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.ekf import filter as jfilter
from elimaloc_tpu.ekf import state as jstate
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.ekf import filter as tfilter
from elimaloc_tpu_torch.pipeline import rings as trings
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.register import icp as ticp
from torch_parity import assert_tree_close, flatten, one_torch_thread, t, tiny_cfg  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10),
          "f32": (jnp.float32, torch.float32, 1e-5)}
CAN = (np.array([1.02, 1.04, 1.045, 1.06]), np.array([5.1, 5.0, 4.9, 0.03]),
       np.array([0.31, 0.3, 0.29, 0.002]))
GPS = (np.array([1.07]), np.array([[60.3, 1.8, 0.15]]), np.array([[0.3, 0.3, 0.3]]))


def _moving(jdt, rng):
    params = jstate.make_params(jconfig.EkfConfig(), dtype=jdt)
    a = rng.normal(size=(27, 27)) * 2e-2
    q = np.array([1.0, 0.02, -0.03, 0.4])
    st = jfilter.init_state(params, dtype=jdt).replace(
        P=jnp.asarray(a @ a.T + np.eye(27) * 1e-3, jdt),
        rot=jnp.asarray(q / np.linalg.norm(q), jdt), pos=jnp.asarray([60.0, 1.5, 0.2], jdt),
        vel=jnp.asarray([0.8, 5.0, 0.1], jdt), gyro=jnp.asarray([0.01, -0.02, 0.3], jdt),
        prev_can_timestamp=jnp.asarray(1.0, jdt), prev_timestamp=jnp.asarray(1.0, jdt),
        state_initialized=jnp.asarray(True), yaw_initialized=jnp.asarray(True))
    return params, st


def _pipelines(jdt, gps_type):
    jcfg, tcfg = tiny_cfg(jconfig), tiny_cfg(tconfig)
    for c, mod in ((jcfg, jconfig), (tcfg, tconfig)):
        c.ekf.use_gps = c.ekf.use_can = True
        c.ekf.gps_type = mod.GpsType[gps_type]
    jpp = jruntime.make_pipeline_params(jcfg, dtype=jdt)
    return jpp, jruntime.make_pipeline_static(jcfg), truntime.make_pipeline_static(tcfg)


def _same(a, b):
    for f in dataclasses.fields(b):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.mark.parametrize("gps_type", ["NAVSATFIX", "ODOMETRY"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_update_chain_plain_valid_none_matches_all_true_and_jax(dt_name, gps_type):
    jdt, tdt, atol = DTYPES[dt_name]
    params, jst = _moving(jdt, np.random.default_rng(29))
    jpp, jps, tps = _pipelines(jdt, gps_type)
    jpp = jpp.replace(ekf=params)
    J = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    st = jruntime.PipelineState(ekf=jst, ego_ring=jrings.make_ego_ring(8, jdt),
                                imu_ring=jrings.make_imu_ring(8, jdt))
    for k in range(len(CAN[0])):
        st = jruntime.can_step(st, J(CAN[0][k]), J(CAN[1][k]), J(CAN[2][k]), jpp, jps)
    for k in range(len(GPS[0])):
        st = jruntime.gps_step(st, J(GPS[0][k]), J(GPS[1][k]), J(GPS[2][k]), jpp, jps)

    tpp = convert.pipeline_params(flatten(jpp), dtype=tdt)
    tst = convert.ekf_state(flatten(jst), dtype=tdt)
    can = tuple(t(x, tdt) for x in CAN)
    gps = tuple(t(x, tdt) for x in GPS)
    kw = dict(gnss_uncertainty_max=tpp.gnss_uncertainty_max)
    none = tfilter.update_chain_plain(tst, tpp.ekf, tps.ekf_flags, can=can + (None,),
                                      gps=gps + (None,), **kw)
    ones = tfilter.update_chain_plain(
        tst, tpp.ekf, tps.ekf_flags, can=can + (torch.ones(len(CAN[0]), dtype=torch.bool),),
        gps=gps + (torch.ones(len(GPS[0]), dtype=torch.bool),), **kw)
    _same(none, ones)
    assert_tree_close(flatten(none), flatten(st.ekf), atol=atol)
    assert float((none.P - tst.P).abs().max()) > 0.0


@pytest.mark.parametrize("step", ["can_step", "gps_step"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_cpu_steps_equal_the_masked_sub_batch_of_one(dt_name, step):
    _, tdt, _ = DTYPES[dt_name]
    jdt = DTYPES[dt_name][0]
    params, jst = _moving(jdt, np.random.default_rng(31))
    jpp, _, tps = _pipelines(jdt, "NAVSATFIX")
    tpp = convert.pipeline_params(flatten(jpp.replace(ekf=params)), dtype=tdt)
    ekf = convert.ekf_state(flatten(jst), dtype=tdt)
    pst = truntime.PipelineState(ekf=ekf, ego_ring=trings.make_ego_ring(8, tdt),
                                 imu_ring=trings.make_imu_ring(8, tdt))
    one = torch.ones(1, dtype=torch.bool)
    if step == "can_step":
        x = tuple(t(a[1], tdt) for a in CAN)
        got = truntime.can_step(pst, *x, tpp, tps).ekf
        ref = tfilter.update_chain_plain(ekf, tpp.ekf, tps.ekf_flags,
                                         can=tuple(a[None] for a in x) + (one,))
    else:
        x = tuple(t(a[0], tdt) for a in GPS)
        got = truntime.gps_step(pst, *x, tpp, tps).ekf
        ref = tfilter.update_chain_plain(ekf, tpp.ekf, tps.ekf_flags,
                                         gps=tuple(a[None] for a in x) + (one,),
                                         gnss_uncertainty_max=tpp.gnss_uncertainty_max)
    _same(got, ref)
    assert float((got.P - ekf.P).abs().max()) > 0.0


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_radar_points_in_query_order_equal_the_slot_form(dt_name):
    tdt = DTYPES[dt_name][1]
    rng = np.random.default_rng(5)
    src = rng.normal(0.0, 15.0, (700, 3))
    pose = np.eye(4)
    pose[:3, :3] = ticp.lie.so3_exp(torch.tensor([0.02, -0.01, 0.7],
                                                 dtype=torch.float64)).numpy()
    pose[:3, 3] = [1000.0, 4.0, 0.5]
    params = ticp.make_icp_params(tconfig.ElimalocConfig().pcm, dtype=tdt)
    tsrc, tpose = t(src, tdt), t(pose, tdt)
    got = ticp.radar_points(tsrc, tpose, params)
    n = src.shape[0]
    ref = ticp.radar_slots_plain(tsrc, torch.arange(n, dtype=torch.int32).view(1, n),
                                 torch.ones((1, n), dtype=torch.bool), tpose,
                                 params).view(n, 3, 3)
    assert got.shape == (n, 3, 3)
    assert torch.equal(got, ref)
