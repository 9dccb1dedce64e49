"""In-process coverage of driver branches normally reached only in
subprocess/multi-host runs: distributed-init specs, the multi-host logging/
IO/timing paths (via monkeypatched ``jax.process_count``), profiling, GSPMD
fallback, and device capping.
"""

import os

import jax
import numpy as np
import pytest

from climate_sim_tpu.config import SimConfig
from climate_sim_tpu.runtime import driver as drv


@pytest.fixture(autouse=True)
def _reset_debug_nans():
    yield
    jax.config.update("jax_debug_nans", False)


# -------------------------------------------------- maybe_init_distributed


def test_distributed_spec_guard(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(drv, "_distributed_spec", None)

    cfg = SimConfig()
    cfg.distributed = "auto"
    drv.maybe_init_distributed(cfg)
    assert calls == [((), {})]

    # Same spec again: no re-init.
    drv.maybe_init_distributed(cfg)
    assert len(calls) == 1

    # Different spec: loud failure, not silent drop (ADVICE round 1).
    cfg2 = SimConfig()
    cfg2.distributed = "host:1234,2,0"
    with pytest.raises(RuntimeError, match="already initialized"):
        drv.maybe_init_distributed(cfg2)


def test_distributed_explicit_spec(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **k: calls.append(k))
    monkeypatch.setattr(drv, "_distributed_spec", None)
    cfg = SimConfig()
    cfg.distributed = "host:1234,2,1"
    drv.maybe_init_distributed(cfg)
    assert calls == [{"coordinator_address": "host:1234",
                      "num_processes": 2, "process_id": 1}]

    monkeypatch.setattr(drv, "_distributed_spec", None)
    cfg.distributed = "not-a-valid-spec"
    with pytest.raises(ValueError, match="distributed must be"):
        drv.maybe_init_distributed(cfg)


# ----------------------------------------------- multi-host code paths


def test_log_suppressed_off_controller(monkeypatch, capsys):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    drv._log("should not appear")
    assert capsys.readouterr().out == ""


def _fake_two_processes(monkeypatch, process_index=0):
    """Fake a 2-process world on one real process: multihost_utils'
    collectives reshape jax.devices() by the real process count, so stub
    them with their single-process identities."""
    from jax.experimental import multihost_utils as mhu

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: process_index)
    monkeypatch.setattr(mhu, "process_allgather",
                        lambda x, tiled=False: np.asarray(x))
    monkeypatch.setattr(mhu, "sync_global_devices", lambda name: None)


def test_fetch_global_multihost_gather(monkeypatch):
    _fake_two_processes(monkeypatch)
    u = jax.numpy.arange(6.0).reshape(2, 3)
    got = drv.fetch_global(u)  # stubbed process_allgather path
    np.testing.assert_array_equal(got, np.arange(6.0).reshape(2, 3))


def test_run_multihost_paths_single_process(monkeypatch, tmp_path):
    """A faked 2-process world on ONE real process drives the sharded-writer
    create path, the off-controller log gate, and the MAX-over-hosts timing
    reduction — with all shards locally addressable."""
    _fake_two_processes(monkeypatch)
    cfg = SimConfig(nx=64, ny=32, D=0.05, dt=0.1, steps=4, out_every=2)
    cfg.output_dir = str(tmp_path / "o")
    res = drv.run_simulation(cfg)
    assert res.snapshots_written == 2
    assert os.path.exists(res.output_path)
    assert res.total_time >= 0.0


def test_sharded_writer_attach_branch(monkeypatch, tmp_path):
    """Off-controller processes attach (create=False) to the header the
    controller wrote (driver.py:259-260)."""
    from climate_sim_tpu.io.snapshots import ShardedSnapshotWriter

    cfg = SimConfig(nx=32, ny=16, steps=2, out_every=1)
    cfg.output_dir = str(tmp_path / "o")
    path = cfg.resolved_output_path()
    ShardedSnapshotWriter(path, cfg, create=True, use_native=False).close()

    seen = {}
    real_ctor = ShardedSnapshotWriter.__init__

    def spy(self, path, cfg, create, use_native=True):
        seen["create"] = create
        real_ctor(self, path, cfg, create, use_native)

    _fake_two_processes(monkeypatch, process_index=1)
    monkeypatch.setattr(ShardedSnapshotWriter, "__init__", spy)
    monkeypatch.setattr(drv, "ShardedSnapshotWriter", ShardedSnapshotWriter)
    res = drv.run_simulation(cfg)
    assert seen["create"] is False
    assert res.snapshots_written == cfg.steps


# ------------------------------------------------------- other branches


def test_debug_nans_and_max_devices(tmp_path):
    cfg = SimConfig(nx=16, ny=16, steps=1, out_every=1)
    cfg.debug_nans = True
    cfg.max_devices = 1
    cfg.output_dir = str(tmp_path / "o")
    res = drv.run_simulation(cfg)
    assert res.mesh_shape is None  # capped to one device -> no mesh
    assert bool(jax.config.jax_debug_nans) is True


def test_profile_dir_writes_trace(tmp_path):
    cfg = SimConfig(nx=16, ny=16, steps=2, out_every=1)
    cfg.profile_dir = str(tmp_path / "trace")
    cfg.output_dir = str(tmp_path / "o")
    drv.run_simulation(cfg)
    assert any(os.scandir(cfg.profile_dir)), "no trace artifacts written"


def test_partially_divisible_grid_shards_one_axis(tmp_path):
    """nx divisible / ny indivisible -> GSPMD fallback shards only the x
    axis (JAX refuses uneven explicit shardings) and still runs."""
    cfg = SimConfig(nx=16, ny=11, D=0.02, dt=0.1, steps=2, out_every=1)
    cfg.output_dir = str(tmp_path / "o")
    res = drv.run_simulation(cfg)
    assert res.snapshots_written == 2
    assert res.mesh_shape is not None
    assert np.isfinite(np.asarray(jax.device_get(res.u))).all()


def test_fully_indivisible_grid_takes_padded_gspmd_path(tmp_path, capsys):
    """Neither axis divisible by any factorization -> padded-carrier GSPMD
    run that keeps the mesh (decision log #6's padding alternative; this
    previously degraded to a warned single-device run), end-to-end through
    snapshots, and exact vs the oracle."""
    from climate_sim_tpu.ops.init import gaussian_hotspot
    from climate_sim_tpu.ops.step import reference_step

    cfg = SimConfig(nx=13, ny=11, D=0.02, dt=0.1, steps=2, out_every=1)
    cfg.output_dir = str(tmp_path / "o")
    res = drv.run_simulation(cfg)
    assert res.snapshots_written == 2
    assert res.mesh_shape is not None
    assert "padded GSPMD" in capsys.readouterr().out
    u = np.asarray(jax.device_get(res.u))
    assert np.isfinite(u).all()
    ref = gaussian_hotspot(cfg, res.u.dtype)
    for _ in range(cfg.steps):
        ref = reference_step(ref, cfg, res.dt)
    np.testing.assert_allclose(u, np.asarray(ref), atol=1e-6)


def test_single_device_misaligned_grid_matches_oracle(tmp_path, capsys):
    """A misaligned grid (the reference's remainder-decomposition shapes,
    e.g. 250x1080) on ONE device runs the plain single-device path, end to
    end through snapshots, and matches the oracle; no mesh is built."""
    from climate_sim_tpu.ops.init import gaussian_hotspot
    from climate_sim_tpu.ops.step import reference_step

    cfg = SimConfig(nx=250, ny=1080, D=0.02, dt=0.1, steps=2, out_every=1)
    cfg.output_dir = str(tmp_path / "o")
    res = drv.run_simulation(cfg, devices=jax.devices()[:1])
    out = capsys.readouterr().out
    assert "mesh:" not in out and "device: platform=cpu" in out
    assert res.snapshots_written == 2
    assert res.mesh_shape is None
    u = np.asarray(jax.device_get(res.u))
    assert u.shape == (cfg.ny, cfg.nx)
    ref = gaussian_hotspot(cfg, res.u.dtype)
    for _ in range(cfg.steps):
        ref = reference_step(ref, cfg, res.dt)
    np.testing.assert_allclose(u, np.asarray(ref), atol=1e-6)
