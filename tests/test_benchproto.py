"""The shared benchmark measurement protocol (climate_sim_tpu/benchproto.py)
used by bench.py and chip_smoke.py — config literal, the best-of-N timing
loop and the device peak table."""

import jax
import jax.numpy as jnp
import pytest

from climate_sim_tpu.benchproto import (
    HBM_BANDWIDTH,
    bench_config,
    bytes_per_point_step,
    hbm_bandwidth,
    time_best_of,
)
from climate_sim_tpu.config import BCType


def test_bench_config_is_canonical_workload():
    cfg = bench_config(256, 128, 10)
    assert (cfg.nx, cfg.ny) == (256, 128)
    assert (cfg.steps, cfg.out_every) == (10, 10)
    assert (cfg.D, cfg.vx, cfg.vy) == (0.05, 0.5, -0.25)
    # all three BC kinds exercised
    assert set(cfg.bc.as_tuple()) == {
        BCType.DIRICHLET, BCType.NEUMANN, BCType.PERIODIC
    }
    cfg.validate()


def test_aot_compile_and_time_best_of():
    u0 = jnp.ones((8, 8), jnp.float32)
    fn = jax.jit(lambda u: u * 2.0).lower(u0).compile()
    best, out = time_best_of(fn, u0, reps=3, trials=2)
    assert best > 0.0
    # warm-up (1) + 2 trials x 3 reps = 7 doublings
    assert float(out[0, 0]) == 2.0 ** 7


def test_peak_table_and_unknown_device():
    """The H100's peak comes from the table; an unknown kind is an error,
    never a default."""
    assert hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert set(HBM_BANDWIDTH) == {"NVIDIA H100 80GB HBM3"}
    with pytest.raises(ValueError, match="no peak bandwidth"):
        hbm_bandwidth("Some Accelerator X")
    with pytest.raises(ValueError, match="no peak bandwidth"):
        hbm_bandwidth(jax.devices()[0].device_kind)


@pytest.mark.parametrize("itemsize,want", [(2, 4), (4, 8), (8, 16)])
def test_bytes_per_point_step(itemsize, want):
    """One read and one write of the field per step at the memory bound."""
    assert bytes_per_point_step(itemsize) == want
