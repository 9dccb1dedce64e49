"""Pod-shape virtual-mesh test: the sharded machinery at 32 devices.

Every in-process test runs on the conftest's 8-device virtual mesh; this
subprocess raises the count to 32 (an 8x4 mesh) to show the sharded
machinery is scale-independent: mesh-shape selection, ppermute neighbor
wiring and oracle parity all hold unchanged at a device count no single
host offers.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
import numpy as np
import jax.numpy as jnp
from climate_sim_tpu.config import BCConfig, BCType, SimConfig
from climate_sim_tpu.ops.init import gaussian_hotspot
from climate_sim_tpu.ops.step import make_interior_step, reference_step
from climate_sim_tpu.parallel.mesh import choose_mesh_shape, make_mesh, field_sharding
from climate_sim_tpu.parallel.halo import build_sharded_advance

assert len(jax.devices()) == 32, len(jax.devices())
px, py = choose_mesh_shape(32, 32 * 8, 16 * 4)
assert px * py == 32, (px, py)
nx, ny = 32 * px, 16 * py
cfg = SimConfig(nx=nx, ny=ny, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                steps=13, out_every=13)
cfg.bc = BCConfig(BCType.PERIODIC, BCType.PERIODIC,
                  BCType.NEUMANN, BCType.DIRICHLET)
mesh = make_mesh(px, py)
u = gaussian_hotspot(cfg, jnp.float32)
ref = np.asarray(u)
for _ in range(cfg.steps):
    ref = np.asarray(reference_step(jnp.asarray(ref), cfg, cfg.dt))
adv = build_sharded_advance(cfg, mesh, cfg.dt, make_interior_step(cfg, cfg.dt))
out = np.asarray(jax.device_get(
    adv(cfg.steps)(jax.device_put(u, field_sharding(mesh)))))
err = np.abs(out - ref).max()
assert err < 1e-5, err
print("POD_OK", px, py, nx, ny, err, flush=True)
""".format(repo=REPO)


@pytest.mark.slow
def test_32_device_pod_shape_mesh():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    p = subprocess.run(
        [sys.executable, "-c", WORKER], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "POD_OK" in p.stdout
