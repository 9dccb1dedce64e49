"""Single-source benchmark measurement protocol.

The canonical workload and timing loop of ``bench.py``, and the peak table
it and ``chip_smoke.py`` share: compile ahead of time, time ``reps``
chained chunk dispatches that end in ``block_until_ready``, keep the best of
N trials.  The device's peak memory bandwidth, which rates are divided by,
comes from one table keyed by ``device_kind``.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

# Peak device-memory bandwidth (bytes/s) by ``jax.Device.device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part (80 GB HBM3 at
# 3.35 TB/s, at its 700 W power limit).
HBM_BANDWIDTH = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def bytes_per_point_step(itemsize: int) -> int:
    """Bytes per grid point per step of the one-step stencil at the memory
    bound: read u once, write u' once (neighbours come from on-chip caches)."""
    return 2 * itemsize


def hbm_bandwidth(device_kind: str) -> float:
    """Peak bandwidth of a device kind; an unknown kind is an error, never a
    default."""
    try:
        return HBM_BANDWIDTH[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth recorded for device kind {device_kind!r};"
            " add it to HBM_BANDWIDTH with its source"
        ) from None


def bench_config(nx: int, ny: int, chunk: int):
    """The canonical benchmark workload: diffusion+advection with mixed BCs
    (all three BC kinds exercised; matches BASELINE.json config #3)."""
    from .config import BCConfig, BCType, SimConfig

    cfg = SimConfig(nx=nx, ny=ny, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                    steps=chunk, out_every=chunk)
    cfg.bc = BCConfig(left=BCType.DIRICHLET, right=BCType.NEUMANN,
                      bottom=BCType.PERIODIC, top=BCType.PERIODIC)
    return cfg


def time_best_of(fn: Callable, u, reps: int, trials: int) -> Tuple[float, object]:
    """Warm up once, then time ``reps`` chained dispatches per trial, each
    trial ending in ``block_until_ready``; returns ``(best_seconds,
    final_u)``.  The minimum over trials is the estimate least disturbed by
    the host."""
    u = fn(u)
    u.block_until_ready()
    best = float("inf")
    for _trial in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            u = fn(u)
        u.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best, u
