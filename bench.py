"""Headline benchmark: grid-points/s on one device for the 4096^2
diffusion+advection fused step (BASELINE.json metric).

Prints exactly ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "points/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so the
baseline is the device-memory roofline for this memory-bound stencil: one f32
read and one f32 write per point per step = 8 bytes/point over the device's
peak bandwidth (``benchproto.HBM_BANDWIDTH``; an unknown device is an
error).  vs_baseline = value / roofline, the fraction of speed-of-light.
Run it on the accelerator: ``python bench.py``.
"""

from __future__ import annotations

import json
import sys


def main() -> int:
    from climate_sim_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from climate_sim_tpu.benchproto import (
        bench_config,
        bytes_per_point_step,
        hbm_bandwidth,
        time_best_of,
    )
    from climate_sim_tpu.ops.init import gaussian_hotspot
    from climate_sim_tpu.ops.step import build_single_device_advance

    NX = NY = 4096
    CHUNK = 100  # steps per dispatched program
    REPS = 20    # chained chunks per timed trial

    cfg = bench_config(NX, NY, CHUNK)
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    bw = hbm_bandwidth(dev.device_kind)
    print(f"[bench] device={device}", file=sys.stderr)

    advance = build_single_device_advance(cfg, cfg.dt)
    u = jax.device_put(gaussian_hotspot(cfg, jnp.float32), dev)
    fn = advance(CHUNK).lower(u).compile()

    best, _u = time_best_of(fn, u, REPS, trials=3)

    steps = REPS * CHUNK
    pts_per_s = NX * NY * steps / best
    roofline = bw / bytes_per_point_step(4)
    result = {
        "metric": "grid_points_per_s_4096sq_diffadv",
        "value": round(pts_per_s, 1),
        "unit": "points/s",
        "vs_baseline": round(pts_per_s / roofline, 4),
        "device": device,
    }
    print(f"[bench] {steps} steps in {best:.4f}s (best of 3) -> {pts_per_s/1e9:.2f} Gpoint/s "
          f"({100*pts_per_s/roofline:.1f}% of the {bw/1e12:.2f} TB/s roofline)",
          file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
