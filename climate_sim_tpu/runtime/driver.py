"""Run driver: the JAX analogue of the reference's main()
(reference: src/main.cpp:23-138).

Flow parity: merge config -> CFL clamp with warning -> banner -> decomposition
(device mesh) -> IC -> IC min/max log -> open snapshot file -> time loop with
pre-update snapshots at ``n % out_every == 0`` -> timing line
``timing: total_max=<s> s, worst_avg_step=<s> s`` (greppable by the benchmark
harness, reference: run_benchmark.sh:34-39).

Differences from the reference: the time loop is chunked — each span between snapshot
points runs as ONE jitted ``lax.fori_loop`` program (halo exchange + BC +
fused stencil per step, all on device), so the host only intervenes at
snapshot cadence.  Snapshot host-transfers overlap the already-dispatched next
chunk (JAX async dispatch), the moral equivalent of the reference overlapping
PnetCDF writes with compute.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec, SingleDeviceSharding

from ..config import SimConfig, bc_to_string
from ..ops.init import apply_initial_condition, device_initial_condition
from ..ops.stability import clamp_dt, combined_dt_limit
from ..ops.step import build_single_device_advance, make_interior_step
from ..io.snapshots import ShardedSnapshotWriter, SnapshotWriter
from ..parallel.mesh import choose_mesh_shape, divisible, field_sharding, make_mesh
from ..parallel.halo import build_padded_gspmd_advance, build_sharded_advance

_DTYPES = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}

# Relative L2 error of bf16 storage against the f64 oracle, per step
# (docs/numerics.md "bf16 storage"): the bf16 advisory's growth rate.
BF16_ERR_PER_STEP = 1.1e-3

_distributed_spec: Optional[str] = None


def maybe_init_distributed(cfg: SimConfig) -> None:
    """Multi-host setup (the MPI_Init analogue, main.cpp:24): must run
    before any backend touch.  ``distributed="auto"`` takes the arguments
    from the cluster environment; else "coordinator:port,num_processes,
    process_id"."""
    global _distributed_spec
    if not cfg.distributed:
        return
    if _distributed_spec is not None:
        # jax.distributed can only initialize once per process; a different
        # spec on a later run would be silently ignored, so fail loudly.
        if cfg.distributed != _distributed_spec:
            raise RuntimeError(
                f"distributed already initialized with {_distributed_spec!r};"
                f" cannot re-initialize with {cfg.distributed!r}"
            )
        return
    if cfg.distributed == "auto":
        jax.distributed.initialize()
    else:
        parts = cfg.distributed.split(",")
        if len(parts) != 3:
            raise ValueError(
                "distributed must be 'auto' or 'coordinator:port,num_processes,process_id'"
            )
        jax.distributed.initialize(
            coordinator_address=parts[0],
            num_processes=int(parts[1]),
            process_id=int(parts[2]),
        )
    _distributed_spec = cfg.distributed


def is_controller() -> bool:
    """True on the logging/IO process (rank 0 of the multi-controller run)."""
    return jax.process_index() == 0


def _bounded_sync(name: str, timeout_s: Optional[float] = None) -> None:
    """Cross-process barrier that FAILS rather than hangs when a peer dies.

    ``multihost_utils.sync_global_devices`` is a compiled collective with no
    timeout: if the controller dies between creating the snapshot file and
    reaching the barrier, every peer blocks forever (and the dead
    controller's interpreter then hangs in the distributed-shutdown atexit
    waiting for those peers — a cluster-wide deadlock, observed).  Use the
    coordination-service barrier instead: it errors when the leader dies
    and times out (default 600 s, ``CLIMATE_SIM_SYNC_TIMEOUT_S``) when a
    live peer never arrives."""
    client = None
    try:
        # Non-public module: fall back to the untimed collective barrier if
        # a JAX upgrade moves it (hang-prone on peer death, but functional).
        from jax._src import distributed

        client = getattr(distributed.global_state, "client", None)
    except Exception:
        pass
    if client is None:  # single-process / no coordination service
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)
        return
    if timeout_s is None:
        timeout_s = float(os.environ.get("CLIMATE_SIM_SYNC_TIMEOUT_S", "600"))
    client.wait_at_barrier(name, timeout_in_ms=int(timeout_s * 1000))


def fetch_global(u: jax.Array) -> np.ndarray:
    """Materialize the full global field on this host.

    Multi-host: every host holds only its addressable shards, so gather via
    process_allgather.  The snapshot path does NOT use this on multi-host
    runs (each process hyperslab-writes its own shards, io.cpp:402-424
    analogue); this remains for ad-hoc inspection and final-state access.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(u, tiled=True))
    return np.asarray(jax.device_get(u))


def _field_stats(a: jax.Array) -> jax.Array:
    """[min, max, mean, l2] as ONE on-device vector — the diagnostic
    reductions the reference documents, computed without materializing the
    field on the host (one 4-scalar fetch when the caller reads it)."""
    af = a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a
    return jnp.stack(
        [jnp.min(af), jnp.max(af), jnp.mean(af), jnp.sqrt(jnp.sum(af * af))]
    )


@dataclasses.dataclass
class RunResult:
    u: jax.Array            # final state (never snapshotted unless write_final)
    total_time: float
    avg_step_time: float
    steps: int
    snapshots_written: int
    output_path: Optional[str]
    mesh_shape: Optional[tuple]
    dt: float
    clamped: bool
    compile_time: float = 0.0  # AOT compile of the chunk programs (set-up)
    devices: Optional[list] = None  # the devices the run used


def _log(msg: str) -> None:
    if jax.process_count() > 1 and not is_controller():
        return
    print(msg, flush=True)


def setup_precision(cfg: SimConfig) -> None:
    # Two-way toggle: a prior f64 run in this process must not leave x64 on
    # for a later f32/bf16 run (Python scalars would then trace as f64).
    # Only flip when the flag actually differs, and say so — an embedding
    # application may have set x64 for its own reasons.
    want_x64 = cfg.precision == "f64"
    if bool(jax.config.read("jax_enable_x64")) != want_x64:
        _log(f"[precision] setting jax_enable_x64={want_x64} for {cfg.precision} run")
        jax.config.update("jax_enable_x64", want_x64)
    if cfg.debug_nans:
        jax.config.update("jax_debug_nans", True)


def prepare(cfg: SimConfig, devices=None):
    """Resolve dtype, dt clamp, mesh, sharded/single advance, and the IC.

    Returns (u0, advance, mesh, dt).  ``advance(k)`` is a jitted function
    advancing the global field k steps.
    """
    maybe_init_distributed(cfg)
    setup_precision(cfg)
    dtype = _DTYPES[cfg.precision]

    dt, limit, clamped = clamp_dt(cfg.dt, cfg.dx, cfg.dy, cfg.vx, cfg.vy, cfg.D)
    if clamped and is_controller():
        # rank-0 warning, like the reference (main.cpp:44-47)
        print(
            f"[warn] dt={cfg.dt:g} exceeds stability limit {limit:g}"
            f" -> clamping to dt={dt:g}",
            file=sys.stderr,
            flush=True,
        )
    if cfg.precision == "bf16":
        # Long-horizon advisory (sibling of the combined-dt one below): bf16
        # storage rounds the field once per step, and its relative L2 error
        # against the f64 oracle grows about linearly with the step count
        # (BF16_ERR_PER_STEP, fit to a measured run; docs/numerics.md).
        # Warn past a ~5% budget instead of silently producing
        # decorrelated output on a long run.
        est = BF16_ERR_PER_STEP * cfg.steps
        if est > 0.05 and is_controller():
            print(
                f"[warn] precision=bf16 over {cfg.steps} steps"
                f" ({cfg.steps} rounding events, one per step): estimated"
                f" relative error vs f64 ~{est:.2g} (measured"
                f" ~{BF16_ERR_PER_STEP:.1g}/step, linear growth).  bf16"
                " storage mode is fit for short-horizon/memory-constrained"
                " runs; use precision=f32 for long-horizon accuracy",
                file=sys.stderr,
                flush=True,
            )
    comb = combined_dt_limit(cfg.dx, cfg.dy, cfg.vx, cfg.vy, cfg.D)
    if dt > comb * (1.0 + 1e-12) and is_controller():
        # Advisory only — the clamp keeps the reference's envelope
        # (behavioral parity), but that envelope is insufficient when
        # advection AND diffusion are active (see ops/stability.py).
        print(
            f"[warn] dt={dt:g} exceeds the COMBINED advection+diffusion"
            f" stability bound {comb:g}; the run may diverge"
            " (the reference's clamp envelope does not cover this case)",
            file=sys.stderr,
            flush=True,
        )

    devs = list(devices) if devices is not None else jax.devices()
    if cfg.max_devices:
        devs = devs[: cfg.max_devices]
    mesh = None
    if cfg.mesh.enable and len(devs) > 1:
        px, py = choose_mesh_shape(len(devs), cfg.nx, cfg.ny, cfg.mesh.x, cfg.mesh.y)
        mesh = make_mesh(px, py, devs)

    def place_ic(sharding):
        # Multi-process: materialize the IC sharded at birth (a host-array
        # device_put would allgather the global field on every process for
        # jax's cross-host equality check).  Single process: all shardings
        # are fully addressable, so the plain host-compute + device_put
        # needs no extra compiled program.
        if jax.process_count() > 1:
            return device_initial_condition(cfg, dtype, sharding)
        return jax.device_put(apply_initial_condition(cfg, dtype), sharding)

    if mesh is None:
        u0 = place_ic(SingleDeviceSharding(devs[0]))
        advance = build_single_device_advance(cfg, dt)
    elif divisible(mesh, cfg.nx, cfg.ny):
        u0 = place_ic(field_sharding(mesh))
        advance = build_sharded_advance(cfg, mesh, dt, make_interior_step(cfg, dt))
    else:
        # Indivisible grid: shard only the axes the mesh divides evenly (JAX
        # refuses uneven explicit shardings) and let GSPMD partition the
        # global program (decision log #6) — compiler-managed halos.
        sy = "y" if cfg.ny % mesh.shape["y"] == 0 else None
        sx = "x" if cfg.nx % mesh.shape["x"] == 0 else None
        if sy is None and sx is None:
            # Indivisible along BOTH axes: embed in a padded carrier of the
            # next mesh-multiple shape so compute still scales with the
            # mesh (the padding alternative of decision log #6).  The field
            # itself stays (ny, nx), replicated at the jit boundary; the
            # snapshot writer dedups replicas.
            _log(
                f"[info] grid {cfg.nx}x{cfg.ny} is indivisible along"
                f" both axes of the {len(devs)}-device mesh; running"
                " the padded GSPMD path (carrier"
                f" {-(-cfg.nx // mesh.shape['x']) * mesh.shape['x']}x"
                f"{-(-cfg.ny // mesh.shape['y']) * mesh.shape['y']})"
            )
            u0 = place_ic(NamedSharding(mesh, PartitionSpec(None, None)))
            advance = build_padded_gspmd_advance(cfg, mesh, dt)
        else:
            u0 = place_ic(NamedSharding(mesh, PartitionSpec(sy, sx)))
            advance = build_single_device_advance(cfg, dt)

    return u0, advance, mesh, dt, clamped


def run_simulation(cfg: SimConfig, devices=None, write_output: bool = True) -> RunResult:
    """Execute a full run (the reference main loop, main.cpp:93-133)."""
    u, advance, mesh, dt, clamped = prepare(cfg, devices)
    # Record the dt actually used: the reference clamps cfg.dt in place
    # before writing metadata (main.cpp:42-49), so the snapshot attrs must
    # carry the clamped value.
    cfg = dataclasses.replace(cfg, dt=dt)

    _log(
        "climate-sim-tpu\n"
        f"  grid: {cfg.nx} x {cfg.ny}  dt: {dt:g}  steps: {cfg.steps}"
        f"  D: {cfg.D:g}  v=({cfg.vx:g},{cfg.vy:g})\n"
        f"  bc: left={bc_to_string(cfg.bc.left)} right={bc_to_string(cfg.bc.right)}"
        f" bottom={bc_to_string(cfg.bc.bottom)} top={bc_to_string(cfg.bc.top)}"
    )
    used = list(mesh.devices.ravel()) if mesh is not None else sorted(u.devices(), key=lambda d: d.id)
    _log(f"  device: platform={used[0].platform} kind={used[0].device_kind}"
         f" count={len(used)}")
    if mesh is not None:
        _log(f"  mesh: x={mesh.shape['x']} y={mesh.shape['y']} ({len(mesh.devices.ravel())} devices)")

    # IC sanity log via on-device reductions (a 4-scalar fetch, not a global
    # gather) — also the sync point that surfaces a bad IC before the
    # snapshot file is created.
    stats = jax.jit(_field_stats)
    ic_stats = np.asarray(jax.device_get(stats(u)), dtype=np.float64)
    _log(f"IC min/max: {ic_stats[0]:g} / {ic_stats[1]:g}")

    multi_host = jax.process_count() > 1
    writer = None
    sharded_writer = None
    out_path = None
    if write_output and cfg.output_enable:
        out_path = cfg.resolved_output_path()
        _log("Opening NetCDF file for output")
        if multi_host:
            # Parallel hyperslab snapshot writes (io.cpp:402-424 analogue):
            # the controller creates the file + header, then every process
            # attaches and writes only its own shard rows.  No host ever
            # holds the global array.
            if is_controller():
                try:
                    sharded_writer = ShardedSnapshotWriter(
                        out_path, cfg, create=True
                    )
                except Exception:
                    # Peers are already committed to the open barrier and
                    # will stall until the coordinator's heartbeat timeout
                    # tears the job down; make sure the REAL error (disk
                    # full, permissions, ...) is on the controller's stderr
                    # before that masks it.
                    import traceback

                    traceback.print_exc()
                    raise
            _bounded_sync("climate_sim_tpu:snapshot_open")
            if not is_controller():
                sharded_writer = ShardedSnapshotWriter(out_path, cfg, create=False)
        else:
            writer = SnapshotWriter(out_path, cfg)

    def emit_snapshot(frame_src: jax.Array) -> None:
        if sharded_writer is not None:
            sharded_writer.write_shards(frame_src)
        elif writer is not None:
            writer.write(fetch_global(frame_src))

    # Cap each dispatched program at max_dispatch steps and chain the
    # pieces host-side: every span of any cadence then reuses the same
    # few compiled programs (a 60000-step span is the cap's program plus
    # one remainder), and chained dispatches queue back to back on the
    # device with no host sync between them.
    max_dispatch = 256

    def span_pieces(k: int):
        pieces = []
        while k > 0:
            kk = min(k, max_dispatch)
            pieces.append(kk)
            k -= kk
        return pieces

    # Warm-up: AOT-compile every distinct chunk program outside the timed
    # region (the reference pays no JIT cost).  A failed compile raises.
    t_compile = time.perf_counter()
    chunk_sizes = set()
    n = 0
    while n < cfg.steps:
        k = min(cfg.out_every - (n % cfg.out_every), cfg.steps - n)
        chunk_sizes.update(span_pieces(k))
        n += k
    compiled = {k: advance(k).lower(u).compile() for k in chunk_sizes}
    compile_time = time.perf_counter() - t_compile
    _log(f"compile: {compile_time:g} s for {len(compiled)} chunk programs"
         " (outside the timed region)")

    def dispatch_span(u, k):
        # All pieces dispatch asynchronously (no host sync between them).
        for kk in span_pieces(k):
            u = compiled[kk](u)
        return u

    profiling = bool(cfg.profile_dir)
    if profiling:
        _log(f"profiler trace -> {cfg.profile_dir}")
        jax.profiler.start_trace(cfg.profile_dir)

    any_writer = writer is not None or sharded_writer is not None
    snapshots = 0
    diag_pending = []  # (step, on-device stats vector): fetched AFTER timing
    n = 0
    t0 = time.perf_counter()
    while n < cfg.steps:
        k = min(cfg.out_every - (n % cfg.out_every), cfg.steps - n)
        if n % cfg.out_every == 0 and any_writer:
            u_snap = u
            u = dispatch_span(u, k)  # dispatch next chunk before the host transfer
            emit_snapshot(u_snap)
            snapshots += 1
        else:
            u = dispatch_span(u, k)
        if cfg.diagnostics_every and (n // cfg.out_every) % max(1, cfg.diagnostics_every) == 0:
            # Dispatch the reductions now, fetch after the timed loop.  The
            # host sync/transfer cost is excluded from the timing line; the
            # device-side cost — one fused min/max/mean/L2 pass over the
            # field per diagnostics event, ~1 HBM read — remains in the
            # timed region, as any in-loop diagnostic must (~1-2% of an
            # out_every=100 chunk; grows as out_every shrinks).  Keeping
            # field references to defer the dispatch too would pin one full
            # field in HBM per pending event.
            diag_pending.append((n + k, stats(u)))
        n += k
    u.block_until_ready()
    total = time.perf_counter() - t0
    if profiling:
        jax.profiler.stop_trace()

    for step, vec in diag_pending:
        mn, mx, mean, l2 = np.asarray(jax.device_get(vec), dtype=np.float64)
        _log(f"diag: step={step} min={mn:.6g} max={mx:.6g} mean={mean:.6g} l2={l2:.6g}")

    if cfg.write_final and any_writer:
        emit_snapshot(u)
        snapshots += 1
    for w in (writer, sharded_writer):
        if w is not None:
            w.close()

    if multi_host:
        # MPI_Reduce(MAX) analogue (main.cpp:127-128): max wall time over hosts.
        from jax.experimental import multihost_utils

        total = float(
            np.max(multihost_utils.process_allgather(jnp.asarray([total])))
        )
    avg_step = total / max(1, cfg.steps)
    _log(f"timing: total_max={total:g} s, worst_avg_step={avg_step:g} s")
    # Derived throughput (SURVEY.md §5 tracing plan): the per-device rate
    # the benchmark methodology is defined in terms of.
    pts = cfg.nx * cfg.ny * cfg.steps / max(total, 1e-12)
    _log(f"throughput: {pts / 1e6:.1f} Mpoint/s total, "
         f"{pts / 1e6 / len(used):.1f} Mpoint/s/device")

    return RunResult(
        u=u,
        total_time=total,
        avg_step_time=avg_step,
        steps=cfg.steps,
        snapshots_written=snapshots,
        output_path=out_path,
        mesh_shape=(mesh.shape["y"], mesh.shape["x"]) if mesh is not None else None,
        dt=dt,
        clamped=clamped,
        compile_time=compile_time,
        devices=used,
    )
