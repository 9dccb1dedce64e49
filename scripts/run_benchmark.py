#!/usr/bin/env python3
"""Strong/weak scaling benchmark harness.

Mirrors the reference's ``scripts/run_benchmark.sh`` protocol and CSV schema
(reference: run_benchmark.sh:31-91): strong scaling on a fixed grid over a
rank sweep, weak scaling with a fixed per-rank tile, speedup S=T1/Tp,
efficiency E=S/p and Karp-Flatt (1/S-1/p)/(1-1/p) annotations.

Where the reference launches ``mpirun [--oversubscribe] -np p``, this
harness offers three platforms, each parsing the driver's greppable
``timing: total_max=... worst_avg_step=...`` line (driver.py prints it for
exactly this purpose, like main.cpp:127-133):

* ``multiproc`` (default) — p coordinated ``jax.distributed`` OS processes,
  one virtual CPU device each, forming one p-device mesh: ranks map to real
  OS-level parallelism, so speedup/efficiency are honestly interpretable
  (the direct analogue of ``mpirun -np p`` on one node).  Rank counts above
  the machine's core count measure oversubscription, not scaling — the
  harness warns and annotates.
* ``cpu`` — one process with a p-device *virtual* mesh
  (``--xla_force_host_platform_device_count=p``).  This validates the
  sharded code path and measures collective/partitioning overhead, but all
  "ranks" share one host's cores: do NOT read its speedup column as
  scaling (it is the analogue of ``mpirun --oversubscribe`` far past the
  core count).
* ``gpu`` — the attached GPUs (rank counts capped at the device count).
  Each measured run is its own child process and the harness itself never
  initializes JAX (it counts the GPUs through a short child probe), so every
  child has the cards to itself.

Outputs (same filenames/columns as the reference, plus a leading
``platform`` column):
    bench/results/strong_<ts>.csv
    bench/results/strong_annotated_<ts>.csv
    bench/results/weak_<ts>.csv
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import re
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMING_RE = re.compile(r"timing: total_max=([0-9.eE+-]+)")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _sim_args(nx: int, ny: int, steps: int, extra: list[str]) -> list[str]:
    return [
        sys.executable, "-m", "climate_sim_tpu",
        f"--nx={nx}", f"--ny={ny}", f"--steps={steps}",
        "--out_every=1000000",  # timing runs write no mid-run snapshots
        "--output.enable=false",
    ] + extra


def run_multiproc(p: int, nx: int, ny: int, steps: int,
                  extra: list[str], nocomm: bool = False) -> tuple[float, float]:
    """p coordinated jax.distributed processes (1 virtual CPU device each)
    forming one p-device mesh — the mpirun -np p analogue.  Returns the
    controller's MAX-over-hosts timing.

    ``nocomm=True`` is the CONTENTION CONTROL: p INDEPENDENT single-rank
    runs, each on 1/p of the grid, launched simultaneously on distinct
    cores with no communication at all.  Its timing isolates the
    shared-DRAM/core contention term of multiproc scaling from the
    collective cost."""
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # One core per rank, like `mpirun -np p` with one PE per rank: without
    # this, rank 1's XLA intra-op threadpool already uses every core and the
    # sweep measures thread-vs-process contention instead of scaling.
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=1"
        + " --xla_cpu_multi_thread_eigen=false"
        + " intra_op_parallelism_threads=1"
    )
    env["OMP_NUM_THREADS"] = "1"
    # Hard-pin each rank to its own core (XLA's thread flags alone are not
    # reliably honored): rank i -> core i, the mpirun bind-to-core analogue.
    ncores = os.cpu_count() or 1
    import shutil

    pin = shutil.which("taskset") is not None
    # Each rank's output goes to its own temp file, NOT a pipe: draining p
    # pipes sequentially can deadlock when a non-zero rank emits more than
    # the pipe buffer (it blocks on write, never reaches the end-of-run
    # barrier, and rank 0 never exits).
    import tempfile

    outfiles = [tempfile.TemporaryFile(mode="w+") for _ in range(p)]

    def rank_args(i):
        if not nocomm:
            return (_sim_args(nx, ny, steps, extra)
                    + [f"--distributed=127.0.0.1:{port},{p},{i}"])
        # independent 1/p-grid runs: split the LARGER axis p ways (the
        # same per-rank interior work as the mesh run, zero comm)
        if ny >= nx:
            return _sim_args(nx, ny // p, steps, extra)
        return _sim_args(nx // p, ny, steps, extra)

    procs = [
        subprocess.Popen(
            (["taskset", "-c", str(i % ncores)] if pin else [])
            + rank_args(i),
            cwd=REPO_ROOT, env=env, stdout=outfiles[i],
            stderr=subprocess.STDOUT, text=True,
        )
        for i in range(p)
    ]
    try:
        for pr in procs:
            pr.wait(timeout=1800)
    except subprocess.TimeoutExpired:
        for pr in procs:  # kill the exact PIDs we started, never by pattern
            if pr.poll() is None:
                pr.kill()
        for pr in procs:
            pr.wait()
        raise
    outs = []
    for f in outfiles:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for i, (pr, o) in enumerate(zip(procs, outs)):
        if pr.returncode != 0:
            raise RuntimeError(
                f"multiproc rank {i}/{p} failed (exit {pr.returncode}):\n{o[-2000:]}"
            )
    if nocomm:
        # independent runs: the slowest rank is the honest analogue of
        # the mesh run's MAX-over-hosts timing
        totals = []
        for i, o in enumerate(outs):
            m = _TIMING_RE.search(o)
            if not m:
                raise RuntimeError(
                    f"no timing line in nocomm rank-{i} output:\n{o[-2000:]}"
                )
            totals.append(float(m.group(1)))
        total = max(totals)
        return total, total / steps
    m = _TIMING_RE.search(outs[0])
    if not m:
        raise RuntimeError(f"no timing line in rank-0 output:\n{outs[0][-2000:]}")
    total = float(m.group(1))
    return total, total / steps


def run_one(p: int, nx: int, ny: int, steps: int, platform: str,
            extra: list[str]) -> tuple[float, float]:
    """One measurement -> (total_time, perstep_time)."""
    if platform == "multiproc":
        return run_multiproc(p, nx, ny, steps, extra)
    if platform == "multiproc_nocomm":
        return run_multiproc(p, nx, ny, steps, extra, nocomm=True)
    env = dict(os.environ)
    args = _sim_args(nx, ny, steps, extra)
    if platform == "cpu":
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + f" --xla_force_host_platform_device_count={p}"
        )
    else:
        # Real devices: cap the device count per measurement, else every
        # row would silently use all attached GPUs.
        args.append(f"--max_devices={p}")
    out = subprocess.run(
        args, cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=1800
    )
    if out.returncode != 0:
        raise RuntimeError(
            f"run p={p} nx={nx} ny={ny} failed (exit {out.returncode}):\n{out.stderr[-2000:]}"
        )
    m = _TIMING_RE.search(out.stdout)
    if not m:
        raise RuntimeError(f"no timing line in output:\n{out.stdout[-2000:]}")
    total = float(m.group(1))
    return total, total / steps


def count_gpus() -> int:
    """Number of visible GPUs, counted in a short child process: a JAX
    backend initialized here would reserve most of every card's memory for
    this parent, and the measured children would then fail for want of it."""
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(len(jax.devices('gpu')))"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
    )
    if probe.returncode != 0:
        raise RuntimeError(f"GPU probe failed:\n{probe.stderr[-2000:]}")
    return int(probe.stdout.strip().splitlines()[-1])


def annotate_strong(rows: list[tuple]) -> tuple[list[tuple], int]:
    """Annotate with S=T1/Tp, E=S/p, Karp-Flatt.  The baseline is the
    SMALLEST rank count in the sweep (not blindly rows[0]); if that is
    p0 > 1, T1 is extrapolated as p0*T_p0 (ideal-linear at the baseline)
    so the columns keep their standard meaning — the caller records the
    extrapolation in a CSV comment.  Returns (annotated_rows, p0)."""
    base = min(rows, key=lambda r: r[0])
    p0 = base[0]
    t1 = base[4] * p0
    ann = []
    for (p, nx, ny, steps, total, perstep) in rows:
        s = t1 / total if total > 0 else 0.0
        e = s / p if p else 0.0
        kf = ((1.0 / s - 1.0 / p) / (1.0 - 1.0 / p)) if (p > 1 and s > 0) else 0.0
        ann.append((p, nx, ny, steps, total, perstep, s, e, kf))
    return ann, p0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--platform",
                    choices=["multiproc", "multiproc_nocomm", "cpu", "gpu"],
                    default="multiproc",
                    help="multiproc = p coordinated OS processes, 1 device "
                         "each (real parallelism; default); multiproc_nocomm "
                         "= p INDEPENDENT pinned runs on 1/p grids (the "
                         "contention control for the latency-model "
                         "validation); cpu = one process "
                         "with a virtual p-device mesh (path validation only, "
                         "NOT scaling); gpu = the attached GPUs")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--strong-nx", type=int, default=1024)
    ap.add_argument("--strong-ny", type=int, default=1024)
    ap.add_argument("--strong-ranks", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--weak-tile-nx", type=int, default=256)
    ap.add_argument("--weak-tile-ny", type=int, default=256)
    ap.add_argument("--weak-ranks", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--out-dir", default=os.path.join(REPO_ROOT, "bench", "results"))
    ap.add_argument("--skip-weak", action="store_true")
    args, extra = ap.parse_known_args()
    # Unrecognized --key=value tokens pass through to the simulation CLI.
    args.extra = extra

    if args.platform == "gpu":
        n = count_gpus()
        args.strong_ranks = sorted({min(p, n) for p in args.strong_ranks})
        args.weak_ranks = sorted({min(p, n) for p in args.weak_ranks})

    ncores = os.cpu_count() or 1
    warn_note = ""
    if args.platform == "multiproc":
        over = [p for p in args.strong_ranks + args.weak_ranks if p > ncores]
        if over:
            warn_note = (f"# WARNING: ranks {sorted(set(over))} exceed "
                         f"{ncores} cores — those rows measure "
                         "oversubscription, not scaling\n")
            print(warn_note.strip(), flush=True)
        # CPU-backend cross-process collectives ride TCP loopback (~ms per
        # exchange on a typical node) where MPI shared memory and NVLink
        # are ~us-scale: rows whose per-rank per-step compute is comparable
        # to that latency measure coordination latency, not scaling.
        warn_note += (
            "# NOTE: multiproc collectives ride TCP loopback (~ms); rows "
            "with small per-rank tiles are latency-dominated — compare "
            "per-rank work against perstep_time before reading speedup "
            "(large-tile sweeps measure bandwidth scaling instead)\n"
        )
    elif args.platform == "cpu":
        warn_note = ("# WARNING: virtual-mesh rows share one host's cores; "
                     "speedup/efficiency are NOT scaling evidence\n")

    os.makedirs(args.out_dir, exist_ok=True)
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    strong_csv = os.path.join(args.out_dir, f"strong_{ts}.csv")
    strong_annot = os.path.join(args.out_dir, f"strong_annotated_{ts}.csv")
    weak_csv = os.path.join(args.out_dir, f"weak_{ts}.csv")

    header = "platform,ranks,nx,ny,steps,total_time,perstep_time"
    plat = args.platform

    rows = []
    for p in args.strong_ranks:
        print(f"== strong: p={p} ==", flush=True)
        total, perstep = run_one(
            p, args.strong_nx, args.strong_ny, args.steps, args.platform, args.extra
        )
        rows.append((p, args.strong_nx, args.strong_ny, args.steps, total, perstep))
    with open(strong_csv, "w") as f:
        f.write(f"# strong scaling: Nx={args.strong_nx}, Ny={args.strong_ny}, "
                f"steps={args.steps}\n{warn_note}{header}\n")
        for r in rows:
            f.write(plat + "," + ",".join(str(v) for v in r) + "\n")
    ann, p0 = annotate_strong(rows)
    with open(strong_annot, "w") as f:
        f.write(f"# strong scaling: Nx={args.strong_nx}, Ny={args.strong_ny}, "
                f"steps={args.steps}\n{warn_note}")
        if p0 != 1:
            f.write(f"# NOTE: sweep has no p=1 row; T1 extrapolated as "
                    f"{p0}*T_{p0} (ideal-linear baseline at p={p0})\n")
        f.write(f"{header},speedup,efficiency,karp_flatt\n")
        for r in ann:
            f.write(plat + "," + ",".join(str(v) for v in r) + "\n")
    print(f"Annotated strong-scaling results written to {strong_annot}")

    if not args.skip_weak:
        with open(weak_csv, "w") as f:
            f.write(f"# weak scaling: tile={args.weak_tile_nx}x{args.weak_tile_ny}, "
                    f"steps={args.steps}\n{warn_note}{header},weak_efficiency\n")
            t1 = None
            for p in args.weak_ranks:
                k = math.ceil(math.sqrt(p))
                nx, ny = args.weak_tile_nx * k, args.weak_tile_ny * k
                print(f"== weak: p={p}, Nx={nx}, Ny={ny} ==", flush=True)
                total, perstep = run_one(p, nx, ny, args.steps, args.platform, args.extra)
                # E_w = T1/Tp at ~constant work per rank (ideal = 1).  The
                # sqrt-rounded grid can give rank p slightly more work per
                # rank than rank 1; normalize by the actual per-rank load.
                if t1 is None:
                    t1 = total * (args.weak_tile_nx * args.weak_tile_ny) / (nx * ny / p)
                ew = t1 * (nx * ny / p) / (args.weak_tile_nx * args.weak_tile_ny) / total
                f.write(f"{plat},{p},{nx},{ny},{args.steps},{total},{perstep},{ew}\n")

    print(f"\nWrote:\n  {strong_csv}\n  {strong_annot}")
    if not args.skip_weak:
        print(f"  {weak_csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
