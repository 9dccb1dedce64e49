"""True multi-controller test: two coordinated CPU processes (4 virtual
devices each -> one 8-device global mesh) run the driver end-to-end via
``jax.distributed``, exercising process_allgather snapshot gathers,
controller-gated logging/IO, and the MAX-over-hosts timing reduction —
the closest single-machine analogue of a 2-host run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys
proc_id = int(sys.argv[1])
port = sys.argv[2]
out = sys.argv[3]
nproc = int(sys.argv[4]) if len(sys.argv) > 4 else 2
ic_path = sys.argv[5] if len(sys.argv) > 5 else ""
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from climate_sim_tpu.config import merged_config
from climate_sim_tpu.runtime.driver import run_simulation

# Parallel-IO contract (reference io.cpp:402-424 analogue): no process may
# gather the global field -- only tiny scalar reductions are allowed through
# process_allgather (timing MAX, sync barriers).
from jax.experimental import multihost_utils as _mhu
import numpy as _np
_orig_allgather = _mhu.process_allgather
def _guarded_allgather(x, tiled=False):
    if _np.size(x) > 16:
        raise RuntimeError("BIG_ALLGATHER: %s" % (_np.shape(x),))
    return _orig_allgather(x, tiled=tiled)
_mhu.process_allgather = _guarded_allgather

argv = [
    "--nx=128", "--ny=64", "--steps=8", "--out_every=4",
    "--output.dir=" + out,
    "--distributed=127.0.0.1:" + port + "," + str(nproc) + "," + str(proc_id),
]
if ic_path:
    argv += ["--ic.mode=file", "--ic.path=" + ic_path]
argv += sys.argv[6:]  # per-test overrides (later flags win in merged_config)
cfg = merged_config(None, argv)
res = run_simulation(cfg)
print("MH_OK", proc_id, jax.process_count(), len(jax.devices()), flush=True)
""".format(repo=REPO)


def free_port():
    # TOCTOU caveat: the port could be claimed between close() and the
    # coordinator's bind; SO_REUSEADDR plus the retry in the test body
    # keeps the flake window negligible.
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_group(port, out, nproc=2, ic_path="", extra_args=()):
    extra = [str(nproc), ic_path, *extra_args] if (ic_path or extra_args) \
        else [str(nproc)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(i), port, out, *extra],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(nproc)
    ]
    return procs, [p.communicate(timeout=300)[0] for p in procs]


def _spawn_pair(port, out):
    return _spawn_group(port, out, nproc=2)


@pytest.mark.slow
def test_two_process_run_matches_single(tmp_path):
    out = str(tmp_path / "mh")
    for attempt in range(2):  # retry once on a lost port race
        procs, outs = _spawn_pair(str(free_port()), out)
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o[-3000:]}"
        assert f"MH_OK {i} 2 8" in o
    # Controller gating: only process 0 logs the banner/timing.
    assert "timing: total_max=" in outs[0]
    assert "timing: total_max=" not in outs[1]

    # Output parity with a plain single-process run of the same config.
    from climate_sim_tpu.config import merged_config
    from climate_sim_tpu.io.netcdf import NetCDFFile
    from climate_sim_tpu.runtime.driver import run_simulation

    ref_out = str(tmp_path / "single")
    cfg = merged_config(None, [
        "--nx=128", "--ny=64", "--steps=8", "--out_every=4",
        f"--output.dir={ref_out}",
    ])
    run_simulation(cfg)

    with NetCDFFile(os.path.join(out, "snapshots.nc")) as a, \
            NetCDFFile(os.path.join(ref_out, "snapshots.nc")) as b:
        assert a.dimensions == b.dimensions
        for t in range(a.dimensions["time"]):
            np.testing.assert_allclose(
                a.variables["u"][t, :, :], b.variables["u"][t, :, :], atol=1e-6
            )

    # Parallel-write contract: the two-process hyperslab-written file is
    # byte-identical to the single-process whole-record file, and the worker
    # guard above guarantees no process ever allgathered the global field
    # (a BIG_ALLGATHER raise would have failed the returncode asserts).
    mh_bytes = open(os.path.join(out, "snapshots.nc"), "rb").read()
    single_bytes = open(os.path.join(ref_out, "snapshots.nc"), "rb").read()
    assert mh_bytes == single_bytes


@pytest.mark.slow
def test_four_process_run_and_restart(tmp_path):
    """The reference's standard test scale (mpirun -np 4,
    tests/CMakeLists.txt:48-55): four coordinated controllers forming one
    16-device mesh split in BOTH axes, so the hyperslab snapshot writes are
    x-fragmented (non-contiguous per record) — a structurally different
    write pattern than the 2-process y-split.  Then a second 4-process run
    restarts from the written file (``ic.mode=file``), exercising
    shard-local region reads under the same no-global-allgather guard."""
    out = str(tmp_path / "mh4")
    for attempt in range(2):  # retry once on a lost port race
        procs, outs = _spawn_group(str(free_port()), out, nproc=4)
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o[-3000:]}"
        assert f"MH_OK {i} 4 16" in o
    assert "timing: total_max=" in outs[0]
    for o in outs[1:]:
        assert "timing: total_max=" not in o

    from climate_sim_tpu.config import merged_config
    from climate_sim_tpu.runtime.driver import run_simulation

    ref_out = str(tmp_path / "single4")
    cfg = merged_config(None, [
        "--nx=128", "--ny=64", "--steps=8", "--out_every=4",
        f"--output.dir={ref_out}",
    ])
    run_simulation(cfg)

    snap = os.path.join(out, "snapshots.nc")
    assert open(snap, "rb").read() == \
        open(os.path.join(ref_out, "snapshots.nc"), "rb").read()

    # Restart leg: 4 processes re-read the last record of the 4-written
    # file as the IC (each touching only its shard's regions) and advance.
    out2 = str(tmp_path / "mh4_restart")
    for attempt in range(2):
        procs2, outs2 = _spawn_group(str(free_port()), out2, nproc=4, ic_path=snap)
        if all(p.returncode == 0 for p in procs2) or attempt == 1:
            break
    for i, (p, o) in enumerate(zip(procs2, outs2)):
        assert p.returncode == 0, f"restart proc {i} failed:\n{o[-3000:]}"

    ref_out2 = str(tmp_path / "single4_restart")
    cfg2 = merged_config(None, [
        "--nx=128", "--ny=64", "--steps=8", "--out_every=4",
        f"--output.dir={ref_out2}",
        "--ic.mode=file", f"--ic.path={snap}",
    ])
    run_simulation(cfg2)
    assert open(os.path.join(out2, "snapshots.nc"), "rb").read() == \
        open(os.path.join(ref_out2, "snapshots.nc"), "rb").read()


KILL_WORKER = """
import os, sys
proc_id = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
# Hard-kill the WHOLE 4-process job right after the step-8 snapshot
# (record 2) reaches the kernel (sync flushes user-space buffers; numrecs
# is header-patched per append, so the file is complete up to that
# record).  os._exit skips every destructor/atexit — the closest
# single-machine analogue of the scheduler killing the job mid-run.
import climate_sim_tpu.io.snapshots as snaps
_orig = snaps.ShardedSnapshotWriter.write_shards
def _kill_after_record_2(self, u, step_index=None):
    idx = _orig(self, u, step_index)
    if idx >= 2:
        self.sync()
        print("MH_KILLED_AT", idx, flush=True)
        os._exit(137)
    return idx
snaps.ShardedSnapshotWriter.write_shards = _kill_after_record_2
from climate_sim_tpu.config import merged_config
from climate_sim_tpu.runtime.driver import run_simulation
cfg = merged_config(None, [
    "--nx=128", "--ny=64", "--steps=16", "--out_every=4",
    "--output.dir=" + out,
    "--distributed=127.0.0.1:" + port + ",4," + str(proc_id),
])
run_simulation(cfg)
print("MH_UNEXPECTED_OK", proc_id, flush=True)
""".format(repo=REPO)


@pytest.mark.slow
def test_four_process_kill_mid_run_then_restart(tmp_path):
    """Checkpoint/resume under FAILURE, end-to-end: a 4-process run is
    hard-killed (os._exit, no close/atexit) right after flushing the
    step-8 snapshot; the surviving file must be readable with exactly the
    3 completed records (numrecs is header-patched per append), and a
    4-process restart from its LAST record must reproduce the
    uninterrupted 16-step run's remaining snapshots EXACTLY.  The restart
    keeps out_every=4, so its chunk boundaries align with the original
    run's (snapshots are f64 of an f32 field — the round-trip is exact —
    and the step is grouping-invariant, so equality is bitwise)."""
    out = str(tmp_path / "mh4_kill")
    port = str(free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", KILL_WORKER, str(i), port, out],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(4)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 137, f"proc {i} exit {p.returncode}:\n{o[-2000:]}"
        assert "MH_KILLED_AT 2" in o
        assert "MH_UNEXPECTED_OK" not in o

    from climate_sim_tpu.config import merged_config
    from climate_sim_tpu.io.netcdf import NetCDFFile
    from climate_sim_tpu.runtime.driver import run_simulation

    snap = os.path.join(out, "snapshots.nc")
    with NetCDFFile(snap) as ds:
        # complete up to the kill point: records for steps 0, 4, 8
        assert ds.dimensions["time"] == 3

    # Uninterrupted 16-step run (single-process; multi==single parity is
    # proven byte-level by test_four_process_run_and_restart).
    ref_out = str(tmp_path / "uninterrupted")
    run_simulation(merged_config(None, [
        "--nx=128", "--ny=64", "--steps=16", "--out_every=4",
        f"--output.dir={ref_out}",
    ]))

    # Restart-from-last-record leg: 4 processes resume at step 8 and run
    # the remaining 8 steps at the same cadence.
    out2 = str(tmp_path / "mh4_resume")
    extra = ("--steps=8",)
    for attempt in range(2):
        procs2, outs2 = _spawn_group(str(free_port()), out2, nproc=4,
                                     ic_path=snap, extra_args=extra)
        if all(p.returncode == 0 for p in procs2) or attempt == 1:
            break
    for i, (p, o) in enumerate(zip(procs2, outs2)):
        assert p.returncode == 0, f"resume proc {i} failed:\n{o[-3000:]}"

    with NetCDFFile(os.path.join(out2, "snapshots.nc")) as r, \
            NetCDFFile(os.path.join(ref_out, "snapshots.nc")) as f:
        assert r.dimensions["time"] == 2  # steps 8, 12 of the global run
        assert f.dimensions["time"] == 4
        for t in range(2):
            np.testing.assert_array_equal(
                r.variables["u"][t, :, :], f.variables["u"][2 + t, :, :]
            )


@pytest.mark.slow
def test_two_process_scheduled_kernel_matches_oracle(tmp_path):
    """The one-sided-periodic sharded path under TRUE multi-controller
    execution: two coordinated processes form one 8-device mesh and run a
    BOTH-axes one-sided-periodic config — wrap delivery via both cyclic
    exchanges inside a process-spanning shard_map.  Output is compared to
    the in-process oracle."""
    extra = (
        "--nx=512", "--ny=128", "--steps=19", "--out_every=19",
        "--write_final=true",
        "--bc.left=periodic", "--bc.right=dirichlet",
        "--bc.bottom=periodic", "--bc.top=neumann",
    )
    out = str(tmp_path / "mh_sched")
    for attempt in range(2):  # retry once on a lost port race
        procs, outs = _spawn_group(str(free_port()), out, extra_args=extra)
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o[-3000:]}"
        assert f"MH_OK {i} 2 8" in o

    import jax.numpy as jnp

    from climate_sim_tpu.config import merged_config
    from climate_sim_tpu.io.netcdf import NetCDFFile
    from climate_sim_tpu.ops import gaussian_hotspot
    from climate_sim_tpu.ops.step import reference_step

    cfg = merged_config(None, list(extra))
    u = gaussian_hotspot(cfg, jnp.float32)
    for _ in range(19):
        u = reference_step(u, cfg, cfg.dt)
    with NetCDFFile(os.path.join(out, "snapshots.nc")) as ds:
        got = ds.variables["u"][-1, :, :]
    np.testing.assert_allclose(got, np.asarray(u), atol=5e-5)


DEATH_WORKER = """
import os, sys
proc_id = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["CLIMATE_SIM_SYNC_TIMEOUT_S"] = "20"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
if proc_id == 0:
    # Simulate the controller dying at snapshot-file creation (disk full,
    # permissions, ...): the driver prints the real error and re-raises.
    import climate_sim_tpu.io.snapshots as snaps
    import climate_sim_tpu.runtime.driver as drv

    class Boom(snaps.ShardedSnapshotWriter):
        def __init__(self, *a, **kw):
            raise OSError(28, "No space left on device (simulated)")

    snaps.ShardedSnapshotWriter = Boom
    drv.ShardedSnapshotWriter = Boom
from climate_sim_tpu.config import merged_config
from climate_sim_tpu.runtime.driver import run_simulation
cfg = merged_config(None, [
    "--nx=128", "--ny=64", "--steps=4", "--out_every=2",
    "--output.dir=" + out,
    "--distributed=127.0.0.1:" + port + ",2," + str(proc_id),
])
try:
    run_simulation(cfg)
except BaseException as e:
    print("MH_ERR", proc_id, type(e).__name__, flush=True)
    # Skip the distributed-shutdown atexit: with the cluster in a failed
    # state it would wait for peers (the CLI path exits the interpreter the
    # same way after printing the error).
    os._exit(1)
print("MH_UNEXPECTED_OK", proc_id, flush=True)
""".format(repo=REPO)


@pytest.mark.slow
def test_controller_death_before_open_barrier_fails_peers(tmp_path):
    """Controller dies after (failing) snapshot creation, BEFORE the open
    barrier: the peer must ERROR OUT within the bounded barrier timeout —
    not hang forever in an untimed collective (the reference analogue:
    an MPI rank abort fails the job, it does not deadlock it).  Regression
    for the observed cluster-wide deadlock with the unbounded
    sync_global_devices barrier."""
    import time

    out = str(tmp_path / "mh")
    port = str(free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", DEATH_WORKER, str(i), port, out],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    t0 = time.time()
    outs = []
    for i, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
            pytest.fail(
                f"proc {i} still alive 120s after controller death "
                f"(unbounded barrier hang):\n{outs[-1][-2000:]}"
            )
    elapsed = time.time() - t0
    # Controller: real error surfaced (traceback + MH_ERR), nonzero exit.
    assert procs[0].returncode != 0
    assert "No space left on device (simulated)" in outs[0]
    assert "MH_ERR 0" in outs[0]
    # Peer: errored out (barrier timeout or leader-death detection), did
    # not run the simulation, wrote nothing.
    assert procs[1].returncode != 0
    assert "MH_UNEXPECTED_OK" not in outs[1]
    assert not os.path.exists(os.path.join(out, "snapshots.nc"))
    assert elapsed < 120


@pytest.mark.slow
def test_two_process_carrier_path(tmp_path):
    """Grid indivisible along both mesh axes under 2 coordinated
    processes: the padded GSPMD path runs SPMD across the 8-device global
    mesh, snapshots carry the true extent, and values match a
    single-process run."""
    out = str(tmp_path / "mh")
    extra = ["--nx=1001", "--ny=73"]
    for attempt in range(2):
        procs, outs = _spawn_group(str(free_port()), out, nproc=2,
                                   extra_args=extra)
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o[-3000:]}"
    assert "padded GSPMD" in outs[0]

    from climate_sim_tpu.config import merged_config
    from climate_sim_tpu.io.netcdf import NetCDFFile
    from climate_sim_tpu.runtime.driver import run_simulation

    ref_out = str(tmp_path / "single")
    cfg = merged_config(None, [
        "--nx=1001", "--ny=73", "--steps=8", "--out_every=4",
        f"--output.dir={ref_out}",
    ])
    run_simulation(cfg)
    with NetCDFFile(os.path.join(out, "snapshots.nc")) as a, \
            NetCDFFile(os.path.join(ref_out, "snapshots.nc")) as b:
        assert a.dimensions == {"time": 2, "y": 73, "x": 1001}
        for t in range(2):
            np.testing.assert_allclose(
                a.variables["u"][t, :, :], b.variables["u"][t, :, :], atol=5e-5
            )


@pytest.mark.slow
def test_two_process_carrier_torus_staged_wrap(tmp_path):
    """A torus on a grid indivisible along both mesh axes under true
    multi-controller execution: the padded GSPMD path's wrap traffic
    crosses REAL cross-process collectives — the virtual mesh cannot catch
    transport-level ordering mistakes here.  Values must match a
    single-process run of the same config."""
    out = str(tmp_path / "mh_ct")
    extra = ["--nx=1001", "--ny=73",
             "--bc.left=periodic", "--bc.right=periodic",
             "--bc.bottom=periodic", "--bc.top=periodic"]
    for attempt in range(2):
        procs, outs = _spawn_group(str(free_port()), out, nproc=2,
                                   extra_args=extra)
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o[-3000:]}"
    assert "padded GSPMD" in outs[0]

    from climate_sim_tpu.config import merged_config
    from climate_sim_tpu.io.netcdf import NetCDFFile
    from climate_sim_tpu.runtime.driver import run_simulation

    ref_out = str(tmp_path / "single_ct")
    cfg = merged_config(None, [
        "--nx=1001", "--ny=73", "--steps=8", "--out_every=4",
        f"--output.dir={ref_out}",
        "--bc.left=periodic", "--bc.right=periodic",
        "--bc.bottom=periodic", "--bc.top=periodic",
    ])
    run_simulation(cfg)
    with NetCDFFile(os.path.join(out, "snapshots.nc")) as a, \
            NetCDFFile(os.path.join(ref_out, "snapshots.nc")) as b:
        for t in range(a.dimensions["time"]):
            np.testing.assert_allclose(
                a.variables["u"][t, :, :], b.variables["u"][t, :, :],
                atol=5e-5,
            )
