#!/usr/bin/env python3
"""On-card smoke test of the solver's main path.

Drives ``runtime.driver.run_simulation`` on one NVIDIA GPU, at the sizes of
the repo's own deployments, and checks every result against the independent
NumPy float64 oracle (``tests/oracle.py``):

  (a) ``configs/bench_4096.yaml`` in f32, snapshots written and read back;
  (b) the same in f64;  (c) the same in bf16;
  (d) the reference's ``dev.yaml`` deployment (512², one-sided periodic,
      snapshots every 100 steps) for its full 1000 steps;
  (e) a misaligned 2500² grid;
  and a check that f32 after the f64 and bf16 runs (which flip
  ``jax_enable_x64`` in this process) is bit-identical to the first f32 run.

Each phase also prints its rate, excluding compilation, beside the card's
name and power limit.  ``--four-gpus`` runs only the sharded paths on four
GPUs (a 2x2 mesh at 4096² in f32 and f64, the dev.yaml BC mix on 2x2, and a
4097² grid that takes the padded GSPMD path), each compared with the
single-GPU run on card 0 and with the oracle.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed.  Without a GPU the script exits
non-zero before running anything.

    python chip_smoke.py                 # phases (a)-(e) on one GPU
    python chip_smoke.py --phases b,c    # a subset, e.g. in separate processes
    python chip_smoke.py --four-gpus     # the sharded paths on four GPUs
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "outputs", "chip_smoke")

# Tolerances against the float64 oracle.  The step has no matrix product, so
# TF32 never applies; the differences come from FMA contraction, operation
# order and the storage precision.
F64_REL_MAX = 1e-10  # f64 storage: round-off of ~1e-16 per operation
F32_REL_MAX = 1e-4   # f32 storage: ~6e-8 rounding per step, 1000 steps at most
SHARDED_REL_MAX = {"f64": 1e-12, "f32": 1e-5}  # sharded vs one card: same
# arithmetic per point, fused differently (FMA contraction may differ)
# bf16 storage rounds once per step (2^-9 relative): its relative L2 error
# must stay inside the driver's advisory envelope, BF16_ERR_PER_STEP * steps,
# on top of the IC's own rounding to bf16.
BF16_IC_ROUNDING = 2.0 ** -8


def gpu_devices(n: int = 1):
    """The first ``n`` GPUs JAX sees; exits non-zero when there are fewer or
    when JAX's devices are not GPUs.  Never falls back to the CPU."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: no GPU visible to JAX ({e})")
    if len(devs) < n or any(d.platform != "gpu" for d in devs):
        raise SystemExit(
            f"chip_smoke: need {n} GPU(s), JAX sees {[d.platform for d in devs]}"
        )
    return devs[:n]


def card_lines() -> list:
    """``nvidia-smi``'s name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def compare(got, want, precision: str, steps: int = 0) -> dict:
    """Compare a field with the oracle under ``precision``'s tolerance.

    Returns the relative max-norm and L2 errors, the bound that applies and
    whether the field is finite, of the oracle's shape and inside it."""
    from climate_sim_tpu.runtime.driver import BF16_ERR_PER_STEP

    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    res = {"shape_ok": g.shape == w.shape, "finite": bool(np.isfinite(g).all())}
    if not res["shape_ok"]:
        res.update(ok=False, rel_max=float("inf"), rel_l2=float("inf"))
        return res
    d = g - w
    res["rel_max"] = float(np.abs(d).max() / max(np.abs(w).max(), 1e-300))
    res["rel_l2"] = float(np.linalg.norm(d) / max(np.linalg.norm(w), 1e-300))
    if precision == "bf16":
        res["metric"] = "rel_l2"
        res["bound"] = BF16_IC_ROUNDING + BF16_ERR_PER_STEP * steps
    else:
        res["metric"] = "rel_max"
        res["bound"] = F64_REL_MAX if precision == "f64" else F32_REL_MAX
    res["ok"] = res["finite"] and res[res["metric"]] <= res["bound"]
    return res


def result_line(device_kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": device_kind, "count": count}}
    )


def _oracle_bcs(cfg):
    from climate_sim_tpu.config import bc_to_string

    return tuple(bc_to_string(b) for b in cfg.bc.as_tuple())


def oracle_states(cfg, steps):
    """Oracle fields at each step count in ``steps`` (ascending), chained from
    the reference's Gaussian IC.  Every side's ghosts are rewritten each step,
    so restarting the oracle from the interior is exact."""
    from oracle import gaussian_ic, run_oracle

    u = gaussian_ic(cfg.nx, cfg.ny, cfg.dx, cfg.dy, cfg.ic.A, cfg.ic.sigma_frac,
                    cfg.ic.xc_frac, cfg.ic.yc_frac)
    mode = "compat" if cfg.strict_reference_compat else "wrap"
    out, done = {}, 0
    for s in steps:
        u = run_oracle(u, s - done, cfg.D, cfg.vx, cfg.vy, cfg.dt, cfg.dx, cfg.dy,
                       bc=_oracle_bcs(cfg), periodic_mode=mode)
        done = s
        out[s] = u
    return out


def field_hash(u) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(u)).tobytes()).hexdigest()[:16]


class Smoke:
    """Runs phases, collects failures, prints one line per check."""

    def __init__(self, card: str):
        self.card = card
        self.failures = []

    def check(self, name: str, res: dict) -> None:
        tag = "ok" if res["ok"] else "FAIL"
        if not res["ok"]:
            self.failures.append(name)
        print(f"check {name}: {tag} rel_max={res['rel_max']:.3e}"
              f" rel_l2={res['rel_l2']:.3e} ({res.get('metric', '')}"
              f" bound {res.get('bound', float('nan')):.1e})", flush=True)

    def rate(self, name: str, cfg, res, n_dev: int = 1) -> float:
        """Print the driver's rate (compile excluded) and, on a GPU, its
        share of the device-memory bound."""
        from climate_sim_tpu.benchproto import bytes_per_point_step, hbm_bandwidth

        gpts = cfg.nx * cfg.ny * cfg.steps / res.total_time / 1e9
        bpp = bytes_per_point_step(res.u.dtype.itemsize)
        line = (f"rate {name}: {gpts:.3f} Gpoint/s over {n_dev} device(s),"
                f" {cfg.steps} steps in {res.total_time:.4f} s"
                f" (compile {res.compile_time:.2f} s excluded)")
        if res.devices[0].platform == "gpu":  # an unknown GPU kind raises
            bw = hbm_bandwidth(res.devices[0].device_kind)
            share = gpts * 1e9 / n_dev * bpp / bw
            line += (f"; {bpp} B/pt/step -> {100 * share:.1f}% of"
                     f" {bw / 1e12:.2f} TB/s per device")
        print(f"{line} [card: {self.card}]", flush=True)
        return gpts

    def validate(self, name: str, cfg, devices, oracle_at) -> object:
        """One run with snapshots; every record and the final state are
        compared with the oracle.  Returns the RunResult."""
        from climate_sim_tpu.io.netcdf import NetCDFFile
        from climate_sim_tpu.runtime.driver import run_simulation

        out = os.path.join(OUT_DIR, name)
        shutil.rmtree(out, ignore_errors=True)
        cfg = dataclasses.replace(cfg, output_dir=out, output_enable=True)
        res = run_simulation(cfg, devices=devices)
        with NetCDFFile(res.output_path) as ds:
            n_rec = ds.dimensions["time"]
            want_rec = -(-cfg.steps // cfg.out_every)
            if n_rec != want_rec:
                self.failures.append(f"{name}/records")
                print(f"check {name}/records: FAIL {n_rec} != {want_rec}", flush=True)
            for i in range(n_rec):
                step = i * cfg.out_every
                self.check(f"{name}/snapshot@{step}",
                           compare(ds.variables["u"][i, :, :], oracle_at[step],
                                   cfg.precision, step))
        self.check(f"{name}/final@{cfg.steps}",
                   compare(res.u, oracle_at[cfg.steps], cfg.precision, cfg.steps))
        shutil.rmtree(out, ignore_errors=True)
        self.rate(f"{name} (end to end, snapshots included)", cfg, res,
                  len(res.devices))
        print(f"hash {name}: {field_hash(res.u)}", flush=True)
        return res

    def timed(self, name: str, cfg, devices, steps: int) -> object:
        """A run with snapshots off: the device rate of the step loop."""
        from climate_sim_tpu.runtime.driver import run_simulation

        cfg = dataclasses.replace(cfg, steps=steps, output_enable=False)
        res = run_simulation(cfg, devices=devices)
        self.rate(f"{name} (steady, no snapshots)", cfg, res, len(res.devices))
        return res

    def agree(self, name: str, got, want, precision: str) -> None:
        """A sharded result against the one-card result."""
        g = np.asarray(got, np.float64)
        w = np.asarray(want, np.float64)
        rel = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
        res = {"ok": bool(g.shape == w.shape and np.isfinite(g).all()
                          and rel <= SHARDED_REL_MAX[precision]),
               "rel_max": rel, "rel_l2": float(np.linalg.norm(g - w) / np.linalg.norm(w)),
               "metric": "rel_max vs one card", "bound": SHARDED_REL_MAX[precision]}
        self.check(name, res)


def phase_configs(small: bool = False) -> dict:
    """The phases' configurations.  ``small`` shrinks grids and step counts
    for a rehearsal on CPU devices; the shapes of the checks stay the same."""
    from climate_sim_tpu.config import load_yaml_file

    bench = load_yaml_file(os.path.join(REPO, "configs", "bench_4096.yaml"))
    dev = load_yaml_file(os.path.join(REPO, "tests", "fixtures", "reference_dev.yaml"))
    n4096, n2500, n4097, steps, every, timing = 4096, 2500, 4097, 100, 50, 1000
    dev_steps = dev.steps
    if small:
        n4096, n2500, n4097, steps, every, timing = 64, 50, 65, 6, 3, 12
        dev = dataclasses.replace(dev, nx=48, ny=48)
        dev_steps = 20
    bench = dataclasses.replace(bench, nx=n4096, ny=n4096, steps=steps, out_every=every)
    return {
        "bench": bench,
        "dev": dataclasses.replace(dev, steps=dev_steps,
                                   out_every=min(dev.out_every, dev_steps // 2)),
        "misaligned": dataclasses.replace(bench, nx=n2500, ny=n2500),
        "indivisible": dataclasses.replace(bench, nx=n4097, ny=n4097),
        "timing_steps": timing,
        "bf16_check_steps": min(100, dev_steps),
    }


def single_gpu_phases(smoke: Smoke, devices, phases: str, small: bool = False) -> None:
    """Phases (a)-(e) through run_simulation on ``devices[0]`` alone."""
    P = phase_configs(small)
    one = list(devices[:1])
    bench = dataclasses.replace(P["bench"], max_devices=1)
    oracle = {}

    def bench_oracle():
        if "bench" not in oracle:
            oracle["bench"] = oracle_states(
                bench, sorted({0, bench.out_every, bench.steps}))
        return oracle["bench"]

    first_f32 = None
    for key, prec in (("a", "f32"), ("b", "f64"), ("c", "bf16")):
        if key in phases:
            cfg = dataclasses.replace(bench, precision=prec)
            res = smoke.validate(f"{key}-bench-{prec}", cfg, one, bench_oracle())
            if prec == "f32":
                first_f32 = field_hash(res.u)
            smoke.timed(f"{key}-bench-{prec}", cfg, one, P["timing_steps"])
    if first_f32 is not None and ("b" in phases or "c" in phases):
        # f32 again after runs that flipped jax_enable_x64 in this process.
        cfg = dataclasses.replace(bench, precision="f32")
        again = smoke.validate("x64-toggle-f32-again", cfg, one, bench_oracle())
        same = field_hash(again.u) == first_f32
        if not same:
            smoke.failures.append("x64-toggle")
        print(f"check x64-toggle: {'ok' if same else 'FAIL'} (f32 after f64 and"
              " bf16 is bit-identical to the first f32 run)", flush=True)
    if "d" in phases:
        dev = dataclasses.replace(P["dev"], max_devices=1)
        at = oracle_states(dev, list(range(0, dev.steps + 1, dev.out_every)))
        smoke.validate("d-reference-dev", dev, one, at)
        # bf16 on the same deployment: the rate the driver's advisory uses.
        n = P["bf16_check_steps"]
        b16 = dataclasses.replace(dev, precision="bf16", steps=n, out_every=n)
        smoke.validate("d-reference-dev-bf16", b16, one, {0: at[0], n: at[n]})
    if "e" in phases:
        mis = dataclasses.replace(P["misaligned"], max_devices=1)
        at = oracle_states(mis, sorted({0, mis.out_every, mis.steps}))
        smoke.validate("e-misaligned", mis, one, at)
        smoke.timed("e-misaligned", mis, one, P["timing_steps"])


def four_gpu_phases(smoke: Smoke, devices, small: bool = False) -> None:
    """The sharded paths on a 2x2 mesh, each against card 0 and the oracle."""
    from climate_sim_tpu.runtime.driver import run_simulation

    P = phase_configs(small)
    four, one = list(devices[:4]), list(devices[:1])
    # 40 steps keep the two ~16.8M-point oracles to about a minute of host
    # time while four cards wait; the card-0 comparison covers the same run.
    for key in ("bench", "indivisible"):
        c = P[key]
        P[key] = dataclasses.replace(c, steps=min(c.steps, 40),
                                     out_every=min(c.out_every, 20))

    def mesh2x2(cfg):
        c = dataclasses.replace(cfg, max_devices=4)
        c.mesh = dataclasses.replace(c.mesh, x=2, y=2)
        return c

    def single(cfg):
        c = dataclasses.replace(cfg, max_devices=1, output_enable=False)
        return run_simulation(c, devices=one)

    bench = P["bench"]
    at = oracle_states(bench, sorted({0, bench.out_every, bench.steps}))
    for prec in ("f32", "f64"):
        cfg = mesh2x2(dataclasses.replace(bench, precision=prec))
        res = smoke.validate(f"m-2x2-bench-{prec}", cfg, four, at)
        smoke.agree(f"m-2x2-bench-{prec}/vs-card0", res.u, single(cfg).u, prec)
        smoke.timed(f"m-2x2-bench-{prec}", cfg, four, P["timing_steps"])
        smoke.timed(f"m-card0-bench-{prec}", dataclasses.replace(cfg, max_devices=1),
                    one, P["timing_steps"])
    dev = mesh2x2(P["dev"])
    at = oracle_states(dev, list(range(0, dev.steps + 1, dev.out_every)))
    res = smoke.validate("m-2x2-reference-dev", dev, four, at)
    smoke.agree("m-2x2-reference-dev/vs-card0", res.u, single(dev).u, "f32")
    ind = mesh2x2(P["indivisible"])
    at = oracle_states(ind, sorted({0, ind.out_every, ind.steps}))
    res = smoke.validate("m-2x2-padded-gspmd", ind, four, at)
    smoke.agree("m-2x2-padded-gspmd/vs-card0", res.u, single(ind).u, "f32")
    smoke.timed("m-2x2-padded-gspmd", ind, four, P["timing_steps"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded paths on four GPUs")
    ap.add_argument("--phases", default="abcde",
                    help="subset of the single-GPU phases a-e (default: all)")
    args = ap.parse_args(argv)

    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from climate_sim_tpu.runtime.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    import jax

    n = 4 if args.four_gpus else 1
    devices = gpu_devices(n)
    cards = card_lines()
    for ln in cards:
        print(f"card: {ln}", flush=True)
    print(f"jax {jax.__version__}: {len(jax.devices())} x {devices[0].device_kind};"
          f" compile cache {cache}", flush=True)

    smoke = Smoke(cards[0])
    if args.four_gpus:
        four_gpu_phases(smoke, devices)
    else:
        single_gpu_phases(smoke, devices, args.phases.replace(",", ""))
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    if smoke.failures:
        print(f"chip_smoke: FAILED {smoke.failures}", file=sys.stderr, flush=True)
        return 1
    print(cards[0], flush=True)
    print(result_line(devices[0].device_kind, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
