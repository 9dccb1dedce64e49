"""Entry-point contracts: the package imports with nothing beyond numpy and
JAX, the compile cache lands where it should, and ``chip_smoke.py``'s
helpers (platform guard, comparison, last line) behave on the CPU."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_YAML = "import sys; sys.modules['yaml'] = None\n"


def _python(code, tmp_path, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=e, capture_output=True, text=True, timeout=300)


def test_import_without_pyyaml(tmp_path):
    r = _python(NO_YAML + f"sys.path.insert(0, {REPO!r})\n"
                "import climate_sim_tpu, climate_sim_tpu.runtime.cli\n"
                "print('IMPORT_OK')", tmp_path)
    assert r.returncode == 0, r.stderr
    assert "IMPORT_OK" in r.stdout


def test_dev_config_runs_without_pyyaml(tmp_path):
    """A full CPU run of configs/dev.yaml through the CLI, PyYAML blocked."""
    out = tmp_path / "o"
    r = _python(NO_YAML + f"sys.path.insert(0, {REPO!r})\n"
                "from climate_sim_tpu.runtime.cli import main\n"
                f"raise SystemExit(main(['--config={REPO}/configs/dev.yaml',"
                f" '--output.dir={out}']))", tmp_path,
                JAX_ENABLE_COMPILATION_CACHE="false")
    assert r.returncode == 0, r.stderr
    assert "timing: total_max=" in r.stdout
    assert (out / "dev.nc").exists()


def test_compile_cache_env_var_wins(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and the helper sets
    nothing."""
    cache = tmp_path / "jcache"
    r = _python(f"import sys; sys.path.insert(0, {REPO!r})\n"
                "import jax\n"
                "from climate_sim_tpu.runtime.compile_cache import enable_compile_cache\n"
                "print('HELPER', enable_compile_cache())\n"
                "print('JAX', jax.config.jax_compilation_cache_dir)\n",
                tmp_path, JAX_COMPILATION_CACHE_DIR=str(cache))
    assert r.returncode == 0, r.stderr
    assert f"HELPER {cache}" in r.stdout and f"JAX {cache}" in r.stdout


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    from climate_sim_tpu.runtime import compile_cache as cc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = cc.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert cc.enable_compile_cache() == got  # the same on every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


def test_platform_guard_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.gpu_devices()
    assert e.value.code not in (0, None)


def test_smoke_refuses_to_run_on_cpu():
    """The script itself exits non-zero and prints no result line."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_result_line_format():
    line = chip_smoke.result_line("NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
    assert "\n" not in line


@pytest.mark.parametrize("precision,err,ok", [
    ("f64", 1e-11, True), ("f64", 1e-9, False),
    ("f32", 5e-5, True), ("f32", 5e-4, False),
])
def test_compare_tolerances(precision, err, ok):
    want = np.linspace(0.0, 1.0, 64).reshape(8, 8)
    got = want.copy()
    got[3, 3] += err
    res = chip_smoke.compare(got, want, precision)
    assert res["ok"] is ok and res["metric"] == "rel_max"


def test_compare_bf16_envelope_and_shape_and_nan():
    from climate_sim_tpu.runtime.driver import BF16_ERR_PER_STEP

    want = np.ones((4, 4))
    got = want * (1 + 0.5 * BF16_ERR_PER_STEP * 10)
    assert chip_smoke.compare(got, want, "bf16", steps=10)["ok"]
    assert not chip_smoke.compare(want * 1.5, want, "bf16", steps=10)["ok"]
    assert not chip_smoke.compare(np.ones((4, 5)), want, "f32")["ok"]
    bad = want.copy()
    bad[0, 0] = np.nan
    assert not chip_smoke.compare(bad, want, "f64")["ok"]


def test_oracle_states_chain_exactly():
    """Chaining the oracle through intermediate step counts equals one run."""
    from oracle import gaussian_ic, run_oracle
    from pathcases import make_cfg

    cfg = make_cfg("one_sided_y_bottom", (24, 16))
    at = chip_smoke.oracle_states(cfg, [0, 3, 7])
    u0 = gaussian_ic(24, 16, cfg.dx, cfg.dy)
    whole = run_oracle(u0, 7, cfg.D, cfg.vx, cfg.vy, cfg.dt,
                       cfg.dx, cfg.dy, bc=tuple(b.value for b in cfg.bc.as_tuple()))
    np.testing.assert_array_equal(at[7], whole)
    np.testing.assert_array_equal(at[0], u0)


def test_single_gpu_phases_rehearsal_on_cpu(capsys):
    """Phases (a)-(e) at a tiny size on a CPU device: every check passes and
    the f32 run after the f64/bf16 runs is bit-identical."""
    smoke = chip_smoke.Smoke("cpu rehearsal")
    chip_smoke.single_gpu_phases(smoke, jax.devices(), "abcde", small=True)
    out = capsys.readouterr().out
    assert smoke.failures == []
    assert "check x64-toggle: ok" in out
    for phase in ("a-bench-f32", "b-bench-f64", "c-bench-bf16", "d-reference-dev",
                  "e-misaligned"):
        assert f"rate {phase}" in out


def test_four_gpu_phases_rehearsal_on_cpu(capsys):
    """The --four-gpus phases on four virtual CPU devices: 2x2 sharded and
    padded GSPMD runs agree with the one-device run and the oracle."""
    smoke = chip_smoke.Smoke("cpu rehearsal")
    chip_smoke.four_gpu_phases(smoke, jax.devices()[:4], small=True)
    out = capsys.readouterr().out
    assert smoke.failures == []
    assert "padded GSPMD" in out and "m-2x2-padded-gspmd/vs-card0: ok" in out
