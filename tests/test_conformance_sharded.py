"""Path conformance, the explicitly sharded per-step exchange: every BC class
on 1x2, 2x1, 2x2, 2x4, 4x2 and 8x1 virtual meshes against the independent
NumPy float64 oracle (reference analogue: test_halo.cpp and the MPI
integration tests, tests/CMakeLists.txt:10-17)."""

import numpy as np
import pytest

from pathcases import BC_CLASSES, SHARDED, make_cfg, oracle_for, run_path, seam_ic


@pytest.mark.parametrize("path", list(SHARDED))
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_path_matches_oracle(bc_class, path):
    """7 f64 steps with mass parked on every seam: exact to round-off."""
    cfg = make_cfg(bc_class)
    u0 = seam_ic(cfg.nx, cfg.ny)
    got, _ = run_path(cfg, path, u0, 7)
    np.testing.assert_allclose(got, oracle_for(cfg, u0, 7), rtol=0, atol=1e-12)
