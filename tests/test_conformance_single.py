"""Path conformance, one device and the GSPMD paths: every BC class against
the independent NumPy float64 oracle (tests/oracle.py) — the spec the
removed Pallas kernels' BC-fixup tests held, now held by the paths that
remain (reference analogue: the exact-stencil unit tests,
tests/simulation/unit/test_diffusion.cpp, test_advection.cpp)."""

import numpy as np
import pytest

from pathcases import BC_CLASSES, DEFAULT_GRID, GRIDS, make_cfg, oracle_for, run_path, seam_ic


@pytest.mark.parametrize("path", ["single", "partial_gspmd", "padded_gspmd"])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_path_matches_oracle(bc_class, path):
    """7 f64 steps with mass parked on every seam: exact to round-off."""
    grid = GRIDS.get(path, DEFAULT_GRID)
    cfg = make_cfg(bc_class, grid)
    u0 = seam_ic(*grid)
    got, _ = run_path(cfg, path, u0, 7)
    np.testing.assert_allclose(got, oracle_for(cfg, u0, 7), rtol=0, atol=1e-12)
