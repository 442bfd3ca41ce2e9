"""CI guard on the multi-process throughput shape (round-5 measurement).

tools/scale_procs.py measured the cross-process ratio (same mesh work, two
gloo-connected processes vs one) at 0.79-0.80 for the default GSPMD
runner.  This slow test keeps the capability from silently regressing:
one layout, one runner, and a CONSERVATIVE floor — the ratio on a loaded
CI host wobbles, but a collapse toward zero (a new per-step host sync, a
collective moved into the inner loop) is exactly what it must catch.
"""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.slow
def test_two_process_gspmd_ratio_floor():
    env = dict(os.environ, SCALE_LAYOUTS="8x1", SCALE_RUNNERS="gspmd")
    sys.path.insert(0, str(ROOT / "tools"))
    # fresh import under the trimmed matrix (module reads env at import)
    import importlib
    import scale_procs
    importlib.reload(scale_procs)
    single = scale_procs.launch(1)
    double = scale_procs.launch(2)
    k = ("8x1", "gspmd")
    assert k in single and k in double, (single, double)
    ratio = double[k] / single[k]
    # measured 0.79 on a quiet host; 0.45 floor leaves room for CI load
    # while still catching structural regressions (per-step boundary
    # crossings would land well below it — the shardmap runner's
    # always-swap measured 0.63 as the nearest real data point)
    assert ratio > 0.45, \
        f"2-process/1-process steps/s ratio collapsed: {ratio:.3f} " \
        f"({double[k]} vs {single[k]})"
