"""The knee rule of ``sweep.py``: every rate at and below the knee keeps its
waiting line and its median TTFT under twice the lowest rate's, on every
seed."""

import importlib.util
import sys
from pathlib import Path

import pytest

spec = importlib.util.spec_from_file_location(
    "portbench_sweep", Path(__file__).resolve().parents[1] / "sweep.py")
sweep = importlib.util.module_from_spec(spec)
_path = list(sys.path)
spec.loader.exec_module(sweep)  # a command line: it sets its own sys.path[0]
sys.path[:] = _path


def _row(rate, seed, b0, b1, p50):
    return {"rate": rate, "seed": seed, "backlog_start": b0, "backlog_end": b1,
            "ttft_p50_ms": p50}


@pytest.mark.parametrize("rows,knee", [
    # a line that stands shows in the median before the backlog's two readings
    ([_row(7.5, 1, 2, 3, 76), _row(8.0, 1, 2, 1, 88), _row(8.5, 1, 2, 1, 550),
      _row(9.0, 1, 2, 2, 976)], 8.0),
    # a rate failed on one seed fails the knee, whatever the rates above read
    ([_row(4.0, 2, 0, 0, 140), _row(4.0, 3, 0, 1, 124), _row(4.5, 2, 0, 0, 169),
      _row(4.5, 3, 0, 4, 130), _row(5.0, 2, 0, 0, 177), _row(5.0, 3, 0, 1, 222)], 4.0),
    ([_row(4.0, 2, 3, 9, 140)], None),
])
def test_knee_is_the_last_rate_sustained_everywhere_below(rows, knee):
    assert sweep.judge(rows) == knee
