"""The one-line stdout summary a benchmark ends with (counterpart of
vtpu/obs/summary.py, the port's own copy).

Driver artifacts that truncate long stdout or parse only the last line
still get a self-contained headline: ``{"summary": true, "metric": ...,
"value": ..., "verdict": ...}`` as the FINAL stdout line, built by this one
helper for every benchmark of the port.
"""

from __future__ import annotations

import json
from typing import Optional


def summary_line(metric: str, value, verdict: str, unit: Optional[str] = None,
                 ci95=None, **extra) -> str:
    """The compact headline record as a JSON string. Key order is part of
    the convention: summary flag first, then metric/value/unit/ci95/
    verdict, then any bench-specific extras. ``unit``/``ci95`` are omitted
    when None (not every bench has them); extras keep caller order."""
    rec: dict = {"summary": True, "metric": metric, "value": value}
    if unit is not None:
        rec["unit"] = unit
    if ci95 is not None:
        rec["ci95"] = list(ci95)
    rec["verdict"] = verdict
    rec.update(extra)
    return json.dumps(rec)


def print_summary(metric: str, value, verdict: str,
                  unit: Optional[str] = None, ci95=None, **extra) -> None:
    """Print the headline as the (intended-final) stdout line — callers
    must not print to stdout after this."""
    print(summary_line(metric, value, verdict, unit=unit, ci95=ci95, **extra),
          flush=True)
