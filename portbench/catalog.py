"""Everything the harness finds by name: a cell in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its mix (``mixes/<name>.json``),
its own parameters (``cells/<workload>.json``: the open loop's rate, the
requests the comparison samples and its limit), and each metric's reader
(``metrics/<metric>.py``, a ``read(run)`` function; a metric split by the
end-to-end metric it moves, ``<quantity>.<part>``, falls back to
``metrics/<quantity>.py`` when it has no file of its own)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return _json(HERE / "mixes" / f"{name}.json")


def cell(workload: str, bench: dict | None = None) -> dict:
    """The cell's entry with its configuration, mix and parameters."""
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == workload:
            return {**w, "cfg": config(w["config"]), "mix": mix(w["traffic"]),
                    "params": _json(HERE / "cells" / f"{workload}.json")}
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics(workload: str, trace: bool, bench: dict | None = None) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones with
    ``trace`` off, its per-layer ones with it on. A metric without a
    ``workloads`` list belongs to every cell that reports what it moves."""
    bench = bench or benchmark()
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in mine else [])]


def reader(name: str):
    """The ``read(run)`` function of metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
