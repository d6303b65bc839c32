"""Every cell, configuration, mix and metric is found by its name, and
BENCHMARK.json keeps the contract's shape."""

import json
import re

import pytest

from portbench import catalog, traffic

BENCH = catalog.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(workload):
    cell = catalog.cell(workload, BENCH)
    cfg, mix, params = cell["cfg"], cell["mix"], cell["params"]
    assert cfg["source"] and cfg["serving"]["slots"] > 0
    assert mix["loop"] in ("open", "closed")
    if mix["loop"] == "open":
        assert params["rate_per_s"] > 0
    assert params["limits"] and params["min_tokens"] > 0
    e2e = catalog.metrics(workload, False, BENCH)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = catalog.metrics(workload, True, BENCH)
    assert layer and all(m["moves"] in names for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(catalog.reader(metric))


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"engine loop", "model step", "kernels", "device"}


def test_mix_buckets_are_the_mix_prompts_buckets():
    from portbench.harness import mix_buckets

    cell = catalog.cell("deepseek-llm-7b.chat", BENCH)
    assert mix_buckets(cell["cfg"], cell["mix"]) == [256, 512, 1024, 2048]
    cell = catalog.cell("deepseek-llm-7b.decode_long", BENCH)
    assert mix_buckets(cell["cfg"], cell["mix"]) == [2048]
    lo, hi = traffic.size_range(cell["mix"]["prompt_tokens"])
    assert (lo, hi) == (1536, 2048)


@pytest.mark.parametrize("metric,file", [("idle_share.chat", "idle_share.py"),
                                         ("prefill_exec_p95_ms.itl", "prefill_exec_p95_ms.py"),
                                         ("ttft_p50_ms", "ttft_p50_ms.py")])
def test_reader_falls_back_to_its_quantity(metric, file):
    assert catalog.reader(metric).__code__.co_filename.endswith("/metrics/" + file)


def test_flash_roofline_raises_when_admissions_go_unseen():
    from types import SimpleNamespace

    from portbench.harness import is_flash

    cfg = {"num_attention_heads": 2, "head_dim": 64, "num_hidden_layers": 2}
    ops = [("flash_fwd_kernel", 0, 1000)]
    run = SimpleNamespace(ops=ops, host_trace=(0, 10), cfg=cfg, admissions=[],
                          kernel_s=lambda match: sum(e - s for n, s, e in ops if match(n)) / 1e9)
    read = catalog.reader("flash_roofline.chat")
    with pytest.raises(RuntimeError, match="admission"):
        read(run)
    run.admissions = [(5, 256, [0], [200])]
    assert 0 < read(run) and is_flash(ops[0][0])
