"""The port's ``vtpu_serving_*`` exporter (``vtpu_torch.obs.export``)
against vtpu's (CPU, f32, the same weights on both sides), in the
reference's configuration (tests/test_obs.py's exporter cases).

Held: every reference table entry is carried over unchanged (suffix, help
text, scale, label) and the port adds only its own fourteen keys; every key
a port engine's ``stats()`` reports has a family, on the engines the
reference's coverage test builds (paged, ``kv_swap``, chunked) and on a
disaggregated and an MoE engine, where the key sets of the two packages'
engines differ by exactly the port's keys;
``serving_families`` over a port engine and a JAX engine that served the
same request: the same family names apart from the port's own, none
twice, equal values for every counter that does not depend on timing, the
span and phase histograms carrying bucket samples; the port's collector in
the reference monitor's one scrape; and the tables, ``vtpu_torch.obs`` and
``vtpu_torch.serving`` importing with ``prometheus_client`` hidden. One
torch thread."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.moe import MoEConfig as JMoEConfig, init_moe_params as j_init_moe_params
from vtpu.obs import export as jexport
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.adapters import MoeSlotModel as JMoeSlotModel
from vtpu.serving.disagg import DisaggConfig as JDisaggConfig
from vtpu_torch.convert import moe_params_from_numpy, params_from_numpy
from vtpu_torch.models import ModelConfig, MoEConfig
from vtpu_torch.obs import ServingCollector, export, serving_families, tickprof
from vtpu_torch.serving import DisaggConfig, ServingConfig, ServingEngine
from vtpu_torch.serving.adapters import MoeSlotModel

# the reference test's model
DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=64, head_dim=16)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32)
MOE_DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=32, n_experts=4, top_k=2,
                max_seq=64, head_dim=16)
JMCFG = JMoEConfig(**MOE_DIMS, dtype=jnp.float32)
MCFG = MoEConfig(**MOE_DIMS, dtype=torch.float32)

# the port's own stats() keys: the kernel wrappers' launch counts, the
# device ms of the loop's admission and decode dispatches, the graphs
# captured at construction and an MoE admission's device ms by stage
PORT_COUNTERS = ("flash_launches", "paged_attn_launches", "paged_attn_int8kv_launches",
                 "paged_attn_tp_launches", "paged_attn_int8kv_tp_launches",
                 "paged_attn_tp_verify_launches", "paged_attn_int8kv_tp_verify_launches",
                 "decode_attn_launches", "decode_attn_int8kv_launches",
                 "admission_device_ms", "decode_device_ms")
PORT_KEYS = set(PORT_COUNTERS) | {"graphs_captured", "moe_stage_device_ms"}
# counters whose value depends on the host's timing (how many ticks ran
# while an admission was pending, how many events the ring took), not on
# what was served
TIMING_COUNTERS = {"pipelined_ticks", "trace_events_recorded"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(jp):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.key(0), JCFG)
    jm = j_init_moe_params(jax.random.key(5), JMCFG)
    return {"dense": (jp, params_from_numpy(_tree(jp), CFG, device="cpu")),
            "moe": (jm, moe_params_from_numpy(_tree(jm), MCFG, device="cpu"))}


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).tolist()


# the engines of the coverage check: the reference test's (paged, kv_swap,
# chunked), a disaggregated one and an MoE one
COVERAGE = {
    "paged_swap_chunked": dict(slots=2, prefill_buckets=(16,), max_new_tokens=4,
                               prefill_chunk=16, kv_page=8, kv_swap=2),
    "disagg": dict(slots=2, prefill_buckets=(16,), max_new_tokens=4, prefill_chunk=16,
                   kv_page=8, disagg=True),
    "moe": dict(slots=2, prefill_buckets=(16,), max_new_tokens=4, kv_page=8, kv_swap=2),
}


def _engines(weights, case: str):
    """(JAX engine, port engine) of a coverage case, on the same weights."""
    kw = dict(COVERAGE[case])
    disagg = kw.pop("disagg", False)
    jsc = JServingConfig(**kw, disagg=JDisaggConfig() if disagg else None)
    sc = ServingConfig(**kw, disagg=DisaggConfig() if disagg else None)
    if case == "moe":
        jm, tm = weights["moe"]
        return (JServingEngine(model=JMoeSlotModel(jm, JMCFG, kv_page=8), serving=jsc),
                ServingEngine(model=MoeSlotModel(tm, MCFG, kv_page=8, device="cpu"),
                              serving=sc))
    jp, tp = weights["dense"]
    return JServingEngine(jp, JCFG, jsc), ServingEngine(tp, CFG, sc, device="cpu")


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("table", ["COUNTERS", "GAUGES", "HIST_COUNTERS", "SPECIAL",
                                   "ALLOWLIST"])
def test_reference_tables_carried_over_unchanged(table):
    """Every reference entry is in the port's table unchanged (suffix, help
    text, scale or label); the port adds only its own fourteen keys: nine
    launch counters and two device-ms totals as counters,
    ``graphs_captured`` as a gauge, the MoE stages' device ms as a labelled
    counter, none of them allowlisted."""
    ref, port = getattr(jexport, table), getattr(export, table)
    assert export.PREFIX == jexport.PREFIX == "vtpu_serving_"
    if isinstance(ref, set):
        assert port == ref
        assert not PORT_KEYS & port
        return
    for key, entry in ref.items():
        assert port.get(key) == entry, key
    extra = set(port) - set(ref)
    assert extra == {"COUNTERS": set(PORT_COUNTERS), "GAUGES": {"graphs_captured"},
                     "HIST_COUNTERS": {"moe_stage_device_ms"}}[table]
    assert list(port)[:len(ref)] == list(ref)  # the reference's order, then the port's


def test_port_family_names_are_unique():
    """No two entries of the port's tables share a family suffix (a
    duplicate name is an invalid exposition)."""
    suffixes = ([v[0] for v in export.COUNTERS.values()] + [v[0] for v in export.GAUGES.values()]
                + [v[0] for v in export.HIST_COUNTERS.values()])
    assert len(suffixes) == len(set(suffixes))


@pytest.mark.parametrize("case", list(COVERAGE))
def test_exporter_covers_every_stats_key(weights, case):
    """Every key a port engine's stats() reports maps to a family (the
    reference's coverage check), and its key set differs from the JAX
    engine's of the same configuration by exactly the port's own keys (the
    prefix directory's three keys are reported by both)."""
    jeng, eng = _engines(weights, case)
    try:
        keys, jkeys = set(eng.stats()), set(jeng.stats())
    finally:
        eng.stop()
        jeng.stop()
    mapped = (set(export.COUNTERS) | set(export.GAUGES) | set(export.HIST_COUNTERS)
              | export.SPECIAL | export.ALLOWLIST)
    missing = sorted(k for k in keys if k not in mapped)
    assert not missing, f"stats() keys with no vtpu_serving_* family: {missing}"
    assert keys - jkeys == PORT_KEYS
    assert jkeys - keys == set()


# ---------------------------------------------------------------- families


def _families(families, eng, name):
    """One scrape of ``eng`` under ``name`` through ``families`` (either
    package's serving_families): {family name: family}, after checking no
    name repeats."""
    fams = list(families({name: eng}))
    names = [f.name for f in fams]
    assert len(names) == len(set(names)), "duplicate family names"
    assert all(n.startswith("vtpu_serving_") for n in names)
    return {f.name: f for f in fams}


def test_serving_families_shape(weights):
    """serving_families over a port engine and a JAX engine that served the
    same four-token request: the same family names apart from the port's
    own, equal values for every counter that does not depend on timing
    (tokens_generated = 4), and the span and phase histograms with bucket
    samples."""
    jp, tp = weights["dense"]
    sc = dict(slots=2, prefill_buckets=(8,), max_new_tokens=4)
    jeng = JServingEngine(jp, JCFG, JServingConfig(**sc))
    eng = ServingEngine(tp, CFG, ServingConfig(**sc), device="cpu")
    prompt = _prompt(1, 5)
    scraped = []
    for e, families in ((jeng, jexport.serving_families), (eng, serving_families)):
        e.start()
        try:
            stream = list(e.submit(prompt, max_new_tokens=4).stream())
            scraped.append((stream, _families(families, e, "engine0")))
        finally:
            e.stop()
    (jstream, jfams), (stream, fams) = scraped
    assert stream == jstream and len(stream) == 4
    own = {export.PREFIX + export.COUNTERS[k][0] for k in PORT_COUNTERS}
    own.add(export.PREFIX + export.GAUGES["graphs_captured"][0])
    own.add(export.PREFIX + export.HIST_COUNTERS["moe_stage_device_ms"][0])
    assert set(fams) - set(jfams) == own and set(jfams) <= set(fams)
    tokens = fams["vtpu_serving_tokens_generated"]
    assert tokens.samples[0].labels["engine"] == "engine0" and tokens.samples[0].value == 4.0
    for key, (suffix, _) in jexport.COUNTERS.items():
        if key in TIMING_COUNTERS:
            continue
        got = [(s.labels, s.value) for s in fams[jexport.PREFIX + suffix].samples]
        want = [(s.labels, s.value) for s in jfams[jexport.PREFIX + suffix].samples]
        assert got == want, key
    for key, (suffix, _, _) in jexport.HIST_COUNTERS.items():
        got = sorted((tuple(s.labels.items()), s.value)
                     for s in fams[jexport.PREFIX + suffix].samples)
        want = sorted((tuple(s.labels.items()), s.value)
                      for s in jfams[jexport.PREFIX + suffix].samples)
        assert got == want, key
    for suffix in ("ttft_seconds", "itl_seconds", "queue_wait_seconds", "prefill_exec_seconds"):
        h = fams[export.PREFIX + suffix]
        assert any(s.name.endswith("_bucket") for s in h.samples)
        assert sum(1 for s in h.samples if s.name.endswith("_count")) == 1
    counts = {s.name: s.value for s in fams["vtpu_serving_ttft_seconds"].samples
              if s.name.endswith("_count")}
    assert counts == {"vtpu_serving_ttft_seconds_count": 1.0}
    phases = fams["vtpu_serving_tick_phase_seconds"]
    assert set(tickprof.PHASES) == {
        s.labels["phase"] for s in phases.samples if "phase" in s.labels}
    launches = fams["vtpu_serving_flash_launches"]
    assert launches.type == "counter" and launches.samples
    assert fams["vtpu_serving_graphs_captured"].samples[0].value == 0.0  # none on the CPU


def test_collector_registers_and_renders(weights):
    """A ServingCollector over two port engines renders one exposition
    (each family once, both engines' samples in it); unregister drops an
    engine's samples."""
    from prometheus_client import CollectorRegistry, generate_latest

    tp = weights["dense"][1]
    sc = ServingConfig(slots=2, prefill_buckets=(8,), max_new_tokens=4, kv_page=8, kv_swap=2)
    engines = {n: ServingEngine(tp, CFG, sc, device="cpu") for n in ("a", "b")}
    col = ServingCollector()
    for n, e in engines.items():
        col.register_engine(n, e)
    reg = CollectorRegistry()
    reg.register(col)
    try:
        text = generate_latest(reg).decode()
        assert text.count("# HELP vtpu_serving_tokens_generated_total ") == 1
        assert 'vtpu_serving_migrations_out_total{engine="a"} 0.0' in text
        assert 'vtpu_serving_draining{engine="b"} 0.0' in text
        col.unregister_engine("b")
        assert 'engine="b"' not in generate_latest(reg).decode()
    finally:
        for e in engines.values():
            e.stop()


def test_monitor_collector_merges_serving(weights, tmp_path):
    """The reference monitor's collector with the port's ServingCollector
    (``serving=``): the libvtpu/region families and the vtpu_serving_* set
    from one collect(), no family name twice."""
    from vtpu.monitor.lister import ContainerLister
    from vtpu.monitor.metrics import MonitorCollector

    eng = ServingEngine(weights["dense"][1], CFG, ServingConfig(
        slots=2, prefill_buckets=(8,), max_new_tokens=4), device="cpu")
    (tmp_path / "containers").mkdir()
    col = MonitorCollector(ContainerLister(str(tmp_path)), node_name="n1",
                           serving=ServingCollector({"e": eng}))
    try:
        names = [f.name for f in col.collect()]
    finally:
        eng.stop()
    assert len(names) == len(set(names)), "merged exposition has duplicate names"
    for name in ("vtpu_memory_used_bytes", "vtpu_serving_tokens_generated",
                 "vtpu_serving_tick_phase_seconds", "vtpu_serving_paged_attn_launches"):
        assert name in names


# ----------------------------------------------------- without the client


def test_imports_without_prometheus_client():
    """With prometheus_client hidden from the import system, vtpu_torch.obs
    and vtpu_torch.serving import, the mapping tables read, and only
    building families raises ImportError."""
    code = """
import importlib.abc, sys
class Hide(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "prometheus_client" or name.startswith("prometheus_client."):
            raise ImportError("hidden: " + name)
sys.meta_path.insert(0, Hide())
import vtpu_torch.obs, vtpu_torch.serving
from vtpu_torch.obs import export
assert "prometheus_client" not in sys.modules
assert len(export.COUNTERS) > 60 and "graphs_captured" in export.GAUGES
assert vtpu_torch.serving.migrate and vtpu_torch.serving.ServingEngine.drain
try:
    list(export.serving_families({}))
except ImportError:
    print("families need the client")
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["families", "need", "the", "client", "ok"]
