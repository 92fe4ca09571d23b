"""The port's observability validators (``repro_torch.obs.validate``, a
copy of ``repro.obs.validate``) on the validator cases of
``tests/test_obs.py``, and on the files the port's engine writes during a
preempting SLO run, checked by both packages' validators.

Validation results are exact: the same files give the same event counts
and row summaries from both validators, and the same malformed files raise
ValueError in both.
"""
import json

import numpy as np
import pytest

from repro.obs.validate import _main as jmain
from repro.obs.validate import validate_chrome_trace as jvalidate_trace
from repro.obs.validate import validate_metrics_jsonl as jvalidate_metrics
from repro_torch.configs.base import ModelConfig, ServeConfig, SLOConfig
from repro_torch.nn import init_params
from repro_torch.obs import Observability
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import SpanTracer
from repro_torch.obs.validate import _main as tmain
from repro_torch.obs.validate import validate_chrome_trace, validate_metrics_jsonl
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.request import Priority, Request
from torch_threads import one_torch_thread  # noqa: F401


def _both_trace(path):
    got = validate_chrome_trace(str(path))
    assert got == jvalidate_trace(str(path))
    return got


def _both_metrics(path, require=()):
    got = validate_metrics_jsonl(str(path), require=require)
    assert got == jvalidate_metrics(str(path), require=require)
    return got


def test_metrics_jsonl_row_is_schema_valid(tmp_path):
    """Registry snapshot rows validate, with ``require`` matching an exact
    series or a labelled one by name; a missing name fails in both."""
    reg = MetricsRegistry()
    reg.counter("a_total").inc(1)
    reg.gauge("b", shard=0).set(2.5)
    p = tmp_path / "m.jsonl"
    with open(p, "w") as fh:
        for extra in (dict(step=1), dict(final=True)):
            fh.write(json.dumps(dict(extra, metrics=reg.snapshot())) + "\n")
    assert _both_metrics(p, require=("a_total", "b"))["rows"] == 2
    for v in (validate_metrics_jsonl, jvalidate_metrics):
        with pytest.raises(ValueError):
            v(str(p), require=("c",))


@pytest.mark.parametrize("body", [
    "not json\n",
    '{"no_metrics": 1}\n',
    '{"metrics": {"x": "str"}}\n',
    '{"metrics": {"x": NaN}}\n',
    "\n",
], ids=["not_json", "no_metrics", "non_number", "nan", "empty"])
def test_metrics_jsonl_rejects_malformed(tmp_path, body):
    """A line that is not JSON, a row without a metrics dict, a non-number
    or non-finite value, and an empty file raise ValueError in both."""
    p = tmp_path / "bad.jsonl"
    p.write_text(body)
    for v in (validate_metrics_jsonl, jvalidate_metrics):
        with pytest.raises(ValueError):
            v(str(p))


def test_tracer_disabled_is_noop():
    """A disabled tracer records nothing: spans, async phases, instants."""
    tr = SpanTracer(enabled=False)
    with tr.span("work") as sp:
        assert sp is None
    tr.begin("request", 1, "queued")
    tr.instant("preempt")
    assert tr.events() == []


def test_tracer_span_wellformed(tmp_path):
    """A span, nested async phases and a ``preempt`` instant write a Chrome
    trace both validators accept with the same counts."""
    tr = SpanTracer(enabled=True)
    with tr.span("engine_step", kind="mixed", step=0) as sp:
        sp.args["rows"] = 8
    tr.begin("request", 7, "request", prompt_len=3)
    tr.begin("request", 7, "queued")
    tr.end("request", 7, "queued")
    tr.begin("request", 7, "decode")
    tr.instant("preempt", uid=7)
    tr.end("request", 7, "decode")
    tr.end("request", 7, "request")
    evs = tr.events()
    x = [e for e in evs if e["ph"] == "X"]
    assert x[0]["name"] == "engine_step" and x[0]["args"]["rows"] == 8 and x[0]["dur"] >= 0
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)
    assert all(e["id"] == "7" for e in evs if e["ph"] in ("b", "e"))
    p = tmp_path / "t.json"
    tr.write_chrome_trace(str(p))
    assert _both_trace(p) == {"X": 1, "b": 3, "e": 3, "i": 1, "events": 8}


def test_validator_rejects_unbalanced_async(tmp_path):
    """An unclosed async span, an end without a begin and a file without
    ``traceEvents`` raise ValueError in both validators."""
    tr = SpanTracer(enabled=True)
    tr.begin("request", 1, "request")
    p = tmp_path / "bad.json"
    tr.write_chrome_trace(str(p))
    for v in (validate_chrome_trace, jvalidate_trace):
        with pytest.raises(ValueError, match="unclosed"):
            v(str(p))
    p.write_text(json.dumps({"traceEvents": [{"name": "r", "ph": "e", "ts": 0, "id": "1"}]}))
    for v in (validate_chrome_trace, jvalidate_trace):
        with pytest.raises(ValueError, match="without begin"):
            v(str(p))
    p.write_text(json.dumps({"events": []}))
    for v in (validate_chrome_trace, jvalidate_trace):
        with pytest.raises(ValueError, match="traceEvents"):
            v(str(p))


def test_observability_request_lifecycle():
    """queued -> prefill -> decode -> preempted -> decode -> close: the async
    begin/end pairs balance per request."""
    obs = Observability(tracing=True)
    obs.request_arrived(3, prompt_len=5, max_new_tokens=4)
    obs.request_phase(3, "prefill", slot=0)
    obs.request_phase(3, "prefill")             # same phase: no-op
    obs.request_phase(3, "decode", slot=0)
    obs.request_phase(3, "preempted")
    obs.request_phase(3, "decode", slot=1)
    obs.request_finished(3)
    names = [(e["ph"], e["name"]) for e in obs.tracer.events()]
    assert names == [("b", "request"), ("b", "queued"), ("e", "queued"), ("b", "prefill"),
                     ("e", "prefill"), ("b", "decode"), ("e", "decode"), ("b", "preempted"),
                     ("e", "preempted"), ("b", "decode"), ("e", "decode"), ("e", "request")]
    depth = 0
    for e in obs.tracer.events():
        depth += {"b": 1, "e": -1}[e["ph"]]
        assert depth >= 0
    assert depth == 0


def _slo_engine_run(obs):
    """A tiny dense model on 2 slots: two LOW decodes, a HIGH arrival that
    preempts one of them, and a HIGH request with a deadline that is
    provably unmeetable once the decode rate is measured (shed), under a
    driven clock of 10 ms a step."""
    cfg = ModelConfig(name="t", family="decoder_lm", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=64, max_seq_len=64,
                      dtype="float32")
    serve = ServeConfig(max_slots=2, kv_block_size=4, prefill_chunk=8, max_len=32,
                        num_blocks=16, sched_policy="priority_strict",
                        slo=SLOConfig(shed=True))
    eng = ContinuousEngine(cfg, init_params(cfg, seed=0, device="cpu"), serve, device="cpu",
                           obs=obs, check_invariants=True)
    reqs = [Request(uid=i, prompt=np.arange(6, dtype=np.int32) + 3 * i, max_new_tokens=12,
                    priority=Priority.LOW) for i in range(2)]
    reqs.append(Request(uid=2, prompt=np.arange(5, dtype=np.int32) + 40, max_new_tokens=4,
                        arrival_ms=45.0, priority=Priority.HIGH))
    reqs.append(Request(uid=3, prompt=np.arange(5, dtype=np.int32) + 20, max_new_tokens=4,
                        arrival_ms=200.0, deadline_ms=201.0, priority=Priority.HIGH))
    for r in reqs:
        eng.scheduler.add(r)
    clock, status = 0.0, {}
    while eng.scheduler.has_work():
        for st in eng.step(clock):
            status[st.request.uid] = st.status.value
        clock += 10.0
    return eng, status


def test_engine_slo_run_writes_valid_files(tmp_path):
    """A preempting, shedding run of the port's engine writes a Chrome trace
    and a metrics JSONL that both packages' validators accept with the same
    summaries: the trace holds the ``preempt``, ``restore`` and ``shed``
    instants and balanced ``preempted`` phases; the metrics file's last row
    has the SLO counters; the command line exits 0 on both files."""
    obs = Observability(tracing=True)
    obs.metrics_every = 3
    eng, status = _slo_engine_run(obs)
    assert status == {0: "finished", 1: "finished", 2: "finished", 3: "shed"}
    assert eng.scheduler.preemptions >= 1
    tp, mp = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    obs.tracer.write_chrome_trace(str(tp))
    obs.write_metrics_jsonl(str(mp))
    counts = _both_trace(tp)
    assert counts["b"] == counts["e"] > 0 and counts["X"] >= eng.steps
    evs = obs.tracer.events()
    instants = {e["name"] for e in evs if e["ph"] == "i"}
    assert {"preempt", "restore", "shed"} <= instants
    pre = [e["ph"] for e in evs if e["name"] == "preempted" and e["ph"] in "be"]
    assert pre and pre.count("b") == pre.count("e") == eng.scheduler.preemptions
    info = _both_metrics(mp, require=("sched_preemptions_total", "swap_swapped_blocks_total",
                                      "swap_restored_blocks_total",
                                      "sched_restore_tokens_total", "requests_shed_total",
                                      "engine_steps_total", "kv_blocks"))
    assert info["rows"] >= 2
    assert tmain([str(tp), str(mp), "--require", "requests_shed_total"]) == 0
    assert jmain([str(tp), str(mp), "--require", "requests_shed_total"]) == 0
    assert tmain([str(mp), "--require", "no_such_metric"]) == 1
