"""The flight recorder's exporters in the port (``repro_torch.obs.export``)
and the serving scheduler's spans and metrics: Prometheus text, JSONL
and Chrome trace dumps, ``explain`` of one request's span tree, the §6
numbers on a scheduler attempt, the scheduler's published metrics, its
stats snapshot and the merge of retried attempts — the cases of the JAX
package's ``tests/test_obs.py`` on the port, plus the same scheduler
request exported by both packages."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro_torch as rt  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.serve import (FaultPlan, SchedulerConfig,  # noqa: E402
                               ServeScheduler, VirtualClock)

DIM = 6


def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, DIM)).astype(np.float32) * 2).copy()


def _index(n=400, k=5):
    cfg = rt.JoinConfig(k=k, n_pivots=24, n_groups=6, grouping="geometric")
    return rt.build_index(_data(n), cfg, device="cpu"), cfg


def _host_sched():
    idx, cfg = _index()
    eng = rt.StreamJoinEngine(idx, cfg, device="cpu")
    vc = VirtualClock()
    return ServeScheduler(eng, config=SchedulerConfig(), clock=vc.now,
                          sleep=vc.advance), eng


def test_prometheus_rendering():
    with obs.metrics.scoped() as reg:
        reg.counter("req_total", site="a").inc(3)
        reg.gauge("depth").set(2)
        h = reg.histogram("lat_s", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        text = obs.render_prometheus(reg)
    assert "# TYPE req_total counter" in text
    assert 'req_total{site="a"} 3' in text
    assert "depth 2" in text
    assert 'lat_s_bucket{le="0.1"} 1' in text
    assert 'lat_s_bucket{le="1"} 2' in text
    assert 'lat_s_bucket{le="+Inf"} 3' in text
    assert "lat_s_count 3" in text
    assert "lat_s_sum 5.55" in text


def test_jsonl_and_chrome_trace_exports(tmp_path):
    with obs.capture() as tr:
        with obs.span("stage", rows=np.int64(3), sel=np.float32(0.5),
                      n=torch.tensor(4)):
            obs.event("flag", shard=0)
    spans = tr.spans()
    lines = obs.spans_to_jsonl(spans).strip().split("\n")
    assert len(lines) == 2
    recs = [json.loads(ln) for ln in lines]
    assert {r["name"] for r in recs} == {"stage", "flag"}
    stage = next(r for r in recs if r["name"] == "stage")
    # numpy and torch scalars made JSON-clean
    assert stage["attrs"] == {"rows": 3, "sel": 0.5, "n": 4}
    p = tmp_path / "spans.jsonl"
    obs.write_jsonl(spans, str(p))
    assert p.read_text() == obs.spans_to_jsonl(spans)
    p = tmp_path / "trace.json"
    obs.write_chrome_trace(spans, str(p))
    doc = json.loads(p.read_text())
    evs = {e["name"]: e for e in doc["traceEvents"]}
    assert evs["stage"]["ph"] == "X" and evs["stage"]["dur"] >= 0
    assert evs["flag"]["ph"] == "i"
    assert evs["flag"]["args"]["parent_id"] == evs["stage"]["args"][
        "span_id"]
    assert obs.spans_to_jsonl([]) == ""


def test_explain_builds_request_tree():
    with obs.capture() as tr:
        obs.event("serve.admission", ticket=7, outcome="admitted")
        with obs.span("serve.attempt", tickets=(7, 9), rung="engine"):
            with obs.span("megastep.device_step", bucket=16):
                pass
        obs.event("other.noise", ticket=8)
    roots = obs.explain(7, tr.spans())
    names = [n.span.name for r in roots for n in r.walk()]
    assert names == ["serve.admission", "serve.attempt",
                     "megastep.device_step"]
    att = next(n for r in roots for n in r.walk()
               if n.span.name == "serve.attempt")
    assert att.children[0].span.name == "megastep.device_step"
    assert isinstance(att, obs.ExplainNode)
    assert obs.explain(12345, tr.spans()) == []
    text = obs.format_explain(roots)
    assert "serve.attempt" in text and "megastep.device_step" in text
    with pytest.raises(ValueError):
        obs.explain(7)                     # no tracer, no spans
    with pytest.raises(TypeError):
        obs.explain("nope", tr.spans())


def test_scheduler_spans_carry_paper_metrics():
    """A traced request's span tree carries the §6 numbers as span
    attributes, all host-side values (no tensor to read back)."""
    sched, _ = _host_sched()
    q = _data(8, seed=3)
    sched.join_now(q)                      # warm (untraced)
    with obs.capture() as tr:
        t = sched.join_now(q)
    assert t.done
    roots = obs.explain(t, tracer=tr)
    names = [n.span.name for r in roots for n in r.walk()]
    for name in ("serve.admission", "serve.coalesce", "serve.attempt",
                 "serve.complete", "serve.deadline_recheck"):
        assert name in names
    att = next(n.span for r in roots for n in r.walk()
               if n.span.name == "serve.attempt")
    assert att.attrs["outcome"] == "ok" and att.attrs["rung"] == "engine"
    assert att.attrs["tiles_total"] > 0
    assert att.attrs["tiles_pruned"] == (att.attrs["tiles_total"]
                                         - att.attrs["tiles_visited"])
    assert 0 < att.attrs["selectivity"] < 1
    assert att.attrs["replicas"] > 0
    for s in tr.spans():
        for v in s.attrs.values():
            assert not isinstance(v, torch.Tensor), (s.name, v)


def test_scheduler_metrics_published():
    sched, _ = _host_sched()
    with obs.metrics.scoped() as reg:
        sched.join_now(_data(8, seed=4))
        snap = reg.snapshot()
        text = obs.render_prometheus(reg)
    assert snap["serve_submitted_total"] == 1
    assert snap["serve_completed_total"] == 1
    assert snap["serve_dispatch_total"] == 1
    assert snap["serve_latency_s_count"] == 1
    assert snap["serve_latency_s_p99"] >= 0
    assert "serve_latency_s_count 1" in text


def test_snapshot_returns_independent_copy():
    sched, _ = _host_sched()
    sched.join_now(_data(4, seed=5))
    snap = sched.snapshot()
    assert snap.n_completed == 1
    assert snap is not sched.stats and snap.join is not sched.stats.join
    snap.n_completed = 99
    snap.join.n_r = 12345
    assert sched.stats.n_completed == 1
    assert sched.stats.join.n_r != 12345


def test_retry_merges_join_stats_instead_of_overwriting():
    sched, _ = _host_sched()
    q = _data(8, seed=6)
    sched.join_now(q)
    base = sched.snapshot().join
    with FaultPlan().fail("sched.dispatch", times=1):
        t = sched.join_now(q)
    assert t.done
    js = sched.snapshot().join
    assert sched.snapshot().n_retries == 1
    assert js.n_r == base.n_r + q.shape[0]
    assert js.pairs_computed > base.pairs_computed


def test_explain_of_a_retried_ticket_matches_jax():
    """One request retried onto the host path, traced in both packages:
    the same span names in the same tree order, the same rungs and
    outcomes per attempt, and one deadline re-check per attempt."""
    from repro import obs as jobs
    from repro.core import JoinConfig as JConfig
    from repro.core import StreamJoinEngine as JStream
    from repro.core import build_index as j_build_index
    from repro.serve import faultinject as jfi
    from repro.serve import scheduler as js

    q = _data(8, seed=7)
    trees = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            cfg = JConfig(k=5, n_pivots=24, n_groups=6)
            eng = JStream(j_build_index(_data(), cfg), cfg, megastep=True)
            mod, o, plan = js, jobs, jfi.FaultPlan
        else:
            cfg = rt.JoinConfig(k=5, n_pivots=24, n_groups=6)
            eng = rt.StreamJoinEngine(rt.build_index(_data(), cfg,
                                                     device="cpu"),
                                      cfg, megastep=True, device="cpu")
            from repro_torch.serve import scheduler as mod
            o, plan = obs, FaultPlan
        vc = mod.VirtualClock()
        sched = mod.ServeScheduler(eng, clock=vc.now, sleep=vc.advance)
        sched.join_now(q)                  # warm
        with o.capture() as tr:
            with plan().fail("sched.dispatch", times=1):
                t = sched.join_now(q)
        assert t.done and t.attempts == 2
        tree = [n.span for r in o.explain(t, tracer=tr) for n in r.walk()]
        trees.append([(s.name, s.attrs.get("rung"), s.attrs.get("outcome"),
                       s.attrs.get("attempt")) for s in tree
                      if s.name.startswith("serve.")])
        text = o.format_explain(o.explain(t, tracer=tr))
        assert text.count("serve.deadline_recheck") == 2
    assert trees[0] == trees[1]
