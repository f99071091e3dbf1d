"""The port's spans, build counters and span export (``utils/trace``), on
the CPU: what a recording holds, its clock against ``torch.profiler``'s,
what the main path's layers record, and that nothing is recorded or
opened while recording is off."""

import json
import threading

import numpy as np
import pytest
import torch

import xsmm_tpu_torch as xp
from xsmm_tpu_torch.core.config import get_config
from xsmm_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _cpu():
    xp.set_config(target="cpu")
    yield
    xp.set_config(target="")


def _op():
    """A small fixed operator: 6x5, one or no term a row."""
    op = np.zeros((6, 5))
    op[0, 1], op[3, 2], op[5, 4] = 1.5, -2.0, 0.25
    return op


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_off_are_the_shared_no_op():
    assert not trace.recording_on()
    a, b = trace.span("wrapper"), trace.span("launch")
    assert a is b and trace.scope("xsmm_x.smm", "frontend") is a
    with a as got:
        assert got is None


def test_nesting_self_time_and_one_call_id():
    with trace.recording() as rec:
        assert trace.recording_on()
        with trace.span("outer"):
            with trace.span("mid"):
                with trace.span("leaf"):
                    sum(range(20000))
            with trace.span("mid"):
                pass
        with trace.span("next"):
            pass
    assert not trace.recording_on()
    spans = rec.spans()
    by = _by_name(spans)
    outer, leaf, nxt = by["outer"][0], by["leaf"][0], by["next"][0]
    m1, m2 = by["mid"]
    assert outer.parent is None and outer.call == outer.id
    assert m1.parent == m2.parent == outer.id and leaf.parent == m1.id
    assert {s.call for s in (outer, m1, m2, leaf)} == {outer.id}
    assert nxt.parent is None and nxt.call == nxt.id != outer.id
    assert outer.start <= m1.start <= leaf.start <= leaf.end <= m1.end \
        <= m2.start <= m2.end <= outer.end <= nxt.start
    own = rec.self_ns(spans)
    length = {s.id: s.end - s.start for s in spans}
    assert own[leaf.id] == length[leaf.id]
    assert own[m1.id] == length[m1.id] - length[leaf.id]
    assert own[outer.id] == length[outer.id] - length[m1.id] - length[m2.id]
    assert all(v >= 0 for v in own.values())
    with pytest.raises(RuntimeError, match="already on"):
        with trace.recording():
            with trace.recording():
                pass


def test_each_thread_records_its_own_calls():
    seen = {}

    def work(tag):
        with trace.span(f"root.{tag}"):
            with trace.span(f"leaf.{tag}"):
                seen[tag] = threading.get_ident()

    with trace.recording() as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    by = {s.name: s for s in rec.spans()}
    assert len(by) == 4 and len(seen) == 2
    for tag in "ab":
        root, leaf = by[f"root.{tag}"], by[f"leaf.{tag}"]
        assert root.parent is None and leaf.parent == root.id
        assert leaf.call == root.call == root.id


def test_a_call_of_each_entry_point_records_its_layers():
    rng = np.random.default_rng(3)
    kern = xp.smmdispatch(4, 5, 3, batch=8, beta=0.0)
    a = torch.as_tensor(rng.standard_normal((8, 4, 3)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((8, 3, 5)), dtype=torch.float32)
    h = xp.create_dcsr_reg(_op(), 16)
    ch, cl = torch.zeros(6, 16), torch.zeros(6, 16)
    bh, bl = torch.randn(5, 16), torch.randn(5, 16)
    with trace.recording() as rec:
        assert xp.smmdispatch(4, 5, 3, batch=8, beta=0.0) is kern
        kern(a, b)
        h.acc_fn(ch, cl, bh, bl)
    spans = rec.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["dispatch", "frontend", "frontend"]
    natural, sparse = roots[1], roots[2]
    inner = [(s.name, s.parent) for s in spans if s.call == natural.id][1:]
    # __call__ (the frontend) -> the natural kernel's wrapper, no pack
    assert inner == [("wrapper", natural.id)]
    assert [(s.name, s.parent) for s in spans if s.call == sparse.id][1:] \
        == [("wrapper", sparse.id)]
    # the CPU runs the plain versions: nothing is launched
    assert "launch" not in {s.name for s in spans}


@pytest.mark.parametrize("target", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_a_packed_solve_records_frontend_wrapper_launch(target):
    """One packed LU and one upper solve on it: each is a ``frontend`` span
    with the kernel wrapper's ``wrapper`` inside, and on the card the
    ``launch`` inside that; the CPU runs the plain versions and launches
    nothing."""
    if target == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the CUDA kernels have no CPU "
                        "mode")
        xp.set_config(target="cuda")
    dev = torch.device(target)
    n, b = 70, 40
    a = torch.randn((n, n, b), device=dev) / n
    a[torch.arange(n), torch.arange(n)] += 1.0
    r = torch.randn((n, 1, b), device=dev)
    getrf = xp.getrf_dispatch(n, n, batch=b)
    upper = xp.trsm_dispatch(n, 1, uplo="U", batch=b)
    with trace.recording() as rec:
        lu = getrf.packed(a)
        upper.packed(lu, r)
    spans = rec.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["frontend", "frontend"]
    for root in roots:
        chain = [s.name for s in spans if s.call == root.id]
        nested = [(s.name, s.parent) for s in spans if s.call == root.id]
        wrapper = next(s for s in spans if s.call == root.id
                       and s.name == "wrapper")
        assert nested[1] == ("wrapper", root.id)
        if target == "cuda":
            assert chain == ["frontend", "wrapper", "launch"]
            assert nested[2] == ("launch", wrapper.id)
        else:
            assert chain == ["frontend", "wrapper"]


def test_a_create_hit_records_its_digest_and_a_miss_its_build():
    op = _op()
    with trace.recording() as rec:
        first = xp.create_dcsr_reg(op, 24)
        hit = xp.create_dcsr_reg(op, 24)
    assert hit is first
    creates = [s for s in rec.spans() if s.parent is None]
    assert [s.name for s in creates] == ["create", "create"]
    names = [[s.name for s in rec.spans() if s.call == c.id][1:]
             for c in creates]
    assert names == [["create.digest", "registry.build"], ["create.digest"]]
    digest = next(s for s in rec.spans()
                  if s.call == creates[1].id and s.name == "create.digest")
    assert creates[1].start <= digest.start <= digest.end <= creates[1].end


def test_build_counts_move_only_when_something_is_built():
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((2, 16, 4, 4))
    kern = xp.dmmdispatch(4, 4, 4, batch=16, beta=0.0)
    kern(a, b)
    before = trace.build_counts()
    assert set(before) == {"compiled", "loaded", "routes", "jit",
                           "captures"}
    for _ in range(5):                       # a warm loop builds nothing
        xp.dmmdispatch(4, 4, 4, batch=16, beta=0.0)(a, b)
    assert trace.build_counts() == before
    strategy = get_config().f64_strategy
    other = "split2" if strategy != "split2" else "split2_fast"
    try:
        xp.set_config(f64_strategy=other)    # a new descriptor: one build
        xp.dmmdispatch(4, 4, 4, batch=16, beta=0.0)(a, b)
        xp.dmmdispatch(4, 4, 4, batch=16, beta=0.0)(a, b)
    finally:
        xp.set_config(f64_strategy=strategy)
    after = trace.build_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "compiled": 0, "loaded": 0, "routes": 0, "jit": 1, "captures": 0}


def test_a_new_sparse_route_counts_once():
    h = xp.create_csr_soa(_op(), 40, dtype="float32")
    cin, b = torch.zeros(6, 40), torch.randn(5, 40)
    before = trace.build_counts()["routes"]
    h.acc_fn(cin, b)
    h.acc_fn(cin, b)
    assert trace.build_counts()["routes"] == before + 1


def test_a_span_opens_no_range_and_a_scope_keeps_its_own(monkeypatch):
    """Under ``XSMM_TRACE``, an entry point's scope opens its range, and
    records its span only while recording is on; a span opens no range."""
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    monkeypatch.setattr(trace, "_TRACE_DIR", "somewhere")
    with trace.scope("xsmm_range", "frontend"):
        with trace.span("wrapper"):
            pass
    assert opened == ["xsmm_range"] and trace._REC is None
    with trace.recording() as rec:
        with trace.scope("xsmm_range2", "frontend"):
            with trace.span("wrapper"):
                pass
    assert opened == ["xsmm_range", "xsmm_range2"]
    assert [(s.name, s.parent is None) for s in rec.spans()] == [
        ("frontend", True), ("wrapper", False)]


def test_the_frontend_span_holds_its_calls_ops_on_the_profilers_clock():
    """The clock test: under ``torch.profiler`` with CPU activity, the
    ``frontend`` span of one CPU call contains every ``aten::`` event of
    that call and its own named range, on the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(11)
    kern = xp.smmdispatch(6, 5, 4, batch=32, beta=0.0)
    a = torch.as_tensor(rng.standard_normal((32, 6, 4)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((32, 4, 5)), dtype=torch.float32)
    kern(a, b)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            kern(a, b)
    events = [e for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CPU")]
    aten = [e for e in events if e.name().startswith("aten::")]
    named = [e for e in events if e.name() == kern.name]
    front = [s for s in rec.spans()
             if s.name == "frontend" and s.parent is None]
    assert len(front) == 1 and len(named) == 1 and len(aten) >= 3
    f = front[0]
    for e in aten + named:
        assert f.start <= e.start_ns() and e.end_ns() <= f.end, (
            e.name(), e.start_ns() - f.start, f.end - e.end_ns())


def test_trace_region_writes_the_spans_on_a_row_of_their_own(tmp_path):
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 16, 5, 5))
    kern = xp.dmmdispatch(5, 5, 5, batch=16, beta=0.0)
    kern(a, b)
    with trace.recording():
        with trace.trace_region(str(tmp_path)):
            kern(a, b)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    row = "xsmm_tpu_torch spans"
    spans = [e for e in events if e.get("tid") == row and e["ph"] == "X"]
    assert any(e["ph"] == "M" and e["args"]["name"] == row for e in events
               if e.get("tid") == row)
    assert [e["name"] for e in spans] == ["frontend", "frontend", "wrapper"]
    ranges = [e for e in events if e.get("name") == kern.name
              and e.get("tid") != row]
    front = spans[0]
    assert len(ranges) == 1
    r = ranges[0]
    # the same clock: the call's named range lies inside its frontend span
    assert front["ts"] <= r["ts"] and (r["ts"] + r["dur"]
                                       <= front["ts"] + front["dur"])
    assert front["args"]["call"] == front["args"]["id"]
    assert spans[2]["args"]["call"] == front["args"]["id"]
    # without a recording the file holds no spans
    with trace.trace_region(str(tmp_path / "off")):
        kern(a, b)
    (off,) = (tmp_path / "off").glob("*.json")
    assert not [e for e in json.loads(off.read_text())["traceEvents"]
                if e.get("tid") == row]
