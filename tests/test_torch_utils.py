"""The port's utilities against the JAX package's on the same inputs:
mathx, mhd (files cross-read bit for bit), scratch (limits, scopes, the
staging pool), the timer and trace.  CPU only; the pool's pinned path on
the card is in tests/test_torch_gpu.py."""

import json
import os
import threading

import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.core.descriptors import GemmDescriptor as JGemm
from xsmm_tpu.core.descriptors import PackedDescriptor as JPacked
from xsmm_tpu.utils import mathx as jmathx
from xsmm_tpu.utils import mhd as jmhd
from xsmm_tpu.utils import scratch as jscratch
from xsmm_tpu.utils import trace as jtrace
from xsmm_tpu_torch.core.descriptors import GemmDescriptor as PGemm
from xsmm_tpu_torch.core.descriptors import PackedDescriptor as PPacked
from xsmm_tpu_torch.utils import mathx, mhd, scratch, timer, trace


@pytest.fixture(autouse=True)
def _cpu():
    xp.set_config(target="cpu")
    yield
    xp.set_config(target="")


# ------------------------------------------------------------------ mathx ---

INTS = [0, 1, 2, 3, 7, 8, 9, 15, 16, 17, 26, 27, 28, 97, 100, 131072,
        2 ** 31 - 1, 2 ** 32 + 5, 10 ** 12, 10 ** 18 + 7]


@pytest.mark.parametrize("fn", ["isqrt_u64", "isqrt_u32", "isqrt2",
                                "icbrt_u64", "icbrt_u32", "sexp2_u8",
                                "shuffle"])
def test_mathx_unary_equals_jax(fn):
    xs = range(256) if fn == "sexp2_u8" else INTS + list(range(0, 300, 7))
    for x in xs:
        assert getattr(mathx, fn)(x) == getattr(jmathx, fn)(x), (fn, x)


def test_mathx_binary_and_sequences_equal_jax():
    rng = np.random.default_rng(0)
    for a, b in rng.integers(0, 10 ** 6, (50, 2)).tolist() + [(0, 5), (5, 0)]:
        assert mathx.gcd(a, b) == jmathx.gcd(a, b)
        assert mathx.lcm(a, b) == jmathx.lcm(a, b)
    for x in (-3.5, 0.0, 0.25, 3.0, 10.7):
        assert mathx.sexp2(x) == jmathx.sexp2(x)
    for n in (1, 2, 10, 97, 1000, 4096):
        assert np.array_equal(mathx.shuffled_indices(n),
                              jmathx.shuffled_indices(n))
    with pytest.raises(ValueError):
        mathx.isqrt_u64(-1)
    with pytest.raises(ValueError):
        mathx.icbrt_u64(-1)


# -------------------------------------------------------------------- mhd ---

MHD_TYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
             np.int64, np.uint64, np.float32, np.float64]


@pytest.mark.parametrize("dtype", MHD_TYPES)
def test_mhd_files_cross_read_bit_exact(tmp_path, dtype):
    rng = np.random.default_rng(1)
    data = (rng.standard_normal((3, 5, 7)) * 100).astype(dtype)
    for writer, reader in ((mhd, jmhd), (jmhd, mhd)):
        p = tmp_path / f"{writer.__name__.split('.')[0]}.mhd"
        writer.mhd_write(str(p), data)
        raw = p.with_suffix(".raw").read_bytes()
        back = reader.mhd_read(str(p))
        assert back.dtype == data.dtype and back.shape == data.shape
        assert back.tobytes() == data.tobytes()
        assert raw == data.tobytes()
    # the two headers are the same text
    assert ((tmp_path / "xsmm_tpu_torch.mhd").read_text()
            .replace("xsmm_tpu_torch.raw", "X")
            == (tmp_path / "xsmm_tpu.mhd").read_text()
            .replace("xsmm_tpu.raw", "X"))


def test_mhd_compare_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((6, 8)).astype(np.float32)
    pa, pb = str(tmp_path / "a.mhd"), str(tmp_path / "b.mhd")
    mhd.mhd_write(pa, a)
    for delta in (1e-6, 1.0):
        mhd.mhd_write(pb, a + delta)
        ok, info = mhd.mhd_compare(pa, pb)
        jok, jinfo = jmhd.mhd_compare(pa, pb)
        assert ok == jok and info.normf_rel == pytest.approx(jinfo.normf_rel)
    mhd.mhd_write(pb, np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        mhd.mhd_compare(pa, pb)
    with pytest.raises(ValueError, match="unsupported element type"):
        mhd.mhd_write(str(tmp_path / "c.mhd"), np.zeros(3, np.complex64))


# ---------------------------------------------------------------- scratch ---

GOOD_LIMITS = ["0", "512M", "2G", "1073741824", "64k", "64KB", "1.5G",
               " 3MB ", "7b", "100"]
BAD_LIMITS = ["lots", "12X", "G", "", "1.2.3M", "MB"]


@pytest.mark.parametrize("raw", GOOD_LIMITS)
def test_scratch_limit_equals_jax(monkeypatch, raw):
    monkeypatch.setenv("XSMM_SCRATCH_LIMIT", raw)
    try:
        want = jscratch.scratch_limit()
    except ValueError:
        with pytest.raises(ValueError, match="XSMM_SCRATCH_LIMIT"):
            scratch.scratch_limit()
        return
    assert scratch.scratch_limit() == want


@pytest.mark.parametrize("raw", BAD_LIMITS)
def test_scratch_limit_refuses_what_jax_refuses(monkeypatch, raw):
    monkeypatch.setenv("XSMM_SCRATCH_LIMIT", raw)
    with pytest.raises(ValueError):
        jscratch.scratch_limit()
    with pytest.raises(ValueError, match="is not a byte count"):
        scratch.scratch_limit()


def test_scratch_info_and_scope_on_cpu(monkeypatch):
    info = scratch.get_scratch_info("cpu")
    jinfo = jscratch.get_scratch_info()
    assert (info.size, info.local, info.nmallocs) == (0, 0, 0)
    assert (jinfo.size, jinfo.local) == (0, 0)
    assert info.npools >= 1
    with scratch.scratch_scope("cpu", device="cpu") as rep:
        pass
    assert rep == {"peak_delta": 0, "live_delta": 0,
                   "limit": scratch.scratch_limit()}
    # the JAX package's peak-delta logic on faked allocator counters
    cur, peak = "allocated_bytes.all.current", "allocated_bytes.all.peak"
    for before, after, want in (
            ({cur: 0, peak: 0}, {cur: 10, peak: 100}, 100),     # new peak
            ({cur: 40, peak: 500}, {cur: 90, peak: 500}, 50),   # live only
            ({cur: 40, peak: 500}, {cur: 10, peak: 500}, 0)):   # freed
        stats = iter([before, after])
        monkeypatch.setattr(scratch, "device_memory_stats",
                            lambda device=None: next(stats))
        with scratch.scratch_scope("x", limit=0) as rep:
            pass
        jstats = iter([{"bytes_in_use": before[cur],
                        "peak_bytes_in_use": before[peak]},
                       {"bytes_in_use": after[cur],
                        "peak_bytes_in_use": after[peak]}])
        monkeypatch.setattr(jscratch, "device_memory_stats",
                            lambda device=None: next(jstats))
        with jscratch.scratch_scope("x", limit=0) as jrep:
            pass
        assert rep == jrep and rep["peak_delta"] == want
    stats = iter([{cur: 0, peak: 0}, {cur: 10, peak: 100}])
    monkeypatch.setattr(scratch, "device_memory_stats",
                        lambda device=None: next(stats))
    with pytest.raises(MemoryError, match="exceeds limit"):
        with scratch.scratch_scope("x", limit=50, strict=True):
            pass
    stats = iter([{cur: 0, peak: 0}, {cur: 10, peak: 100}])
    with pytest.warns(UserWarning, match="exceeds limit"):
        with scratch.scratch_scope("x", limit=50):
            pass


def test_pool_reuses_a_key_and_allocates_once():
    pool = scratch.HostStagingPool(max_pools=4, pin_memory=False)
    a = pool.buffer((8, 3), np.float64, "a")
    assert a.dtype == torch.float64 and tuple(a.shape) == (8, 3)
    assert not a.is_pinned()
    assert pool.buffer((8, 3), torch.float64, "a") is a
    assert (pool.nmallocs, pool.nreuse) == (1, 1)
    # another dtype, shape or slot is another buffer
    others = [pool.buffer((8, 3), np.float32, "a"),
              pool.buffer((8, 4), np.float64, "a"),
              pool.buffer((8, 3), np.float64, "b")]
    assert all(o is not a and o.data_ptr() != a.data_ptr() for o in others)
    assert pool.nmallocs == 4


def test_pool_lru_bound():
    pool = scratch.HostStagingPool(max_pools=3, pin_memory=False)
    bufs = [pool.buffer((4,), np.float32, f"s{i}") for i in range(3)]
    pool.buffer((4,), np.float32, "s0")          # s0 most recent now
    pool.buffer((4,), np.float32, "s3")          # evicts s1, the oldest
    assert len(pool._bufs) == 3
    assert pool.buffer((4,), np.float32, "s0") is bufs[0]
    assert pool.buffer((4,), np.float32, "s2") is bufs[2]
    assert pool.buffer((4,), np.float32, "s1") is not bufs[1]
    assert pool.nmallocs == 5


def test_pool_keys_by_thread():
    pool = scratch.HostStagingPool(max_pools=8, pin_memory=False)
    mine = pool.buffer((16,), np.float64, "x")
    theirs = []
    t = threading.Thread(target=lambda: theirs.append(
        pool.buffer((16,), np.float64, "x")))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(theirs) == 1
    assert theirs[0] is not mine
    assert pool.buffer((16,), np.float64, "x") is mine


@pytest.mark.parametrize("raw", ["0", "-3"])
def test_pool_bound_below_one_raises(monkeypatch, raw):
    """A stated difference: the JAX pool takes 0 and fails at its first
    buffer(); the port refuses the setting when it reads it."""
    monkeypatch.setenv("XSMM_SCRATCH_POOLS", raw)
    with pytest.raises(ValueError, match="XSMM_SCRATCH_POOLS"):
        scratch.HostStagingPool(pin_memory=False)
    if raw == "0":
        jpool = jscratch.HostStagingPool()
        with pytest.raises(StopIteration):
            jpool.buffer((2,), np.float32)
    monkeypatch.setenv("XSMM_SCRATCH_POOLS", "many")
    with pytest.raises(ValueError, match="XSMM_SCRATCH_POOLS"):
        scratch.HostStagingPool(pin_memory=False)


def test_pool_mark_in_flight_on_evicted_buffer_is_a_no_op():
    pool = scratch.HostStagingPool(max_pools=1, pin_memory=False)
    a = pool.buffer((4,), np.float32, "a")
    pool.buffer((4,), np.float32, "b")           # evicts a
    pool.mark_in_flight(a)                       # no card needed: a no-op
    assert not pool._in_flight
    pool.clear()
    assert not pool._bufs and not pool._in_flight


def test_pool_lease_reuses_a_block_only_once_its_arrays_are_gone():
    pool = scratch.HostStagingPool(max_pools=2, pin_memory=False)
    first = np.asarray(pool.lease((3, 4), np.float64))
    second = np.asarray(pool.lease((3, 4), torch.float64))
    assert first.shape == (3, 4) and first.dtype == np.float64
    assert not np.shares_memory(first, second)
    assert pool.lease((3, 4), np.float64) is None    # both held
    view = first[1:]
    del first
    assert pool.lease((3, 4), np.float64) is None    # the view holds it
    del view
    third = np.asarray(pool.lease((3, 4), np.float64))
    assert not np.shares_memory(third, second)
    assert (pool.nresults, pool.nresult_reuse) == (2, 1)
    # the keys are bounded as the staging buffers' are
    pool.lease((5,), np.float32)
    pool.lease((6,), np.float32)
    assert len(pool._results) == 2 and (3, 4) not in {
        k[0] for k in pool._results}
    pool.clear()
    assert not pool._results
    del second, third


def test_fault2_diagnosis_names_the_staging_pool(monkeypatch):
    """Fault 2's CPU state line says whether the staging pool ran in the
    process, so a recurrence can rule it in or out."""
    from xsmm_tpu_torch.dnn.fault2_stress import cpu_state
    monkeypatch.setattr(scratch, "_staging", None)
    assert cpu_state().endswith("; staging pool none")
    pool = scratch.get_staging_pool()
    pool.buffer((4,), np.float32)
    assert cpu_state().endswith(
        "; staging pool 1 buffers (0 reuses), 0 result blocks, "
        "0 copies in flight")


def test_release_scratch_drops_the_pool(monkeypatch):
    pool = scratch.get_staging_pool()
    assert scratch.get_staging_pool() is pool
    scratch.release_scratch()
    assert scratch.get_staging_pool() is not pool
    monkeypatch.setenv("XSMM_SCRATCH_POOLS", "0")
    scratch.release_scratch()
    with pytest.raises(ValueError):
        scratch.get_staging_pool()
    monkeypatch.delenv("XSMM_SCRATCH_POOLS")
    scratch.release_scratch()
    assert scratch.donate(len, 0) is len


def test_cpu_results_alias_no_pooled_buffer():
    """The f64 entry points' results on the CPU target are their own
    memory: no pooled buffer, no input, no earlier result (the card's
    pinned path: tests/test_torch_gpu.py)."""
    pool = scratch.get_staging_pool()
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 700, 23, 23))   # above STAGE_MIN_BYTES
    kern = xp.dmmdispatch(23, 23, 23, batch=700, beta=0.0)
    first = kern(a, b)
    second = kern(-a, -b)
    for buf in pool._bufs.values():
        assert not np.shares_memory(first, buf.numpy())
    assert not np.shares_memory(first, second)
    assert not np.shares_memory(first, a) and not np.shares_memory(first, b)
    np.testing.assert_array_equal(first, -(-first))
    assert np.array_equal(second, kern(-a, -b))


# ------------------------------------------------------------------ timer ---

def test_timer_bench_and_helpers():
    calls = []
    dt, n = timer.bench(lambda x: calls.append(x), 1, warmup=2, iters=5,
                        min_time=0.0)
    assert dt > 0 and n >= 5 and len(calls) == 2 + 1 + n
    dt, n = timer.bench(lambda: None, warmup=1, iters=3)
    assert n >= 3
    t0 = timer.tick()
    assert timer.duration(t0, t0 + 2.5) == 2.5
    assert timer.gflops(2e9, 2.0) == 1.0 == xt.timer.gflops(2e9, 2.0)


def test_device_timers_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_bench needs a CUDA"):
        timer.device_bench(lambda: None)
    with pytest.raises(RuntimeError, match="cuda_time_ms needs a CUDA"):
        timer.cuda_time_ms(lambda: None)


# ------------------------------------------------------------------ trace ---

@pytest.mark.parametrize("kind,args", [
    ("smm", dict(m=23, n=23, k=23, in_dtype="float64", batch=131072)),
    ("smm", dict(m=4, n=5, k=6, in_dtype="bfloat16", batch=1)),
    ("getrf", dict(op="getrf", m=16, n=16, dtype="float64", batch=8)),
    ("trsm", dict(op="trsm", m=16, n=3, dtype="float32", batch=2)),
])
def test_kernel_name_equals_jax(kind, args):
    if "op" in args:
        pd, jd = PPacked(**args), JPacked(**args)
    else:
        pd, jd = PGemm(**args), JGemm(**args)
    assert trace.kernel_name(kind, pd) == jtrace.kernel_name(kind, jd)


def test_scope_opens_no_range_with_tracing_off(monkeypatch):
    """With no capture running, XSMM_TRACE unset and no recording on,
    scope, span and the named entry points cost a flag check: no
    record_function range is opened and no span is recorded."""
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    monkeypatch.setattr(trace, "_TRACE_DIR", "")
    assert not trace.recording_on()
    with trace.scope("off"), trace.scope("off.call", "frontend"):
        with trace.span("off.span"):
            pass
    rng = np.random.default_rng(5)
    kern = xp.dmmdispatch(4, 4, 4, batch=8, beta=0.0)
    kern(*rng.standard_normal((2, 8, 4, 4)))
    xp.create_dcsr_reg(np.eye(4), 8)
    assert opened == [] and trace._REC is None
    with trace.recording() as rec:     # holds what it saw, nothing earlier
        pass
    assert rec.spans() == []
    monkeypatch.setattr(trace, "_TRACE_DIR", "somewhere")
    with trace.scope("on"):
        pass
    assert opened == ["on"]


def test_trace_region_writes_a_trace_with_the_named_call(tmp_path):
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 16, 5, 5))
    kern = xp.dmmdispatch(5, 5, 5, batch=16, beta=0.0)
    assert not trace.trace_enabled() or os.environ.get("XSMM_TRACE")
    with trace.trace_region(str(tmp_path)) as d:
        out = kern(a, b)
        with trace.scope("xsmm_test_scope"):
            pass
    assert d == str(tmp_path) and out.shape == (16, 5, 5)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert kern.name in names and "xsmm_test_scope" in names
    assert kern.name == "xsmm_tpu_float64_5x5x5_b16.smm"
    assert trace.stop_trace() is None            # nothing running
    with pytest.raises(RuntimeError, match="already running"):
        with trace.trace_region(str(tmp_path)):
            trace.start_trace(str(tmp_path))


def test_named_decorator():
    @trace.named("xsmm_named")
    def f(x):
        return x + 1
    assert f(1) == 2 and f.__name__ == "f"
