"""xsmm_tpu_torch's core against xsmm_tpu's: descriptors, config, registry,
routing, platform, matdiff and the build helpers.

Both packages get the same inputs; the port runs with ``target="cpu"``.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.core import config as jcfg
from xsmm_tpu.core import descriptors as jd
from xsmm_tpu.core.registry import Stats as JStats
from xsmm_tpu.ops import pallas_util as jpu
from xsmm_tpu.ops import smm as jsmm
from xsmm_tpu_torch.core import config as pcfg
from xsmm_tpu_torch.core import descriptors as pd
from xsmm_tpu_torch.core import platform as pplat
from xsmm_tpu_torch.core.registry import Registry, Stats
from xsmm_tpu_torch.ops import cuda_build, pack_util, smm_packed
from xsmm_tpu_torch.ops import smm as psmm

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu_target():
    """Run the port on the CPU; restore both packages' config after."""
    saved_p = dataclasses.asdict(xp.get_config())
    saved_j = dataclasses.asdict(xt.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved_p)
    xt.set_config(**saved_j)


# ---------------------------------------------------------------------------
# Descriptors: pack() gives the same bytes
# ---------------------------------------------------------------------------

DTYPES = ["float64", "float32", "bfloat16", "float16", "int32", "int16",
          "int8", "uint8"]


def _gemm_cases():
    cases = [dict(m=m, n=n, k=k) for m, n, k in
             [(1, 1, 1), (23, 23, 23), (64, 16, 8), (2 ** 20, 3, 70000)]]
    cases += [dict(m=5, n=6, k=7, in_dtype=d, out_dtype=o)
              for d in DTYPES for o in ("float32", d)]
    cases += [dict(m=4, n=4, k=4, flags=jd.gemm_flags(ta, tb, beta, br))
              for ta in "NT" for tb in "NT" for beta in (0.0, 1.0)
              for br in (False, True)]
    cases += [dict(m=23, n=23, k=23, in_dtype="float64",
                   out_dtype="float64", variant=v, batch=131072)
              for v in range(4)]
    cases += [dict(m=3, n=3, k=3, lda=7, ldb=70000, ldc=2 ** 31, prefetch=p,
                   batch=2) for p in (0, 6, 112, 128)]
    return [("gemm", c) for c in cases]


DESCRIPTOR_CASES = (
    _gemm_cases()
    + [("mcopy", dict(m=8, n=9, dtype=d, zero_source=z, batch=3))
       for d in DTYPES for z in (False, True)]
    + [("trans", dict(m=512, n=7, dtype=d, batch=b))
       for d in DTYPES for b in (1, 5)]
    + [("packed", dict(op=op, m=16, n=8, k=4, dtype=d, side=s, uplo=u,
                       transa=t, diag=g, batch=8192))
       for op in ("pgemm", "getrf", "trmm", "trsm")
       for d in ("float32", "float64") for s, u, t, g in
       [("L", "L", "N", "N"), ("R", "U", "T", "U")]]
    + [("sparse", dict(kind=kd, m=20, n=1024, k=20, dtype=d,
                       structure_digest=bytes(range(10)), flags=f))
       for kd in ("csr_asparse", "csc_bsparse", "csr_areg", "csr_bsparse",
                  "spmdm") for d in ("float32", "float64") for f in (0, 3)]
)

_CLASSES = {"gemm": "GemmDescriptor", "mcopy": "MatcopyDescriptor",
            "trans": "TransDescriptor", "packed": "PackedDescriptor",
            "sparse": "SparseDescriptor"}


@pytest.mark.parametrize("kind,kw", DESCRIPTOR_CASES)
def test_pack_bytes_match(kind, kw):
    cls = _CLASSES[kind]
    ref = getattr(jd, cls)(**kw)
    port = getattr(pd, cls)(**kw)
    assert port.pack() == ref.pack()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", DTYPES)
def test_dtype_forms_normalise_alike(name):
    """Strings, numpy dtypes and torch.dtypes give jnp.dtype's names."""
    np_form = (np.dtype(ml_dtypes.bfloat16) if name == "bfloat16"
               else np.dtype(name))
    for form in (name, np_form, pd.TORCH_DTYPES[name]):
        assert pd.dtype_name(form) == jd._norm_dt(name)
        assert pd.dtype_code(form) == jd.dtype_code(name)
    assert pd.code_dtype(pd.dtype_code(name)) == pd.TORCH_DTYPES[name]
    assert pd.ITEMSIZE[name] == np_form.itemsize


@pytest.mark.parametrize("bad", ["int64", "complex64", torch.int64, bool])
def test_unsupported_dtype_raises_in_both(bad):
    with pytest.raises(ValueError, match="unsupported dtype"):
        pd.GemmDescriptor(m=1, n=1, k=1, in_dtype=bad).pack()
    ref_form = str(bad).removeprefix("torch.") if isinstance(
        bad, torch.dtype) else bad
    with pytest.raises(ValueError, match="unsupported dtype"):
        jd.GemmDescriptor(m=1, n=1, k=1, in_dtype=ref_form).pack()


def test_gemm_flags_match():
    for args in [(), ("T", "N"), ("N", "T"), ("t", "t", 0.0),
                 ("N", "N", 1.0, True)]:
        assert pd.gemm_flags(*args) == jd.gemm_flags(*args)
    assert [int(f) for f in pd.GemmFlags] == [int(f) for f in jd.GemmFlags]
    assert [int(p) for p in pd.Prefetch] == [int(p) for p in jd.Prefetch]
    for mod in (pd, jd):
        with pytest.raises(ValueError):
            mod.gemm_flags(beta=0.5)


# ---------------------------------------------------------------------------
# Config: one environment drives both packages
# ---------------------------------------------------------------------------

ENV = {"XSMM_VERBOSE": "2", "XSMM_TARGET": "cpu", "XSMM_F64": "split2",
       "XSMM_REGISTRY_CAPACITY": "77", "XSMM_CACHE_MAXSIZE": "9",
       "XSMM_TGEMM_M": "128", "XSMM_TGEMM_N": "256", "XSMM_TGEMM_K": "64",
       "XSMM_GEMM_THRESHOLD": "1000", "XSMM_AOT_SHAPES": "23x23x23:float64",
       "XSMM_GETRF_UNROLL": "5", "XSMM_SMM_BACKEND": "xla",
       "XSMM_INTERPRET": "1", "XSMM_NATIVE": "0"}


@pytest.mark.parametrize("env", [{}, ENV, {"XSMM_VERBOSE": "not-a-number",
                                           "XSMM_INTERPRET": "0"}],
                         ids=["defaults", "all-set", "malformed"])
def test_config_from_env_matches(monkeypatch, env):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert (dataclasses.asdict(pcfg.Config.from_env())
            == dataclasses.asdict(jcfg.Config.from_env()))


def test_set_config_contract():
    gen = pcfg.config_generation()
    xp.set_config(gemm_threshold=123)
    assert pcfg.config_generation() == gen + 1
    assert xp.get_config().gemm_threshold == 123
    with pytest.raises(AttributeError):
        xp.set_config(no_such_field=1)
    prev = xp.set_verbosity(3)
    assert xp.set_verbosity(prev) == 3


# ---------------------------------------------------------------------------
# Platform: cpu on request, the card otherwise, never a quiet fallback
# ---------------------------------------------------------------------------


def test_platform_cpu_target():
    assert pplat.backend() == "cpu"
    assert pplat.device() == torch.device("cpu")
    assert pplat.interpret_mode() is True
    assert pplat.target_name() == "cpu"


def test_platform_unknown_target_raises():
    xp.set_config(target="tpu")
    with pytest.raises(ValueError, match="unknown target"):
        pplat.backend()


def test_no_card_no_fallback(monkeypatch):
    """With the target unset and no card, building or calling raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kern = xp.smmdispatch(5, 5, 5, batch=4, beta=0.0)   # built on the CPU
    a = np.ones((4, 5, 5), np.float32)
    xp.set_config(target="")
    assert pplat.backend() == "cuda" and pplat.interpret_mode() is False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kern(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.smmdispatch(6, 6, 6, batch=4, beta=0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.dmmdispatch(7, 7, 7, batch=4, beta=0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pplat.target_name()


def test_wrappers_check_operands():
    a = torch.ones((3, 4, 8))
    b = torch.ones((4, 5, 8))
    with pytest.raises(ValueError, match="disagree"):
        smm_packed.packed_f32(a, torch.ones((4, 5, 9)),
                              out_dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        smm_packed.packed_f32(a, b.double(), out_dtype=torch.float32)
    with pytest.raises(ValueError, match="takes"):
        smm_packed.packed_f32(a.double(), b.double(), out_dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        smm_packed.packed_split2_fast(a, b, torch.ones((5, 4, 8)).transpose(0, 1))
    with pytest.raises(ValueError, match="shape"):
        smm_packed.packed_split2_fast(a, b, b, torch.ones((3, 5, 7)))
    with pytest.raises(ValueError, match="both C halves"):
        smm_packed.packed_split2(a, a, b, b, torch.ones((3, 5, 8)))
    with pytest.raises(TypeError):
        smm_packed.packed_split2(a, np.ones((3, 4, 8), np.float32), b, b)


def test_cuda_timer_needs_a_card(monkeypatch):
    from xsmm_tpu_torch.utils.timer import cuda_time_ms
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_time_ms(lambda: None)


def test_plain_versions_do_not_count_launches():
    smm_packed.reset_launches()
    a, b = torch.ones((2, 3, 4)), torch.ones((3, 2, 4))
    smm_packed.packed_f32(a, b, out_dtype=torch.float32)
    smm_packed.packed_split2_fast(a, b, b)
    smm_packed.packed_split2(a, a, b, b)
    assert set(smm_packed.launches.values()) == {0}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def _desc(m=4, n=4, k=4, **kw):
    return pd.GemmDescriptor(m=m, n=n, k=k, **kw)


def test_registry_builds_once_and_counts():
    reg = Registry(capacity=64)
    calls = []
    k1 = reg.dispatch(_desc(), lambda: calls.append(1) or (lambda: "k"))
    k2 = reg.dispatch(_desc(), lambda: calls.append(1) or (lambda: "x"))
    assert k1 is k2 and len(calls) == 1
    info = reg.info()
    assert (info["njit"], info["ntry"], info["size"]) == (1, 2, 1)
    # the index is the native CRC32C table unless XSMM_NATIVE=0
    assert info["nhit"] >= 1
    assert info["native"] is pcfg.get_config().use_native
    assert reg.kernel_info(_desc())["hits"] >= 1
    assert reg.release(_desc()) and not reg.release(_desc())
    assert reg.info()["size"] == 0


def test_registry_stats_buckets_match():
    for mnk in [(13, 13, 13), (14, 13, 13), (23, 23, 23), (64, 64, 64),
                (65, 64, 64), (0, 0, 0)]:
        assert Stats.bucket(*mnk) == JStats.bucket(*mnk)
    reg = Registry(capacity=64)
    for m in (4, 23, 60, 100):
        reg.dispatch(_desc(m, m, m, in_dtype="float64"), lambda: "k")
    assert reg.stats.by_bucket == {"float64": {"sml": 1, "med": 1, "big": 1,
                                               "xxx": 1}}
    assert "TRY=4 JIT=4" in reg.stats.summary()


def test_registry_capacity_degrades():
    """A full registry yields uncached kernels (libxsmm_main.c:1880-1890);
    the MRU cache still holds a hot over-capacity kernel."""
    reg = Registry(capacity=4)
    for m in range(1, 5):
        reg.dispatch(_desc(m=m), lambda: "k")
    col0 = reg.stats.ncol
    assert reg.dispatch(_desc(m=99), lambda: "uncached") == "uncached"
    assert reg.info()["size"] == 4 and reg.stats.ncol > col0
    assert reg.dispatch(_desc(m=99), lambda: "rebuilt") == "uncached"
    for m in range(100, 101 + xp.get_config().cache_maxsize):
        reg.dispatch(_desc(m=m), lambda: "evictor")
    assert reg.dispatch(_desc(m=99), lambda: "rebuilt") == "rebuilt"


def test_dispatch_same_object_and_memo(monkeypatch):
    reg = Registry(capacity=64)
    monkeypatch.setattr(psmm, "get_registry", lambda: reg)
    k1 = xp.smmdispatch(19, 19, 19, batch=8, beta=0.0)
    h0 = reg.stats.ncache_hit
    assert xp.smmdispatch(19, 19, 19, batch=8, beta=0.0) is k1
    assert reg.stats.ncache_hit == h0 + 1
    rec = reg.kernels()[0]
    for _ in range(5):
        xp.smmdispatch(19, 19, 19, batch=8, beta=0.0)
    assert reg.kernel_info(k1.desc)["hits"] == rec["hits"] + 5
    # set_config drops the memo of older generations
    xp.set_config(gemm_threshold=xp.get_config().gemm_threshold)
    xp.smmdispatch(19, 19, 19, batch=8, beta=0.0)
    assert len(reg.front_memo) == 1


def test_capacity_keeps_memo_out(monkeypatch):
    """At capacity the memo must not pin the uncached kernels."""
    reg = Registry(capacity=1)
    monkeypatch.setattr(psmm, "get_registry", lambda: reg)
    xp.smmdispatch(16, 17, 18, batch=8, beta=0.0)
    k1 = xp.smmdispatch(17, 18, 19, batch=8, beta=0.0)
    assert all(k[:3] != (17, 18, 19) for k in reg.front_memo)
    assert reg.info()["size"] == 1 and reg.stats.ncol >= 1
    assert xp.smmdispatch(17, 18, 19, batch=8, beta=0.0) is k1  # MRU


def test_public_registry_introspection():
    kern = xp.smmdispatch(21, 22, 23, batch=8, beta=0.0)
    info = xp.get_kernel_info(kern.desc)
    assert (info["m"], info["n"], info["k"], info["dtype"]) == (
        21, 22, 23, "float32")
    assert info["nbytes_est"] > 0
    walk = xp.registry_kernels()
    assert any(r["name"] == info["name"] for r in walk)
    assert all(walk[i]["hits"] >= walk[i + 1]["hits"]
               for i in range(len(walk) - 1))
    assert xp.get_registry_info()["size"] >= 1


def test_finalize_prints_stats(capsys):
    from xsmm_tpu_torch.core import registry as preg
    xp.smmdispatch(3, 3, 3, batch=8, beta=0.0)
    assert preg.initialized()
    preg.finalize(verbose=True)
    assert "xsmm_tpu_torch dispatch statistics" in capsys.readouterr().out
    assert not preg.initialized()


# ---------------------------------------------------------------------------
# Routing: both packages send every descriptor to the same class
# ---------------------------------------------------------------------------

ROUTES = [
    # (m, n, k, in, out, batch, beta, batch_reduce, strategy, config)
    (23, 23, 23, "float64", "float64", 131072, 0.0, False, s, {})
    for s in ("split2_fast", "split2", "float32", "native")
] + [
    (23, 23, 23, "float32", "float32", 8, 1.0, False, None, {}),
    (23, 23, 23, "float32", "float32", 1, 1.0, False, None, {}),
    (64, 64, 64, "float32", "float32", 8, 0.0, False, None, {}),
    (65, 64, 64, "float32", "float32", 8, 0.0, False, None, {}),
    (256, 256, 256, "float32", "float32", 4, 0.0, False, None, {}),
    (1, 3000, 1, "float32", "float32", 8, 0.0, False, None, {}),
    (1, 40000, 1, "float32", "float32", 8, 0.0, False, None, {}),
    (1, 2600, 1, "float64", "float64", 8, 1.0, False, "split2", {}),
    (1, 2600, 1, "float64", "float64", 8, 1.0, False, "split2_fast", {}),
    (16, 16, 16, "bfloat16", "bfloat16", 8, 0.0, False, None, {}),
    (16, 16, 16, "bfloat16", "float32", 8, 0.0, False, None, {}),
    (9, 9, 9, "int16", "int32", 8, 0.0, False, None, {}),
    (9, 9, 9, "int16", "float32", 8, 0.0, False, None, {}),
    (14, 10, 6, "float32", "float32", 1, 0.0, True, None, {}),
    (14, 10, 6, "float64", "float64", 1, 1.0, True, "split2", {}),
    (23, 23, 23, "float32", "float32", 8, 0.0, False, None,
     {"smm_backend": "xla"}),
    (23, 23, 23, "float64", "float64", 8, 0.0, False, "split2_fast",
     {"gemm_threshold": 8}),
]


@pytest.mark.parametrize("m,n,k,din,dout,batch,beta,br,strategy,cfg", ROUTES)
def test_build_routes_alike(m, n, k, din, dout, batch, beta, br, strategy,
                            cfg):
    variant = jsmm._F64_VARIANTS[strategy] if strategy else 0
    kw = dict(m=m, n=n, k=k, in_dtype=din, out_dtype=dout, batch=batch,
              flags=jd.gemm_flags(beta=beta, batch_reduce=br),
              variant=variant)
    xt.set_config(f64_strategy=strategy or "split2_fast", **cfg)
    xp.set_config(f64_strategy=strategy or "split2_fast", **cfg)
    ref = type(jsmm._build(jd.GemmDescriptor(**kw))).__name__
    port = type(psmm._build(pd.GemmDescriptor(**kw))).__name__
    assert port == ref


def test_unknown_f64_strategy_raises_in_both():
    for pkg in (xt, xp):
        pkg.set_config(f64_strategy="split3")
        with pytest.raises(ValueError, match="unknown f64 strategy"):
            pkg.dmmdispatch(5, 5, 5, batch=8, beta=0.0)


# ---------------------------------------------------------------------------
# matdiff and the packing helpers
# ---------------------------------------------------------------------------


def test_matdiff_matches(rng):
    ref = rng.standard_normal((7, 11))
    tst = ref + 1e-4 * rng.standard_normal((7, 11))
    assert (dataclasses.asdict(xp.matdiff(ref, tst))
            == dataclasses.asdict(xt.matdiff(ref, tst)))
    assert (dataclasses.asdict(xp.matdiff(ref[0], tst[0]))
            == dataclasses.asdict(xt.matdiff(ref[0], tst[0])))
    for pkg in (xt, xp):
        with pytest.raises(AssertionError, match="normf_rel"):
            pkg.check(ref, tst, 1e-6)
        with pytest.raises(ValueError, match="shape mismatch"):
            pkg.matdiff(ref, tst[:, :3])


@pytest.mark.parametrize("shape,mult", [((5, 3, 2), 4), ((8, 2), 8),
                                        ((1, 7), 128)])
def test_pack_util_matches(rng, shape, mult):
    x = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(pack_util.pad_axis(t, -1, mult).numpy(),
                                  np.asarray(jpu.pad_axis(x, -1, mult)))
    packed = pack_util.pack_lanes(t, mult)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpu.pack_lanes(x, mult)))
    np.testing.assert_array_equal(
        pack_util.unpack_lanes(packed, shape[0]).numpy(), x)
    assert pack_util.cdiv(7, 2) == jpu.cdiv(7, 2)
    assert pack_util.round_up(7, 4) == jpu.round_up(7, 4)


# ---------------------------------------------------------------------------
# Builds: lazy, keyed on the sources, and loud when nvcc is missing
# ---------------------------------------------------------------------------


def test_build_is_keyed_on_sources(monkeypatch):
    path = cuda_build.library_path("smm_packed")
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libsmm_packed_") and path.suffix == ".so"
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("smm_packed") != path


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("smm_packed")


# library -> the module that binds its entry points (cuda_build.bind)
BINDERS = {"smm_packed": "ops.smm_packed", "packed": "ops.packed_kernels",
           "spgemm": "ops.spgemm_kernels", "xcopy": "ops.xcopy_kernels",
           "tiled_gemm": "ops.tiled_gemm_kernels", "rnn_seq": "dnn.rnn_seq",
           "pooling": "dnn.pooling"}
C_ARGS = {"int": cuda_build.I, "long long": cuda_build.LL}


def _c_arg(param: str):
    """The ctypes type of one C parameter: any pointer is a c_void_p."""
    if "*" in param:
        return cuda_build.P
    words = param.split()
    if len(words) > 1 and words[-1] not in ("int", "long"):
        words = words[:-1]  # the parameter's name
    return C_ARGS.get(" ".join(words), param)


@pytest.mark.parametrize("name", sorted(cuda_build.SOURCES))
def test_bindings_match_the_sources(name):
    """Each library's binding table (its module's ``_lib``, made by
    ``cuda_build.bind``) holds every ``extern "C"`` entry point of its
    sources, each with the ctypes type of each C parameter, and nothing
    else; every entry point returns int.  Nothing is built here."""
    import importlib
    import re

    src = "".join((REPO / "xsmm_tpu_torch" / "ops" / s).read_text()
                  for s in cuda_build.SOURCES[name])
    protos = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert len(protos) == src.count('extern "C"')
    want = {fn: [_c_arg(p) for p in params.split(",")]
            for fn, params in protos}
    mod = importlib.import_module("xsmm_tpu_torch." + BINDERS[name])
    got = {fn: list(args) for fn, args in mod._lib.entries.items()}
    assert got == want


def test_import_has_no_jax_and_builds_nothing(tmp_path):
    """Importing every module of the port (the sparse path's spgemm,
    spgemm_kernels, fsspmdm, spmdm and utils.mtx, and the dense path's
    tiled_gemm, tiled_gemm_kernels, xcopy, xcopy_kernels, blocked_gemm and
    mmbatch, and the packed path's packed and packed_kernels, and the RNN
    path's dnn.types, dnn.rnn_seq and dnn.rnncell, and bindings and
    bindings.torch_lstm, and the runtime layer's bench, core.native_bridge,
    utils.scratch, utils.timer, utils.trace, utils.mathx, utils.mhd,
    tools.mnk and tools.generator among them) pulls in neither jax nor
    xsmm_tpu, imports no triton, and starts no build: no CUDA library and no
    native library is loaded, no staging pool is made, and nothing new
    appears in the build directory (beside ``native/``, which other test
    processes fill when they make a registry)."""
    def listing():
        return (sorted(p.name for p in cuda_build.BUILD_DIR.glob("*")
                       if p.name != "native")
                if cuda_build.BUILD_DIR.exists() else [])
    before = listing()
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (REPO / "xsmm_tpu_torch").rglob("*.py"))
    for m in ("ops.spgemm", "ops.spgemm_kernels", "ops.fsspmdm", "ops.spmdm",
              "utils.mtx", "ops.tiled_gemm", "ops.tiled_gemm_kernels",
              "ops.xcopy", "ops.xcopy_kernels", "ops.blocked_gemm",
              "ops.mmbatch", "ops.packed", "ops.packed_kernels", "dnn",
              "dnn.types", "dnn.rnn_seq", "dnn.rnncell", "bindings",
              "bindings.torch_lstm", "bench", "core.native_bridge",
              "utils.scratch", "utils.timer", "utils.trace", "utils.mathx",
              "utils.mhd", "tools", "tools.mnk", "tools.generator"):
        assert "xsmm_tpu_torch." + m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'xsmm_tpu.', 'triton')) or m == 'xsmm_tpu' "
            "or m == 'ml_dtypes']\n"
            "assert not bad, bad\n"
            "from xsmm_tpu_torch.ops import cuda_build\n"
            "from xsmm_tpu_torch.core import native_bridge\n"
            "assert not cuda_build._LIBS and native_bridge._lib is None\n"
            "from xsmm_tpu_torch.utils import scratch\n"
            "assert scratch._staging is None\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert listing() == before


def _names_jax(module: str) -> bool:
    """A dotted module path with a part of JAX (``jax``, ``jaxlib``...) or
    of the JAX package (``xsmm_tpu``)."""
    return any(part.startswith("jax") or part == "xsmm_tpu"
               for part in module.split("."))


def test_sources_never_name_jax():
    """No import statement of the port or the smoke, at any depth or over
    several lines, names a module of JAX or of the JAX package: neither
    the module imported from nor a name imported that could be a
    submodule.  Imported names that only contain the word (the port's own
    ``params_from_jax``) are not modules of JAX."""
    for p in list((REPO / "xsmm_tpu_torch").rglob("*.py")) + [
            REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] + [a.name for a in node.names]
            else:
                continue
            assert not any(_names_jax(m) for m in mods), (p, node.lineno)


# ---------------------------------------------------------------------------
# f32 products leave the caller's TF32 and matmul-precision settings alone
# ---------------------------------------------------------------------------


def _port_f32_calls():
    """mmdispatch, xgemm and gemm_batch in f32, an RNN forward and an RNN
    backward_from_saved; returns the mmdispatch product and its f64 gold."""
    rng = np.random.default_rng(40)
    a, b = (rng.standard_normal((96, 96)).astype(np.float32) for _ in "ab")
    got = xp.mmdispatch(96, 96, 96, beta=0.0)(a, b)
    xp.xgemm(a, b)
    xp.gemm_batch([a[:8, :8]] * 3, [b[:8, :8]] * 3)
    from xsmm_tpu_torch.dnn import RnnDesc, create_rnncell
    cell = create_rnncell(RnnDesc(n=4, c=5, k=6, max_t=3))
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    w, r = (rng.standard_normal(s).astype(np.float32) * 0.3
            for s in ((5, 24), (6, 24)))
    cell.forward(x, w, r, np.zeros(24, np.float32))
    _, saved = cell.forward_train(x, w, r, np.zeros(24, np.float32))
    cell.backward_from_saved(saved, np.ones((3, 4, 6), np.float32))
    return got, a.astype(np.float64) @ b.astype(np.float64)


def test_f32_products_restore_tf32_settings():
    """With TF32 on and the f32 matmul precision "high", every port call
    leaves both as they were set (the JAX package's precision=HIGHEST is
    one call's), and its products still run in full f32."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        got, gold = _port_f32_calls()
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    assert xp.matdiff(gold, got.numpy()).normf_rel <= 1e-6


def test_f32_products_restore_per_backend_precision():
    """The same for a caller who sets the per-backend ``fp32_precision``
    (whose state the legacy getters refuse to read), in a process of its
    own so that the setting leaves no trace in this one."""
    code = ("import numpy as np, torch, xsmm_tpu_torch as xp\n"
            "import tests.test_torch_core as t\n"
            "xp.set_config(target='cpu')\n"
            "torch.backends.cuda.matmul.fp32_precision = 'tf32'\n"
            "torch.backends.mkldnn.matmul.fp32_precision = 'bf16'\n"
            "got, gold = t._port_f32_calls()\n"
            "assert torch.backends.cuda.matmul.fp32_precision == 'tf32'\n"
            "assert torch.backends.mkldnn.matmul.fp32_precision == 'bf16'\n"
            "assert xp.matdiff(gold, got.numpy()).normf_rel <= 1e-6\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
