"""The port's native bridge (core/native_bridge.py) against the JAX
package's: CRC32C, the registry's C++ index, the .mtx reader and spmdm's
ELL pack, on the same inputs (after tests/test_native.py).  CPU only: the
library is built with g++ into the port's build directory."""

import concurrent.futures
import os

import numpy as np
import pytest

import xsmm_tpu_torch as xp
from xsmm_tpu.core import native_bridge as jnb
from xsmm_tpu.utils.mtx import read_mtx as jread_mtx
from xsmm_tpu_torch.core import config as pcfg
from xsmm_tpu_torch.core import native_bridge as nb
from xsmm_tpu_torch.core.descriptors import GemmDescriptor
from xsmm_tpu_torch.core.registry import Registry
from xsmm_tpu_torch.utils import mtx as pmtx


@pytest.fixture
def jlib():
    lib = jnb.get_lib()
    if lib is None:
        pytest.skip("the JAX package's native library is not built")
    return lib


@pytest.fixture
def native(monkeypatch):
    """XSMM_NATIVE=1 for the test, whatever the environment."""
    monkeypatch.setattr(pcfg.get_config(), "use_native", True)
    return nb.get_lib()


def _keys(rng, n, size=32):
    return [rng.bytes(size) for _ in range(n)]


def test_crc32c_equals_jax_and_the_python_table(native, jlib):
    rng = np.random.default_rng(0)
    data = [b"", b"a", b"123456789", b"hello world"] + [
        rng.bytes(int(s)) for s in rng.integers(1, 200, 30)]
    for d in data:
        for seed in (0, 1, 0xDEADBEEF):
            want = jnb.crc32(d, seed)
            assert nb.crc32(d, seed) == want == nb.crc32c_py(d, seed)
    assert nb.crc32(b"123456789") == 0xE3069283  # the Castagnoli vector


def test_crc32_is_crc32c_without_the_library(monkeypatch, jlib):
    """A stated difference: with the library off the port still returns
    CRC32C (the JAX fallback returns zlib's CRC32)."""
    monkeypatch.setattr(pcfg.get_config(), "use_native", False)
    assert nb.get_lib() is None
    assert nb.crc32(b"123456789") == 0xE3069283
    assert nb.crc32(b"xsmm", 7) == jnb.crc32(b"xsmm", 7)


def test_registry_find_insert(native):
    reg = nb.NativeRegistry(64)
    assert reg.find(b"key1") == -1
    assert reg.insert(b"key1", 7) == 7
    assert reg.find(b"key1") == 7
    assert reg.insert(b"key1", 99) == 7  # first writer wins
    assert len(reg) == 1
    reg.clear()
    assert reg.find(b"key1") == -1 and len(reg) == 0


def test_registry_many_keys_equal_jax(native, jlib):
    rng = np.random.default_rng(1)
    keys = _keys(rng, 1000)
    reg, jreg = nb.NativeRegistry(4096), jnb.NativeRegistry(4096)
    for i, k in enumerate(keys):
        assert reg.insert(k, i) == jreg.insert(k, i) == i
    for i, k in enumerate(keys):
        assert reg.find(k) == jreg.find(k) == i
    assert len(reg) == len(jreg) == 1000


def test_registry_concurrent(native):
    """Concurrent insert of the same keys: exactly one winner per key."""
    reg = nb.NativeRegistry(1024)
    keys = [bytes([i]) * 16 for i in range(32)]

    def worker(tid):
        return {k: reg.insert(k, tid * 100 + i) for i, k in enumerate(keys)}

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        results = list(ex.map(worker, range(8)))
    for k in keys:
        winners = {r[k] for r in results}
        assert len(winners) == 1, (k, winners)
        assert reg.find(k) in winners
    assert len(reg) == 32


def test_registry_full(native):
    reg = nb.NativeRegistry(4)
    ok = 0
    with pytest.raises(RuntimeError, match="full"):
        for i in range(100):
            reg.insert(os.urandom(16), i)
            ok += 1
    assert ok >= 3


@pytest.mark.parametrize("use_native", [True, False])
def test_registry_info_native_follows_the_knob(monkeypatch, use_native):
    monkeypatch.setattr(pcfg.get_config(), "use_native", use_native)
    reg = Registry(capacity=128)
    assert reg.info()["native"] is use_native
    built = {}
    for m in range(1, 9):
        d = GemmDescriptor(m=m, n=3, k=2)
        built[m] = reg.dispatch(d, lambda m=m: ("kernel", m))
    reg._tls = __import__("threading").local()   # defeat the MRU cache
    finds = reg.native_finds
    for m in range(1, 9):
        d = GemmDescriptor(m=m, n=3, k=2)
        assert reg.lookup(d.pack()).kernel == built[m] == ("kernel", m)
    assert reg.native_finds - finds == (8 if use_native else 0)
    d = GemmDescriptor(m=1, n=3, k=2)
    assert reg.release(d) and reg.lookup(d.pack()) is None
    assert reg.dispatch(d, lambda: "again") == "again"
    reg.clear()
    assert reg.info()["size"] == 0 and reg.lookup(d.pack()) is None


def test_dispatch_results_equal_with_and_without_native(monkeypatch):
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((2, 12, 7, 7))
    xp.set_config(target="cpu")
    try:
        outs = []
        for use_native in (True, False):
            monkeypatch.setattr(pcfg.get_config(), "use_native", use_native)
            xp.finalize(verbose=False)
            assert xp.get_registry_info()["native"] is use_native
            kern = xp.dmmdispatch(7, 7, 7, batch=12, beta=0.0)
            assert xp.dmmdispatch(7, 7, 7, batch=12, beta=0.0) is kern
            outs.append(kern(a, b))
        assert np.array_equal(outs[0], outs[1])
    finally:
        xp.finalize(verbose=False)
        xp.set_config(target="")


def _mtx(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


MTX_FILES = {
    "general": "%%MatrixMarket matrix coordinate real general\n% c\n"
               "4 3 4\n1 1 1.5\n2 3 -2.25\n4 2 3e-3\n3 1 7\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n"
                 "3 3 4\n1 1 2.0\n2 1 -1.0\n3 2 0.5\n3 3 4.0\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n"
               "3 4 3\n1 2\n2 4\n3 1\n",
    "integer": "%%MatrixMarket matrix coordinate integer general\n"
               "2 2 2\n1 1 5\n2 2 -3\n",
}


@pytest.mark.parametrize("kind", sorted(MTX_FILES))
def test_read_mtx_native_equals_python_and_jax(tmp_path, native, jlib, kind):
    p = _mtx(tmp_path / f"{kind}.mtx", MTX_FILES[kind])
    direct = nb.read_mtx_native(p)
    assert direct is not None
    py = pmtx._read_mtx_py(p)
    assert np.array_equal(direct, py)
    assert np.array_equal(pmtx.read_mtx(p), jread_mtx(p))
    assert np.array_equal(direct, jnb.read_mtx_native(p))


def test_read_mtx_written_operator(tmp_path, native):
    rng = np.random.default_rng(3)
    a = np.where(rng.random((40, 30)) < 0.2, rng.standard_normal((40, 30)), 0)
    p = str(tmp_path / "m.mtx")
    pmtx.write_mtx(p, a)
    assert np.array_equal(nb.read_mtx_native(p), a)
    assert np.array_equal(pmtx.read_mtx(p), a)


def test_read_mtx_array_format_takes_the_python_parser(tmp_path, native):
    p = _mtx(tmp_path / "arr.mtx", "%%MatrixMarket matrix array real "
             "general\n2 2\n1\n2\n3\n4\n")
    assert nb.read_mtx_native(p) is None
    assert np.array_equal(pmtx.read_mtx(p), [[1.0, 3.0], [2.0, 4.0]])


def test_read_mtx_without_native(tmp_path, monkeypatch):
    monkeypatch.setattr(pcfg.get_config(), "use_native", False)
    p = _mtx(tmp_path / "g.mtx", MTX_FILES["general"])
    assert nb.read_mtx_native(p) is None
    assert np.array_equal(pmtx.read_mtx(p), jread_mtx(p))


@pytest.mark.parametrize("tol", [0.0, 0.5])
@pytest.mark.parametrize("shape", [(2, 16), (33, 70), (64, 64)])
def test_ell_pack_equals_jax(native, jlib, tol, shape):
    rng = np.random.default_rng(4)
    a = np.where(rng.random(shape) < 0.3, rng.standard_normal(shape),
                 0).astype(np.float32)
    if shape == (2, 16):
        a[:] = 0
        a[0, :8] = np.arange(1, 9)   # a row exactly r wide
    got = nb.ell_pack_native(a, tol)
    want = jnb.ell_pack_native(a, tol)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    r = got[3]
    assert nb.ell_pack_native(a, tol, r=r)[2] == got[2]
    with pytest.raises(ValueError, match="r must be"):
        nb.ell_pack_native(a, tol, r=0)


@pytest.mark.parametrize("strategy", ["ell", "auto"])
def test_spmdm_slices_equal_with_and_without_native(monkeypatch, strategy):
    rng = np.random.default_rng(5)
    a = np.where(rng.random((24, 40)) < 0.15, rng.standard_normal((24, 40)),
                 0).astype(np.float32)
    b = rng.standard_normal((40, 9)).astype(np.float32)
    xp.set_config(target="cpu")
    try:
        res = []
        for use_native in (True, False):
            monkeypatch.setattr(pcfg.get_config(), "use_native", use_native)
            h = xp.spmdm_init(24, 9, 40, strategy=strategy)
            sl = h.create_sparse_slice(a, tol=0.1)
            parts = ((sl.values, sl.cols) if sl.kind == "ell" else (sl.a,))
            res.append((sl.kind, int(sl.nnz), parts, h.compute(sl, b)))
        (k1, n1, p1, o1), (k2, n2, p2, o2) = res
        # auto leaves ELL for dense above the JAX package's crossover
        want = "ell" if strategy == "ell" else "dense"
        assert (k1, n1) == (k2, n2) == (want, int((np.abs(a) > 0.1).sum()))
        assert all(x.equal(y) for x, y in zip(p1, p2)) and o1.equal(o2)
    finally:
        xp.set_config(target="")


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    from xsmm_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nb, "_lib", None)
    monkeypatch.setattr(pcfg.get_config(), "use_native", True)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native build failed"):
        nb.get_lib()
    with pytest.raises(RuntimeError, match="native build failed"):
        Registry(capacity=16)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native build failed"):
        nb.build()
    assert not list((tmp_path / "native").glob("*.so"))
