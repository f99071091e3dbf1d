"""The port's tools and bring-up against the JAX package's: tools/mnk.py on
the same specs, ``init()`` with ``XSMM_AOT_SHAPES``, and the generator CLI
(its compiled mode on the CPU target; its text modes need nvcc and
cuobjdump, and raise, naming the tool, without them)."""

import jax
import numpy as np
import pytest

import xsmm_tpu as xt
import xsmm_tpu_torch as xp
from xsmm_tpu.tools import mnk as jmnk
from xsmm_tpu_torch.ops import cuda_build
from xsmm_tpu_torch.tools import generator, mnk
from xsmm_tpu_torch.utils.mtx import write_mtx

MNK_SPECS = ["2 3, 5", "4", "1 2 3 4, 23, 64 65", " 8 , 16 32 "]
AXES = [("2 4", "3", ""), ("1,2,3", "", "7 8"), ("23", "23", "23"),
        ("5 6", "", "")]
INDEXES = ["2_3_4 23_23_23", "1_1_1", "64_64_64 65_65_65 2_3_4"]


@pytest.mark.parametrize("spec", MNK_SPECS)
def test_parse_mnk_equals_jax(spec):
    assert mnk.parse_mnk(spec) == jmnk.parse_mnk(spec)


@pytest.mark.parametrize("axes", AXES)
def test_parse_axes_equals_jax(axes):
    assert mnk.parse_axes(*axes) == jmnk.parse_axes(*axes)


@pytest.mark.parametrize("spec", INDEXES)
def test_parse_indexes_and_filter_equal_jax(spec):
    got, want = mnk.parse_indexes(spec), jmnk.parse_indexes(spec)
    assert got == want
    for thr in (mnk.DEFAULT_THRESHOLD, 1000, 0):
        assert mnk.threshold_filter(got, thr) == jmnk.threshold_filter(
            want, thr)


@pytest.mark.parametrize("dtype,batch", [("", 0), ("float64", 512),
                                         ("", 64), ("bfloat16", 0)])
def test_to_aot_shapes_equals_jax(dtype, batch):
    triples = mnk.parse_mnk("2 3, 23")
    assert (mnk.to_aot_shapes(triples, dtype, batch)
            == jmnk.to_aot_shapes(triples, dtype, batch))


@pytest.fixture
def clean_registries(monkeypatch, tmp_path):
    """Both packages' registries fresh; the caches of both pointed at
    tmp_path and put back afterwards."""
    monkeypatch.setenv("XSMM_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    xp.set_config(target="cpu")
    xt.finalize(verbose=False)
    xp.finalize(verbose=False)
    yield
    xt.finalize(verbose=False)
    xp.finalize(verbose=False)
    xp.set_config(target="", aot_shapes="")
    xt.set_config(aot_shapes="")
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


AOT = ["23x23x23:float64:512", "8x8x8", "4x5x6:float32:16,13x13x13:float32",
       ",, 9x9x9:float64:2 ,"]


@pytest.mark.parametrize("spec", AOT)
def test_init_registers_the_same_keys_as_jax(clean_registries, tmp_path,
                                             spec):
    xt.set_config(aot_shapes=spec)
    xp.set_config(aot_shapes=spec)
    jreg = xt.init()
    reg = xp.init()
    assert reg is xp.get_registry()
    assert set(reg._table) == set(jreg._table) and reg._table
    n = len([s for s in spec.split(",") if s.strip()])
    assert reg.stats.nsta == jreg.stats.nsta == n
    assert xp.get_registry_info()["nsta"] == n
    # enable_compile_cache took XSMM_CACHE_DIR
    assert cuda_build.BUILD_DIR == (tmp_path / "cache").resolve()


def test_enable_compile_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.delenv("XSMM_CACHE_DIR", raising=False)
    assert xp.enable_compile_cache(str(tmp_path)) == str(tmp_path.resolve())
    assert cuda_build.library_path("smm_packed").parent == tmp_path.resolve()
    assert xp.enable_compile_cache() == str(cuda_build.DEFAULT_BUILD_DIR)
    monkeypatch.setenv("XSMM_CACHE_DIR", str(tmp_path / "env"))
    assert xp.enable_compile_cache() == str((tmp_path / "env").resolve())


def test_init_on_the_card_target_raises_without_a_card(clean_registries,
                                                        monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp.set_config(target="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.init()


def test_generator_gemm_compiled_on_the_cpu_target(clean_registries):
    out = generator.generate_gemm(8, 8, 8, batch=256, code_type="compiled")
    assert "compiled gemm_float32_8x8x8_b256" in out and "CPU target" in out
    assert xp.get_registry_info()["nsta"] == 1
    out = generator.generate_gemm(200, 200, 200, code_type="compiled")
    assert "torch-op route" in out


def test_generator_spgemm_from_mtx(clean_registries, tmp_path):
    rng = np.random.default_rng(0)
    a = np.zeros((12, 16))
    a[rng.integers(0, 12, 20), rng.integers(0, 16, 20)] = \
        rng.standard_normal(20)
    p = str(tmp_path / "op.mtx")
    write_mtx(p, a)
    out = generator.generate_spgemm(p, 512, code_type="compiled")
    assert "spgemm" in out and "512" in out and "strategy=unroll" in out


def test_generator_cli(clean_registries, tmp_path, capsys):
    out_file = str(tmp_path / "kern.txt")
    assert generator.main(["gemm", "8", "8", "8", "--batch", "256",
                           "--out", out_file]) == 0
    assert "compiled gemm_float32_8x8x8_b256" in open(out_file).read()
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        generator.main(["gemm", "8", "8", "8", "--code-type", "hlo"])
    with pytest.raises(ValueError, match="unknown code type"):
        generator.generate_gemm(8, 8, 8, code_type="stablehlo")


def test_generator_text_modes_raise_without_the_tool(clean_registries,
                                                     monkeypatch):
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(generator.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        generator.generate_gemm(8, 8, 8, batch=256, code_type="ptx")
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        generator.generate_gemm(8, 8, 8, batch=256, code_type="sass")
    # a torch-op route has no kernel text
    with pytest.raises(ValueError, match="no kernel of this package"):
        generator.generate_gemm(200, 200, 200, code_type="ptx")
