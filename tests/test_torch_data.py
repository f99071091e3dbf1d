"""xsmm_tpu_torch's data path (utils/rng, utils/images, utils/dataset with
the native loader, utils/augment) against xsmm_tpu's, on the CPU.

Inputs are made with numpy from a seed.  Tolerances, stated once here:

* rng, images, the dataset file and the Python loader: bit for bit;
* the native loader: bit for bit against an emulation of
  ``native/dataloader.cpp`` (its xorshift Fisher-Yates permutation seeded
  ``seed * phi64 + epoch + 1``, its ``u8 * (1/255) - 0.5`` in f32) and
  against the JAX package's native loader where that library loads;
* augment fed the JAX package's own draws: crop, flip and brightness bit
  for bit, the contrast step (a mean over the image) 1e-6 absolute.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsmm_tpu_torch as xp
from xsmm_tpu.core import native_bridge as jnb
from xsmm_tpu.utils import augment as jaug
from xsmm_tpu.utils import dataset as jds
from xsmm_tpu.utils import images as jim
from xsmm_tpu.utils import rng as jrng
from xsmm_tpu_torch.core import config as pcfg
from xsmm_tpu_torch.utils import augment as paug
from xsmm_tpu_torch.utils import dataset as pds
from xsmm_tpu_torch.utils import images as pim
from xsmm_tpu_torch.utils import rng as prng

CONTRAST_TOL = 1e-6


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    rng = np.random.default_rng(7)
    n, h, w, c = 100, 6, 6, 3
    imgs = rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
    labels = rng.integers(0, 5, (n,)).astype(np.int32)
    path = str(tmp_path_factory.mktemp("ds") / "ds.xsd")
    pds.write_dataset(path, imgs, labels)
    return path, imgs, labels


# ------------------------------------------------------------------- rng ----

@pytest.mark.parametrize("seed", [0, 1, 25071975, 2**63 + 5])
def test_xorshift_sequences_equal(seed):
    a, b = jrng.Xorshift128p(seed), prng.Xorshift128p(seed)
    assert [a.next_u64() for _ in range(64)] == \
        [b.next_u64() for _ in range(64)]
    assert [a.f32() for _ in range(16)] == [b.f32() for _ in range(16)]


def test_global_rng_sequences_equal():
    jrng.rng_set_seed(123)
    prng.rng_set_seed(123)
    assert np.array_equal(jrng.rng_f32_seq(100), prng.rng_f32_seq(100))
    assert [jrng.rng_u32() for _ in range(8)] == \
        [prng.rng_u32() for _ in range(8)]


def test_device_uniform_takes_a_generator():
    g = torch.Generator().manual_seed(3)
    u = prng.device_uniform(g, (1000,))
    assert u.dtype == torch.float32 and u.shape == (1000,)
    assert float(u.min()) >= 0 and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.05
    g.manual_seed(3)
    assert torch.equal(prng.device_uniform(g, (1000,)), u)


# ---------------------------------------------------------------- images ----

@pytest.mark.parametrize("fmt", ["ppm", "pgm", "bmp"])
def test_image_files_equal(tmp_path, fmt):
    """Both packages write the same bytes and read them back alike."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23) + ((3,) if fmt != "pgm" else ()),
                       dtype=np.uint8)
    write = "write_bmp" if fmt == "bmp" else "write_pnm"
    pj, pp = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"p.{fmt}")
    getattr(jim, write)(pj, img)
    getattr(pim, write)(pp, img)
    assert open(pj, "rb").read() == open(pp, "rb").read()
    got = pim.read_image(pj)
    assert np.array_equal(got, jim.read_image(pp))
    assert np.array_equal(got.reshape(img.shape), img)


def test_image_edge_cases_equal(tmp_path):
    from xsmm_tpu_torch.utils.mhd import mhd_write
    p = str(tmp_path / "low.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n2 1\n15\n" + bytes([15, 0, 7, 15, 15, 15]))
    assert np.array_equal(pim.read_image(p), jim.read_image(p))
    p = str(tmp_path / "f.mhd")
    mhd_write(p, np.full((4, 4), 0.5, np.float32))
    assert np.array_equal(pim.read_image(p), jim.read_image(p))
    p = str(tmp_path / "v.mhd")
    mhd_write(p, np.zeros((5, 6, 7), np.float32))
    with pytest.raises(ValueError, match="volume"):
        pim.read_image(p)
    with pytest.raises(ValueError, match="unsupported"):
        pim.read_image(str(tmp_path / "x.jpg"))


@pytest.mark.parametrize("hw", [(8, 8), (10, 7), (32, 32), (16, 16)])
def test_resize_equal(hw):
    img = np.random.default_rng(1).integers(0, 256, (16, 16, 3),
                                            dtype=np.uint8)
    got = pim.resize(img, hw)
    assert got.dtype == np.uint8 and got.shape == hw + (3,)
    assert np.array_equal(got, jim.resize(img, hw))


def test_ingest_image_dir_equal(tmp_path):
    """A class directory of BMP/PPM/PGM files -> the same XSD1 bytes."""
    rng = np.random.default_rng(0)
    root = tmp_path / "data"
    for cls in ("cat", "dog"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            pim.write_bmp(str(root / cls / f"{i}.bmp"),
                          rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        pim.write_pnm(str(root / cls / "x.ppm"),
                      rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
        pim.write_pnm(str(root / cls / "g.pgm"),
                      rng.integers(0, 256, (24, 24), dtype=np.uint8))
    mp = pim.ingest_image_dir(str(root), str(tmp_path / "p.xsd"), hw=(16, 16))
    mj = jim.ingest_image_dir(str(root), str(tmp_path / "j.xsd"), hw=(16, 16))
    assert mp["classes"] == mj["classes"] == ["cat", "dog"]
    assert mp["n_images"] == mj["n_images"] == 10
    assert (open(tmp_path / "p.xsd", "rb").read()
            == open(tmp_path / "j.xsd", "rb").read())


# --------------------------------------------------------------- dataset ----

def test_write_dataset_equal(tmp_path, dataset):
    _, imgs, labels = dataset
    pj, pp = str(tmp_path / "j.xsd"), str(tmp_path / "p.xsd")
    jds.write_dataset(pj, imgs, labels)
    pds.write_dataset(pp, imgs, labels)
    assert open(pj, "rb").read() == open(pp, "rb").read()


@pytest.mark.parametrize("batch,epochs,seed", [(16, 1, 42), (20, 3, 5),
                                               (100, 2, 0)])
def test_python_loader_equals_jax(dataset, batch, epochs, seed):
    path = dataset[0]
    want = list(jds.DataLoader(path, batch=batch, epochs=epochs, seed=seed,
                               native=False))
    dl = pds.DataLoader(path, batch=batch, epochs=epochs, seed=seed,
                        native=False)
    assert dl.backend == "python" and len(dl) == len(want)
    got = list(dl)
    assert len(got) == len(want)
    for (xg, yg), (xw, yw) in zip(got, want):
        assert xg.dtype == np.float32 and yg.dtype == np.int32
        assert np.array_equal(xg.view(np.uint32), xw.view(np.uint32))
        assert np.array_equal(yg, yw)
    # the same batches as tensors on a device
    for (xt, yt), (xw, yw) in zip(pds.DataLoader(
            path, batch=batch, epochs=epochs, seed=seed, native=False,
            device="cpu"), want):
        assert torch.equal(xt, torch.from_numpy(xw))
        assert torch.equal(yt, torch.from_numpy(yw))


def _xorshift(s):
    m = (1 << 64) - 1
    s ^= (s << 13) & m
    s ^= s >> 7
    s ^= (s << 17) & m
    return s


def native_batches(path, batch, epochs, seed):
    """``native/dataloader.cpp``'s batches, emulated: an xorshift
    Fisher-Yates permutation an epoch and its f32 normalization."""
    ncls, count, h, w, c = pds._read_header(path)
    raw = np.fromfile(path, np.uint8, offset=pds._HDR.size)
    recs = raw[:count * (4 + h * w * c)].reshape(count, -1)
    labels = recs[:, :4].copy().view(np.int32).ravel()
    images = recs[:, 4:]
    seed = seed or 42
    out = []
    for ep in range(epochs):
        perm = list(range(count))
        s = (seed * 0x9E3779B97F4A7C15 + ep + 1) & ((1 << 64) - 1)
        for i in range(count - 1, 0, -1):
            s = _xorshift(s)
            j = s % (i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        for b in range(count // batch):
            idx = perm[b * batch:(b + 1) * batch]
            x = (images[idx].astype(np.float32) * np.float32(1 / 255)
                 - np.float32(0.5)).reshape(batch, h, w, c)
            out.append((x, labels[idx]))
    return out


@pytest.mark.parametrize("batch,epochs,seed", [(16, 2, 42), (7, 1, 3),
                                               (25, 3, 0)])
def test_native_loader_gives_the_cpp_batches(dataset, batch, epochs, seed):
    path = dataset[0]
    want = native_batches(path, batch, epochs, seed)
    dl = pds.DataLoader(path, batch=batch, epochs=epochs, seed=seed,
                        nthreads=3, prefetch=3)
    assert dl.backend == "native"
    got = list(dl)
    assert len(got) == len(want) == len(dl)
    for (xg, yg), (xw, yw) in zip(got, want):
        assert np.array_equal(xg.view(np.uint32), xw.view(np.uint32))
        assert np.array_equal(yg, yw)
    for (xt, yt), (xw, yw) in zip(pds.DataLoader(
            path, batch=batch, epochs=epochs, seed=seed, device="cpu"),
            want):
        assert torch.equal(xt, torch.from_numpy(xw))
        assert torch.equal(yt, torch.from_numpy(yw))


def test_native_loader_equals_jax_native(dataset):
    jdl = jds.DataLoader(dataset[0], batch=10, epochs=2, seed=9)
    if jnb.get_lib() is None or jdl._lib is None:
        pytest.skip("the JAX package's native library does not load")
    want = list(jdl)
    got = list(pds.DataLoader(dataset[0], batch=10, epochs=2, seed=9))
    assert len(got) == len(want) == 20
    for (xg, yg), (xw, yw) in zip(got, want):
        assert np.array_equal(xg, xw) and np.array_equal(yg, yw)


def test_native_loader_raises_instead_of_falling_back(dataset, tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "gone.xsd")
    pds.write_dataset(path, dataset[1], dataset[2])
    dl = pds.DataLoader(path, batch=10)
    os.remove(path)
    with pytest.raises(RuntimeError, match="xsmm_dl_open refused"):
        next(iter(dl))
    monkeypatch.setattr(pcfg.get_config(), "use_native", False)
    with pytest.raises(RuntimeError, match="XSMM_NATIVE=0"):
        pds.DataLoader(dataset[0], batch=10)
    assert pds.DataLoader(dataset[0], batch=10, native=False).backend == \
        "python"


def test_loader_rejects_bad_input(dataset, tmp_path):
    with pytest.raises(ValueError, match="batch"):
        pds.DataLoader(dataset[0], batch=101, native=False)
    p = tmp_path / "bad.xsd"
    p.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="XSD1"):
        pds.DataLoader(str(p), batch=1, native=False)


# --------------------------------------------------------------- augment ----

def _jax_draws(key, b, h, w, crop, pad, brightness, contrast):
    """The JAX package's draws for one call, from its own key splits
    (``utils/augment.py``)."""
    k_crop, k_flip, k_bri, k_con = jax.random.split(key, 4)
    oh = ow = crop or h
    oy = jax.random.randint(k_crop, (b,), 0, h + 2 * pad - oh + 1)
    ox = jax.random.randint(jax.random.fold_in(k_crop, 1), (b,), 0,
                            w + 2 * pad - ow + 1)
    do = jax.random.bernoulli(k_flip, 0.5, (b, 1, 1, 1))
    db = jax.random.uniform(k_bri, (b, 1, 1, 1), minval=-brightness,
                            maxval=brightness)
    dc = jax.random.uniform(k_con, (b, 1, 1, 1), minval=1.0 - contrast,
                            maxval=1.0 + contrast)
    t = lambda a: torch.from_numpy(np.array(a).reshape(b))  # noqa: E731
    return paug.AugmentDraws(t(oy).long(), t(ox).long(), t(do),
                             t(db) if brightness else None,
                             t(dc) if contrast else None)


@pytest.mark.parametrize("cfg", [
    dict(crop=16, pad=2, flip=True, brightness=0.2, contrast=0.2,
         mean=(0.1, 0.2, 0.3)),
    dict(crop=12, pad=0, flip=False),
    dict(crop=None, pad=4, flip=True, brightness=0.1, contrast=0.1),
])
def test_augment_fed_jax_draws_gives_jax_output(cfg):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jaug.make_augment(**cfg)(key, jnp.asarray(x)))
    aug = paug.make_augment(**cfg)
    d = _jax_draws(key, 8, 16, 16, cfg.get("crop"), cfg.get("pad", 4),
                   cfg.get("brightness", 0.0), cfg.get("contrast", 0.0))
    got = aug.transform(torch.from_numpy(x), d).numpy()
    assert got.shape == want.shape
    if cfg.get("contrast"):
        assert np.abs(got - want).max() <= CONTRAST_TOL
    else:
        assert np.array_equal(got, want)


def test_augment_draws_distribution():
    aug = paug.make_augment(crop=16, pad=4, flip=True, brightness=0.2,
                            contrast=0.3)
    x = torch.zeros((4096, 16, 16, 1))
    d = aug.draw(torch.Generator().manual_seed(0), x)
    assert int(d.oy.min()) == 0 and int(d.oy.max()) == 8
    assert int(d.ox.min()) == 0 and int(d.ox.max()) == 8
    assert abs(float(d.flip.float().mean()) - 0.5) < 0.03
    assert float(d.bright.abs().max()) <= 0.2
    assert 0.7 <= float(d.contrast.min()) and float(d.contrast.max()) <= 1.3
    y1 = aug(torch.Generator().manual_seed(1), x + 1)
    y2 = aug(torch.Generator().manual_seed(1), x + 1)
    y3 = aug(torch.Generator().manual_seed(2), x + 1)
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    assert y1.shape == (4096, 16, 16, 1)


def test_loader_feeds_the_engine(dataset):
    """The native loader's batches, tensors on the device, through one
    epoch of the port's engine."""
    from xsmm_tpu_torch.models import MLEngine, SolverConfig, resnet
    params, fwd = resnet(depth=18, num_classes=5, width=4,
                         input_shape=(16, 6, 6, 3))
    eng = MLEngine(params, fwd, SolverConfig(lr=0.01))
    aug = paug.make_augment(crop=6, pad=1)
    gen = torch.Generator().manual_seed(0)
    out = eng.train_epoch(((aug(gen, x), y) for x, y in pds.DataLoader(
        dataset[0], batch=16, device="cpu")), verbose=False)
    assert np.isfinite(out["loss"]) and len(out["losses"]) == 6
