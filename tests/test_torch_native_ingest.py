"""The port's native ingest (``vtp_tpu_torch.native``, its own copy of
``ingest.cpp`` built into ``vtp_tpu_torch/_build/``) and
``data.native_loader.NativeImageLoader`` against ``vtp_tpu.native`` and its
loader on the CPU, bit-equal: all three modes, with and without flips, on a
folder of PNG and JPEG files written with PIL. Skipped only where the JAX
package's library is unavailable, as ``tests/test_native_ingest.py`` is.
Where the port's library cannot be built, the loader and ``ingest_batch``
raise (checked with the build made to fail)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from vtp_tpu import native as jax_native
from vtp_tpu.data import ImageFolder as JaxImageFolder
from vtp_tpu.data.native_loader import NativeImageLoader as JaxNativeImageLoader
from vtp_tpu_torch import native
from vtp_tpu_torch.data import ImageFolder
from vtp_tpu_torch.data.native_loader import NativeImageLoader

torch.set_num_threads(1)
MODES = [(native.MODE_ADM_CROP, 0), (native.MODE_NAIVE_RESIZE, 0), (native.MODE_RESIZE_CROP, 120)]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Two class folders of PNG and JPEG files of several sizes."""
    if not jax_native.native_available():
        pytest.skip(f"native ingest unavailable: {jax_native.build_error()}")
    root = tmp_path_factory.mktemp("torch_native_imgs")
    rng = np.random.default_rng(0)
    sizes = [(640, 480), (300, 513), (256, 256), (97, 131), (130, 70)]
    for i, (w, h) in enumerate(sizes):
        cls = root / ("a" if i % 2 else "b")
        cls.mkdir(exist_ok=True)
        base = rng.integers(0, 255, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
        img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
        img.save(cls / f"img_{i}.jpg", quality=95)
        img.save(cls / f"img_{i}.png")
    return root


def test_port_library_builds_here(folder):
    assert native.native_available(), native.build_error()
    assert native.build_error() is None
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.SOURCE.parent.name == "native" and "vtp_tpu_torch" in str(native.SOURCE)


@pytest.mark.parametrize("mode,aux", MODES)
@pytest.mark.parametrize("flipped", [False, True])
def test_ingest_batch_equals_jax(folder, mode, aux, flipped):
    paths = [s[0] for s in ImageFolder(str(folder)).samples]
    flips = [i % 2 for i in range(len(paths))] if flipped else None
    got = native.ingest_batch(paths, 96, mode=mode, aux=aux, flips=flips)
    want = jax_native.ingest_batch(paths, 96, mode=mode, aux=aux, flips=flips)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.device.type == "cpu" and tuple(got.shape) == (len(paths), 3, 96, 96)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ingest_batch_into_a_given_tensor_and_bad_paths(folder):
    paths = [s[0] for s in ImageFolder(str(folder)).samples][:2]
    out = torch.full((3, 3, 32, 32), 7.0)
    got = native.ingest_batch([paths[0], str(folder / "missing.jpg"), paths[1]], 32, out=out,
                              mean=(0.5, 0.5, 0.5), std=(0.25, 0.5, 1.0), num_threads=2)
    want = jax_native.ingest_batch([paths[0], str(folder / "missing.jpg"), paths[1]], 32,
                                   mean=(0.5, 0.5, 0.5), std=(0.25, 0.5, 1.0), num_threads=2)
    assert got is out
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[1].any() and got[0].abs().sum() > 0
    with pytest.raises(ValueError):
        native.ingest_batch(paths, 32, out=torch.empty(2, 3, 16, 16))
    with pytest.raises(ValueError):
        native.ingest_batch(paths, 32, flips=[1])


@pytest.mark.parametrize("mode,aux", MODES)
@pytest.mark.parametrize("flip_all", [False, True])
def test_native_loader_equals_jax(folder, mode, aux, flip_all):
    kw = dict(target=64, mode=mode, aux=aux, flip_all=flip_all, sampler=[9, 0, 3, 4, 1, 7, 2],
              num_threads=2, prefetch=1)
    port = NativeImageLoader(ImageFolder(str(folder)), 3, **kw)
    ref = JaxNativeImageLoader(JaxImageFolder(str(folder)), 3, **kw)
    got, want = list(port), list(ref)
    assert len(port) == len(ref) == len(got) == len(want) == 3
    for (x, y), (xr, yr) in zip(got, want):
        assert isinstance(x, torch.Tensor) and y.dtype == torch.int64
        np.testing.assert_array_equal(x.numpy(), xr)
        np.testing.assert_array_equal(y.numpy(), yr)
    assert len(NativeImageLoader(ImageFolder(str(folder)), 3, drop_last=True)) == 3


def test_native_loader_raises_a_producer_error(folder):
    ds = ImageFolder(str(folder))
    loader = NativeImageLoader(ds, 2, sampler=[0, 1, 99])  # index 99 is out of range
    with pytest.raises(IndexError):
        list(loader)


def test_unavailable_library_raises(folder, monkeypatch, tmp_path):
    """A build that fails (here: the source is missing) leaves the library
    unavailable; the loader and ``ingest_batch`` raise, never falling back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "ingest.cpp")
    (tmp_path / "ingest.cpp").write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert not native.native_available()
    assert "build failed" in native.build_error()
    assert not os.listdir(tmp_path / "build")  # nothing half-built left behind
    with pytest.raises(RuntimeError, match="native ingest"):
        NativeImageLoader(ImageFolder(str(folder)), 2)
    with pytest.raises(RuntimeError, match="native ingest unavailable"):
        native.ingest_batch([str(folder / "b" / "img_0.png")], 32)
