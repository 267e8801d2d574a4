"""The port's reconstruction metrics against the JAX package's on the CPU,
on the same seeded inputs and the same seeded torch-layout state dicts
(``random_state_dict``), which both packages' converters take as they are.

Tolerances: PSNR within 1e-3 dB; SSIM within 1e-5 abs (fp32 convolutions
summed in another order); Frechet statistics, moments and distances within
1e-9 rel (the same float64 arithmetic); Inception features within 1e-4 of
max|ref| and LPIPS within 1e-4 rel (a hundred fp32 convolutions each,
summed in another order by XLA and by PyTorch); the 256 -> 299 resize
within 1e-5 abs of ``jax.image.resize``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.metrics import fid as jax_fid
from vtp_tpu.metrics import inception as jax_inception
from vtp_tpu.metrics import lpips as jax_lpips
from vtp_tpu.metrics.psnr import psnr as jax_psnr
from vtp_tpu.metrics.ssim import ssim as jax_ssim
from vtp_tpu_torch.metrics import fid, inception, lpips
from vtp_tpu_torch.metrics.psnr import psnr
from vtp_tpu_torch.metrics.ssim import ssim

torch.set_num_threads(1)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_psnr_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 255, (3, 3, 16, 16)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 4, a.shape), 0, 255).astype(np.float32)
    b[1] = a[1]  # an exact match: infinite, as the reference
    got = _np(psnr(torch.from_numpy(a), torch.from_numpy(b)))
    want = np.asarray(jax_psnr(jnp.asarray(a), jnp.asarray(b)))
    assert np.isinf(got[1]) and np.isinf(want[1])
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=1e-3)


@pytest.mark.parametrize("per_image", [False, True])
def test_ssim_matches_jax(per_image):
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 3, 32, 24)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    got = _np(ssim(torch.from_numpy(a), torch.from_numpy(b), per_image=per_image))
    want = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b), per_image=per_image))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_frechet_stats_stream_and_merge():
    rng = np.random.default_rng(2)
    acts = rng.standard_normal((96, 16)).astype(np.float32) * 2 + 1
    port, ref = fid.FrechetStats(16), jax_fid.FrechetStats(16)
    for s in range(0, 96, 20):  # streaming, in uneven batches, a tensor or an array
        port.update(torch.from_numpy(acts[s: s + 20]))
        ref.update(acts[s: s + 20])
    mu, sigma = port.finalize()
    np.testing.assert_allclose(mu, acts.astype(np.float64).mean(0), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sigma, np.cov(acts.astype(np.float64), rowvar=False), rtol=1e-9,
                               atol=1e-12)
    for got, want in zip(port.finalize(), ref.finalize()):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    a, b = fid.FrechetStats(16), fid.FrechetStats(16)
    a.update(acts[:40])
    b.update(acts[40:])
    for got, want in zip(a.merge(b).finalize(), port.finalize()):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_activation_moments_match_jax():
    acts = np.random.default_rng(3).standard_normal((10, 8)).astype(np.float32)
    got = fid.activation_moments(torch.from_numpy(acts))
    want = jax_fid.activation_moments(jnp.asarray(acts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_frechet_distance_matches_jax(shift):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((64, 12))
    b = rng.standard_normal((64, 12)) * 1.3 + shift
    mu1, s1, mu2, s2 = a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False)
    got = fid.frechet_distance(mu1, s1, mu2, s2)
    want = jax_fid.frechet_distance(mu1, s1, mu2, s2)
    assert abs(got - want) <= 1e-9 * abs(want)
    st1, st2 = fid.FrechetStats(12), fid.FrechetStats(12)
    st1.update(a)
    st2.update(b)
    assert abs(fid.fid_from_stats(st1, st2) - want) <= 1e-9 * abs(want)
    assert fid.frechet_distance(mu1, s1, mu1, s1) == pytest.approx(0.0, abs=1e-9)


def test_resize_to_299_matches_jax_image_resize():
    x = np.random.default_rng(5).uniform(0, 1, (1, 3, 256, 256)).astype(np.float32)
    got = _np(inception.resize_299(torch.from_numpy(x)))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, 299, 299), "bilinear"))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def inception_sd():
    return inception.random_state_dict(seed=7)


def test_inception_features_match_jax(inception_sd):
    """The whole fid-variant graph at B = 1 from a 256^2 image (resized to
    299), both packages on the same seeded state dict."""
    x = np.random.default_rng(6).uniform(0, 1, (1, 3, 256, 256)).astype(np.float32)
    got = _np(inception.inception_features(inception.convert_inception_state_dict(inception_sd),
                                           torch.from_numpy(x)))
    want = np.asarray(jax_inception.inception_features(
        jax_inception.convert_inception_state_dict(inception_sd), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 2048)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_inception_loader_reads_the_environment(inception_sd, tmp_path, monkeypatch):
    monkeypatch.delenv(inception.WEIGHTS_ENV, raising=False)
    assert not inception.inception_available()
    with pytest.raises(FileNotFoundError):
        inception.load_inception_feature_fn(device="cpu")
    path = tmp_path / "pt_inception.pth"
    small = {k: torch.from_numpy(v) for k, v in inception_sd.items()}
    torch.save(small, path)
    monkeypatch.setenv(inception.WEIGHTS_ENV, str(path))
    assert inception.inception_available()
    fn = inception.load_inception_feature_fn(device="cpu")
    x = torch.rand((1, 3, 96, 96), generator=torch.Generator().manual_seed(0))
    params = inception.convert_inception_state_dict(inception_sd)
    assert torch.equal(fn(x), inception.inception_features(params, x))


@pytest.fixture(scope="module")
def lpips_sd():
    return lpips.random_state_dict(seed=8)


def test_lpips_matches_jax(lpips_sd):
    rng = np.random.default_rng(9)
    a = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    metric = lpips.LPIPS(state_dict=lpips_sd, device="cpu")
    assert metric.available
    got = _np(metric(torch.from_numpy(a), torch.from_numpy(b)))
    want = np.asarray(jax_lpips.lpips_forward(jax_lpips.convert_lpips_state_dict(lpips_sd),
                                              jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    same = _np(metric(torch.from_numpy(a), torch.from_numpy(a)))
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_lpips_loads_a_file_or_a_directory(lpips_sd, tmp_path, monkeypatch):
    monkeypatch.delenv(lpips.WEIGHTS_ENV, raising=False)
    assert not lpips.LPIPS(device="cpu").available and not lpips.lpips_available()
    assert lpips.LPIPS(device="cpu")(torch.zeros(1, 3, 8, 8), torch.zeros(1, 3, 8, 8)) is None
    tensors = {k: torch.from_numpy(v) for k, v in lpips_sd.items()}
    torch.save(tensors, tmp_path / "lpips.pth")
    # the directory form: torchvision features.* and the lin heads, in two files
    d = tmp_path / "split"
    d.mkdir()
    vgg = {k.replace(f"net.slice{lpips._slice_of(int(k.split('.')[2]))}.", "features."): v
           for k, v in tensors.items() if k.startswith("net.")}
    torch.save(vgg, d / "vgg16.pth")
    torch.save({k: v for k, v in tensors.items() if k.startswith("lin")}, d / "vgg.pth")
    x = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(1)) * 2 - 1
    y = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(2)) * 2 - 1
    want = lpips.LPIPS(state_dict=lpips_sd, device="cpu")(x, y)
    for path in (tmp_path / "lpips.pth", d):
        monkeypatch.setenv(lpips.WEIGHTS_ENV, str(path))
        assert lpips.lpips_available()
        assert torch.equal(lpips.LPIPS(device="cpu")(x, y), want)
