"""The port's ``ops/pos_embed.py`` against ``vtp_tpu.ops.pos_embed`` on the CPU:
``sincos_1d``, ``sincos_2d`` with and without the cls row, and
``interpolate_pos_embed`` up (14 -> 16) and down (16 -> 14, where
``jax.image.resize`` antialiases) with 0, 1 and 5 extra tokens, all within
the fp32 gate (5e-4 abs). ``F.interpolate(mode="bicubic")`` is shown to
compute another function (a = -0.75, clamped borders, no antialias)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vtp_tpu.ops import pos_embed as jax_pe
from vtp_tpu_torch.ops import pos_embed as pe

torch.set_num_threads(1)
F32_ABS = 5e-4


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= F32_ABS, np.abs(got - want).max()


@pytest.fixture(autouse=True)
def _quiet_float64():
    """The JAX helpers ask for float64, which JAX truncates to float32 here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*float64.*")
        yield


@pytest.mark.parametrize("dim", [8, 64])
def test_sincos_1d_matches_jax(dim):
    pos = np.arange(-3, 29, dtype=np.float32).reshape(4, 8)
    got = pe.sincos_1d(dim, torch.from_numpy(pos))
    _close(got.numpy(), jax_pe.sincos_1d(dim, jnp.asarray(pos)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (32, dim)


@pytest.mark.parametrize("grid,cls_token", [(1, False), (4, False), (14, True), (16, True)])
def test_sincos_2d_matches_jax(grid, cls_token):
    got = pe.sincos_2d(64, grid, cls_token)
    _close(got.numpy(), jax_pe.sincos_2d(64, grid, cls_token))
    if cls_token:
        assert not got[0].any()


def test_sincos_rejects_odd_dims():
    with pytest.raises(ValueError):
        pe.sincos_1d(7, torch.arange(3))
    with pytest.raises(ValueError):
        pe.sincos_2d(6, 4)  # the halves of 3 are odd


@pytest.mark.parametrize("orig,new", [(14, 16), (16, 14), (8, 3), (3, 8)])
@pytest.mark.parametrize("extra", [0, 1, 5])
def test_interpolate_pos_embed_matches_jax(orig, new, extra):
    x = np.random.default_rng(orig * 10 + extra).standard_normal(
        (2, extra + orig * orig, 24)).astype(np.float32)
    got = pe.interpolate_pos_embed(torch.from_numpy(x), new, extra)
    want = jax_pe.interpolate_pos_embed(jnp.asarray(x), new, extra)
    _close(got.numpy(), want)
    assert np.array_equal(got[:, :extra].numpy(), x[:, :extra])  # extra rows kept as they are


def test_interpolate_infers_the_extra_tokens_and_keeps_a_matching_grid():
    x = np.random.default_rng(3).standard_normal((1, 1 + 14 * 14, 16)).astype(np.float32)
    _close(pe.interpolate_pos_embed(torch.from_numpy(x), 16).numpy(),
           jax_pe.interpolate_pos_embed(jnp.asarray(x), 16))
    t = torch.from_numpy(x)
    assert pe.interpolate_pos_embed(t, 14) is t


@pytest.mark.parametrize("orig,new", [(14, 16), (16, 14)])
def test_torch_bicubic_interpolate_is_another_function(orig, new):
    """The port writes the resample out: torch's bicubic disagrees with
    ``jax.image.resize`` by more than the gate both ways."""
    x = np.random.default_rng(5).standard_normal((1, orig, orig, 8)).astype(np.float32)
    want = np.asarray(jax_pe.interpolate_pos_embed(jnp.asarray(x.reshape(1, -1, 8)), new, 0))
    grid = torch.from_numpy(x).permute(0, 3, 1, 2)
    theirs = F.interpolate(grid, size=(new, new), mode="bicubic", align_corners=False)
    theirs = theirs.permute(0, 2, 3, 1).reshape(1, -1, 8).numpy()
    assert np.abs(theirs - want).max() > 10 * F32_ABS
    w = pe.bicubic_weights(orig, new)
    assert tuple(w.shape) == (orig, new)
    np.testing.assert_allclose(w.sum(0).numpy(), 1.0, atol=1e-6)
