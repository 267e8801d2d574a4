"""The RoPE coordinate augmentation (``ops/rope.py`` ``rope_sincos`` with
shift, jitter and rescale) against the JAX package's ``rope_sincos`` fed
the same draws: each crop's factors come from the JAX key as JAX draws
them (``split(key, 3)``, a uniform shift, log-uniform jitter and rescale,
in fp32), the port applies them. Gates: within one ulp of the table's
dtype. XLA's fp32 sin and cos differ from torch's by one ulp on about 5%
of arguments, so fp32 tables agree to the ulp, not bit for bit; the
augmented coordinates and angles before them round alike."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.ops.rope import rope_periods_init as jax_periods_init
from vtp_tpu.ops.rope import rope_sincos as jax_rope_sincos
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.ops.rope import draw_rope_coords, rope_periods_init, rope_sincos

torch.set_num_threads(1)
AUGS = {"shift": (0.1, None, None), "jitter": (None, 1.2, None), "rescale": (None, None, 2.0),
        "all": (0.1, 1.2, 2.0)}


def jax_rope_draws(key, shift, jitter, rescale):
    """The factors ``vtp_tpu.ops.rope.rope_sincos`` draws from ``key``."""
    k_shift, k_jitter, k_rescale = jax.random.split(key, 3)
    out = {}
    if shift is not None:
        out["shift"] = jax.random.uniform(k_shift, (2,), jnp.float32, -shift, shift)
    if jitter is not None:
        m = math.log(jitter)
        out["jitter"] = jnp.exp(jax.random.uniform(k_jitter, (2,), jnp.float32, -m, m))
    if rescale is not None:
        m = math.log(rescale)
        out["rescale"] = jnp.exp(jax.random.uniform(k_rescale, (1,), jnp.float32, -m, m))
    return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}


def _ulps(got: torch.Tensor, want: np.ndarray, mantissa: int) -> float:
    """Largest difference in units of the spacing at |want| of a float
    with ``mantissa`` explicit bits (23 fp32, 7 bf16)."""
    want = torch.tensor(np.asarray(want, np.float32))
    spacing = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - mantissa)
    return float(((got.float() - want).abs() / spacing).max())


@pytest.mark.parametrize("aug", list(AUGS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("grid,normalize", [((16, 16), "separate"), ((6, 6), "separate"),
                                            ((4, 7), "max"), ((5, 3), "min")])
def test_rope_sincos_augmented_matches_jax(aug, dtype, grid, normalize):
    shift, jitter, rescale = AUGS[aug]
    H, W = grid
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    key = jax.random.key(H * 100 + W)
    kw = dict(normalize_coords=normalize, shift_coords=shift, jitter_coords=jitter,
              rescale_coords=rescale)
    want = jax_rope_sincos(jax_periods_init(64, dtype=jdt), H, W, key=key, training=True, **kw)
    got = rope_sincos(rope_periods_init(64, dtype=tdt), H, W,
                      draws=jax_rope_draws(key, shift, jitter, rescale), **kw)
    plain = jax_rope_sincos(jax_periods_init(64, dtype=jdt), H, W, normalize_coords=normalize)
    assert not np.array_equal(np.asarray(want[0], np.float32), np.asarray(plain[0], np.float32))
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == (H * W, 64)
        assert _ulps(g, np.asarray(w, np.float32), 23 if dtype == "fp32" else 7) <= 1.0


def test_augmentation_only_in_a_training_forward_with_a_generator():
    """Without draws the tables are the plain ones whatever is configured;
    the trunk augments them only in a training forward given a generator."""
    periods = rope_periods_init(64)
    kw = dict(shift_coords=0.1, jitter_coords=1.2, rescale_coords=2.0)
    assert all(torch.equal(a, b) for a, b in zip(rope_sincos(periods, 4, 4),
                                                 rope_sincos(periods, 4, 4, **kw)))
    cfg = VTPConfig(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=1,
                    vision_num_heads=1, vision_feature_bottleneck=16, decoder_embed_dim=64,
                    decoder_num_heads=1, decoder_depth=1, train_clip=False,
                    rope_shift_coords=0.1, rope_jitter_coords=1.2, rope_rescale_coords=2.0)
    trunk = VTPModel.init(cfg, torch.Generator().manual_seed(0), device="cpu").trunk
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(1))

    def tokens(**kw):
        with torch.no_grad():
            return trunk.forward_features(x, **kw)["x_norm_patchtokens"]

    plain = tokens()
    assert torch.equal(tokens(generator=torch.Generator().manual_seed(2)), plain)
    assert torch.equal(tokens(training=True), plain)
    assert not torch.equal(tokens(training=True, generator=torch.Generator().manual_seed(2)),
                           plain)


def test_draw_rope_coords_ranges_and_order():
    """Only the configured factors are drawn, within their ranges; the same
    seed draws the same factors."""
    g = torch.Generator().manual_seed(0)
    draws = [draw_rope_coords(g, 0.1, 1.2, 2.0) for _ in range(200)]
    shift = torch.stack([d["shift"] for d in draws])
    jitter = torch.stack([d["jitter"] for d in draws])
    rescale = torch.stack([d["rescale"] for d in draws])
    assert shift.shape == (200, 2) and rescale.shape == (200, 1)
    assert shift.abs().max() <= 0.1 and shift.min() < -0.05 and shift.max() > 0.05
    assert jitter.min() >= 1 / 1.2 - 1e-6 and jitter.max() <= 1.2 + 1e-6
    assert rescale.min() >= 0.5 - 1e-6 and rescale.max() <= 2.0 + 1e-6
    assert set(draw_rope_coords(g, None, 1.2, None)) == {"jitter"}
    again = draw_rope_coords(torch.Generator().manual_seed(0), 0.1, 1.2, 2.0)
    assert all(torch.equal(again[k], draws[0][k]) for k in again)
