"""Port ops (norms, FFNs, patchify, pixel shuffle, RoPE) against their
JAX counterparts on the CPU: fp32 within 5e-4 abs, bf16 within 5e-2 rel,
RoPE tables bit-identical."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.ops import activations as j_act
from vtp_tpu.ops import ffn as j_ffn
from vtp_tpu.ops import norms as j_norms
from vtp_tpu.ops import rope as j_rope
from vtp_tpu_torch.ops import activations as t_act
from vtp_tpu_torch.ops import ffn as t_ffn
from vtp_tpu_torch.ops import norms as t_norms
from vtp_tpu_torch.ops import patchify as t_patch
from vtp_tpu_torch.ops import rope as t_rope

j_patch = importlib.import_module("vtp_tpu.ops.patchify")  # vtp_tpu.ops re-exports a function of this name
torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if dtype == "bf16":
        assert err <= BF16_REL * np.abs(want).max(), err
    else:
        assert err <= F32_ABS, err


def _pair(a, dtype):
    return (torch.tensor(a).to(torch.bfloat16 if dtype == "bf16" else torch.float32),
            jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernormbf16"])
def test_norms_match_jax(dtype, kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32) * 2 + 0.5
    w = rng.standard_normal(128).astype(np.float32) * 0.1 + 1
    b = rng.standard_normal(128).astype(np.float32) * 0.1
    tx, jx = _pair(x, dtype)
    eps = t_norms.norm_eps(kind)
    assert eps == j_norms.norm_eps(kind)
    bias = None if kind == "rmsnorm" else b
    got = t_norms.apply_norm(tx, torch.tensor(w), None if bias is None else torch.tensor(bias), kind, eps)
    params = {"scale": jnp.asarray(w)} | ({} if bias is None else {"bias": jnp.asarray(bias)})
    want = j_norms.apply_norm(jx, params, kind, eps)
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(want.dtype)]
    _close(got, want, dtype)


def _linear(w, b):
    layer = torch.nn.Linear(w.shape[0], w.shape[1], bias=b is not None)
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(w.T))
        if b is not None:
            layer.bias.copy_(torch.tensor(b))
    return layer


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("bias", [True, False])
def test_swiglu_matches_jax(compute, bias):
    rng = np.random.default_rng(2)
    dim = 128
    hidden = t_ffn.swiglu_hidden_dim(dim, 4.0)
    x = rng.standard_normal((2, 7, dim)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.05
          for s in ((dim, hidden), (dim, hidden), (hidden, dim))]
    bs = [rng.standard_normal(s[1]).astype(np.float32) * 0.05 if bias else None
          for s in ((dim, hidden), (dim, hidden), (hidden, dim))]
    cd = (torch.bfloat16, jnp.bfloat16) if compute == "bf16" else (None, None)
    got = t_ffn.swiglu(torch.tensor(x), *(_linear(w, b) for w, b in zip(ws, bs)), compute_dtype=cd[0])
    params = {n: {"kernel": jnp.asarray(w), "bias": None if b is None else jnp.asarray(b)}
              for n, w, b in zip(("w1", "w2", "w3"), ws, bs)}
    _close(got, j_ffn.swiglu(jnp.asarray(x), params, cd[1]), compute)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu", "silu"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w1, w2 = (rng.standard_normal(s).astype(np.float32) * 0.1 for s in ((64, 256), (256, 64)))
    b1, b2 = rng.standard_normal(256).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    got = t_ffn.mlp(torch.tensor(x), _linear(w1, b1), _linear(w2, b2), t_act.ACT[act])
    params = {"fc1": {"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)},
              "fc2": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}}
    _close(got, j_ffn.mlp(jnp.asarray(x), params, j_act.ACT[act]), "fp32")


@pytest.mark.parametrize("dim,ratio,layer", [(128, 4.0, "swiglu"), (1024, 4.0, "swiglu"),
                                             (1152, 3.777777778, "swiglu64"), (384, 4.0, "swiglu128")])
def test_ffn_hidden_dims_match_jax(dim, ratio, layer):
    assert t_ffn.ffn_align_to(layer) == j_ffn.ffn_align_to(layer)
    align = t_ffn.ffn_align_to(layer)
    assert t_ffn.swiglu_hidden_dim(dim, ratio, align) == j_ffn.swiglu_hidden_dim(dim, ratio, align)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_patchify_matches_jax(compute):
    rng = np.random.default_rng(4)
    p, dim = 16, 128
    img = rng.standard_normal((2, 3, 64, 48)).astype(np.float32)
    w = rng.standard_normal((dim, 3, p, p)).astype(np.float32) * 0.02
    b = rng.standard_normal(dim).astype(np.float32) * 0.02
    cd = (torch.bfloat16, jnp.bfloat16) if compute == "bf16" else (None, None)
    got = t_patch.patchify(torch.tensor(img), torch.tensor(w), torch.tensor(b), patch=p,
                           compute_dtype=cd[0])
    want = j_patch.patchify(jnp.asarray(img), jnp.asarray(w.reshape(dim, -1).T), jnp.asarray(b),
                            patch=p, compute_dtype=cd[1])
    _close(got, want, compute)
    # the GEMM form equals the reference's strided convolution
    conv = torch.nn.functional.conv2d(torch.tensor(img), torch.tensor(w), torch.tensor(b), stride=p)
    _close(got.float(), conv.flatten(2).transpose(1, 2), compute)


@pytest.mark.parametrize("r", [2, 16])
def test_pixel_shuffle_matches_jax(r):
    x = np.random.default_rng(5).standard_normal((2, 3 * r * r, 4, 5)).astype(np.float32)
    got = t_patch.pixel_shuffle(torch.tensor(x), r)
    np.testing.assert_array_equal(_np(got), _np(j_patch.pixel_shuffle(jnp.asarray(x), r)))
    np.testing.assert_array_equal(_np(got), _np(torch.nn.functional.pixel_shuffle(torch.tensor(x), r)))


def test_patch_tokens_to_4d_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 20, 7)).astype(np.float32)
    got = t_patch.patch_tokens_to_4d(torch.tensor(x), 4, 5)
    np.testing.assert_array_equal(_np(got), _np(j_patch.patch_tokens_to_4d(jnp.asarray(x), 4, 5)))
    with pytest.raises(ValueError):
        t_patch.patch_tokens_to_4d(torch.tensor(x), 4, 4)


@pytest.mark.parametrize("kw", [dict(base=100.0), dict(base=None, min_period=0.5, max_period=50.0)])
@pytest.mark.parametrize("head_dim", [64, 32])
def test_rope_periods_bit_identical(kw, head_dim):
    t = t_rope.rope_periods_init(head_dim, **kw)
    j = j_rope.rope_periods_init(head_dim, **kw)
    np.testing.assert_array_equal(_np(t), _np(j))


@pytest.mark.parametrize("grid", [(16, 16), (14, 14), (16, 8)])
@pytest.mark.parametrize("normalize", ["separate", "max", "min"])
@pytest.mark.parametrize("prefix", [0, 1])
def test_rope_tables_bit_identical(grid, normalize, prefix):
    H, W = grid
    t = t_rope.pad_rope_prefix(*t_rope.rope_sincos(t_rope.rope_periods_init(64), H, W,
                                                   normalize_coords=normalize), prefix)
    # the JAX model builds its tables under jit
    fn = jax.jit(lambda p: j_rope.pad_rope_prefix(*j_rope.rope_sincos(
        p, H, W, normalize_coords=normalize), prefix))
    j = fn(j_rope.rope_periods_init(64))
    for a, b in zip(t, j):
        assert a.dtype == torch.bfloat16 and a.shape == (prefix + H * W, 64)
        np.testing.assert_array_equal(_np(a), _np(b))


def test_rope_apply_bit_identical_in_bf16():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 17, 2, 64)).astype(np.float32)
    s, c = t_rope.pad_rope_prefix(*t_rope.rope_sincos(t_rope.rope_periods_init(64), 4, 4), 1)
    got = t_rope.rope_apply(torch.tensor(x).bfloat16(), s[None, :, None], c[None, :, None])
    want = j_rope.rope_apply(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(_np(s), jnp.bfloat16)[None, :, None],
                             jnp.asarray(_np(c), jnp.bfloat16)[None, :, None])
    np.testing.assert_array_equal(_np(got), _np(want))
