"""The port's ``models/extras.py`` against ``vtp_tpu.models.extras`` on the
CPU, every module on the same weights (the JAX init, every leaf moved off
it so that norms, biases and scales show, loaded with ``load_jax``):
``CausalBlock`` causal and not, ``CustomAttention`` with and without the
scaled-cosine branch (a ``logit_scale`` above the log(100) clamp), the head
scale and an additive mask, ``CustomResidualAttentionBlock`` with every
option, ``CustomTransformer``, ``AttentionalPooler``, ``patch_dropout``
fed the JAX scores (bit-equal), and the multimodal tower, in fp32 and bf16.
Gates: fp32 5e-4 abs, bf16 5e-2 of max|ref|.

Routing, as the JAX ``sdpa``: the bf16 ``CustomTransformer`` without a mask
takes ``flash_attention`` at every layer in both packages (JAX's Pallas
kernel in interpret mode); the multimodal tower's masked self-attention
and its cross-attention take no kernel in either."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.models import extras as jx
from vtp_tpu.ops import flash_attention as jfa
from vtp_tpu_torch.models import extras as ex
from vtp_tpu_torch.models import text_encoder as te
from vtp_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
DIM, HEADS = 64, 2  # head dim 32: the flash kernel's gate holds
DTYPES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _inference():
    """Forward passes only: ``flash_attention`` has no backward (nor has the
    JAX function), so it refuses inputs that ask for a gradient."""
    with torch.no_grad():
        yield


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    limit = BF16_REL * np.abs(want).max() if dtype == "bf16" else F32_ABS
    assert err <= limit, (err, limit)


def _perturbed(params, seed, scale=0.05):
    """The JAX tree as numpy, every leaf moved off its init."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a)))
                        .astype(np.float32), params)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _count(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(name) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("is_causal", [True, False])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("ls", [None, 0.3])
def test_causal_block_matches_jax(is_causal, dtype, ls):
    p = _perturbed(jx.init_causal_block_params(jax.random.key(0), DIM, ls_init_value=ls), 1)
    block = ex.CausalBlock(DIM, HEADS, ls_init_value=ls, device="cpu").load_jax(p)
    x = _x((2, 9, DIM), 2)
    jdt, tdt = DTYPES[dtype]
    want = jx.causal_block_apply(jnp.asarray(x), p, HEADS, is_causal, jdt)
    got = block(torch.from_numpy(x), is_causal, tdt)
    _check(got, want, dtype)


def _mask(n, seed):
    """An additive mask: the causal -inf band plus finite noise."""
    m = np.triu(np.full((n, n), -np.inf, np.float32), 1)
    return m + 0.5 * _x((n, n), seed)


@pytest.mark.parametrize("cosine,heads_scale", [(False, False), (True, False), (False, True),
                                                (True, True)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_custom_attention_matches_jax(cosine, heads_scale, masked, dtype):
    p = _perturbed(jx.init_custom_attention_params(jax.random.key(1), DIM, HEADS, cosine,
                                                   heads_scale), 3)
    if cosine:
        p["logit_scale"][0] = math.log(300.0)  # above log(1 / 0.01): clamped
    attn = ex.CustomAttention(DIM, HEADS, cosine, heads_scale, device="cpu").load_jax(p)
    x, mask = _x((2, 7, DIM), 4), _mask(7, 5) if masked else None
    jdt, tdt = DTYPES[dtype]
    want = jx.custom_attention_apply(jnp.asarray(x), p, HEADS,
                                     None if mask is None else jnp.asarray(mask),
                                     compute_dtype=jdt)
    got = attn(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), tdt)
    _check(got, want, dtype)


BLOCK_OPTIONS = {
    "plain": {},
    "all": dict(ls_init_value=0.2, scale_cosine_attn=True, scale_heads=True, scale_attn=True,
                scale_fc=True),
    "cosine_ls": dict(ls_init_value=0.5, scale_cosine_attn=True),
    "norms": dict(scale_attn=True, scale_fc=True, scale_heads=True),
}


@pytest.mark.parametrize("options", sorted(BLOCK_OPTIONS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_custom_resblock_matches_jax(options, dtype):
    kw = BLOCK_OPTIONS[options]
    p = _perturbed(jx.init_custom_resblock_params(jax.random.key(2), DIM, HEADS, **kw), 6)
    block = ex.CustomResidualAttentionBlock(DIM, HEADS, device="cpu", **kw).load_jax(p)
    x, mask = _x((2, 6, DIM), 7), _mask(6, 8)
    jdt, tdt = DTYPES[dtype]
    for m in (None, mask):
        want = jx.custom_resblock_apply(jnp.asarray(x), p, HEADS,
                                        None if m is None else jnp.asarray(m), jdt)
        got = block(torch.from_numpy(x), None if m is None else torch.from_numpy(m), tdt)
        _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_custom_transformer_matches_jax_and_routes_as_jax(dtype, masked, kernels, monkeypatch):
    kernels(interpret=True)
    layers = 2
    p = _perturbed(jx.init_custom_transformer_params(jax.random.key(3), DIM, layers, HEADS,
                                                     ls_init_value=0.4), 9)
    model = ex.CustomTransformer(DIM, layers, HEADS, device="cpu", ls_init_value=0.4).load_jax(p)
    x, mask = _x((2, 8, DIM), 10), _mask(8, 11) if masked else None
    jdt, tdt = DTYPES[dtype]
    jax_calls = _count(monkeypatch, jfa, "flash_attention")
    port_calls = _count(monkeypatch, fa, "_flash_forward")
    want = jx.custom_transformer_forward(p, jnp.asarray(x), HEADS,
                                         None if mask is None else jnp.asarray(mask), jdt)
    got = model(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), tdt)
    _check(got, want, dtype)
    flash = dtype == "bf16" and not masked
    assert len(port_calls) == (layers if flash else 0)
    assert bool(jax_calls) == flash


@pytest.mark.parametrize("in_dtype", ["fp32", "bf16"])
def test_attentional_pooler_matches_jax(in_dtype):
    p = _perturbed(jx.init_attentional_pooler_params(jax.random.key(4), DIM, 48, n_queries=8), 12)
    pooler = ex.AttentionalPooler(DIM, 48, n_head=HEADS, n_queries=8, device="cpu").load_jax(p)
    x = _x((2, 10, 48), 13)
    jx_in = jnp.asarray(x).astype(jnp.bfloat16) if in_dtype == "bf16" else jnp.asarray(x)
    t_in = torch.from_numpy(x).to(torch.bfloat16 if in_dtype == "bf16" else torch.float32)
    want = jx.attentional_pooler_apply(jx_in, p, HEADS)
    got = pooler(t_in)
    assert got.dtype == torch.float32
    _check(got, want, in_dtype)


@pytest.mark.parametrize("prob", [0.0, 0.3, 0.75, 0.99])
@pytest.mark.parametrize("exclude_first", [True, False])
def test_patch_dropout_matches_jax_on_the_same_scores(prob, exclude_first):
    x = _x((3, 11, 5), 14)
    key = jax.random.key(5)
    want = np.asarray(jx.patch_dropout(key, jnp.asarray(x), prob, exclude_first))
    if prob == 0.0:
        got = ex.patch_dropout(torch.from_numpy(x), prob, exclude_first)
    else:
        n = x.shape[1] - (1 if exclude_first else 0)
        scores = np.array(jax.random.normal(key, (3, n)))  # the draws JAX made
        got = ex.patch_dropout_select(torch.from_numpy(x), torch.from_numpy(scores), prob,
                                      exclude_first)
    np.testing.assert_array_equal(got.numpy(), want)


def test_patch_dropout_draws_from_a_generator():
    x = torch.from_numpy(_x((2, 17, 4), 15))
    out = ex.patch_dropout(x, 0.5, generator=torch.Generator().manual_seed(0))
    again = ex.patch_dropout(x, 0.5, generator=torch.Generator().manual_seed(0))
    assert tuple(out.shape) == (2, 1 + 8, 4) and torch.equal(out, again)
    assert torch.equal(out[:, 0], x[:, 0])  # the first token stays in front
    assert ex.patch_dropout(x, 0.5, training=False) is x


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_multimodal_transformer_matches_jax_and_launches_no_kernel(dtype, kernels, monkeypatch):
    kernels(interpret=True)
    layers, out_dim = 2, 32
    p = _perturbed(jx.init_multimodal_transformer_params(jax.random.key(6), DIM, layers,
                                                         output_dim=out_dim), 16)
    model = ex.MultimodalTransformer(DIM, layers, HEADS, output_dim=out_dim, context_length=16,
                                     device="cpu").load_jax(p)
    image, text = _x((2, 12, DIM), 17), _x((2, 7, DIM), 18)
    jdt, tdt = DTYPES[dtype]
    spies = [_count(monkeypatch, jfa, "flash_attention"),
             _count(monkeypatch, jfa, "fused_qkv_rope_attention"),
             _count(monkeypatch, fa, "_flash_forward"),
             _count(monkeypatch, te, "fused_qkv_rope_attention")]
    want = jx.multimodal_transformer_forward(p, jnp.asarray(image), jnp.asarray(text), HEADS,
                                             context_length=16, compute_dtype=jdt)
    got = model(torch.from_numpy(image), torch.from_numpy(text), tdt)
    _check(got, want, dtype)
    assert tuple(got.shape) == (2, 7, out_dim)
    assert not any(spies)


def test_reset_parameters_draws_the_jax_init_distributions():
    gen = torch.Generator().manual_seed(0)
    mm = ex.MultimodalTransformer(256, 2, 4, output_dim=64, device="cpu").reset_parameters(gen)
    w = 256
    assert torch.equal(mm.ln_final.weight, torch.ones(w)) and not mm.ln_final.bias.any()
    for tensor, std in ((mm.resblocks[0].attn.in_proj_weight, w ** -0.5),
                        (mm.cross_attn[1].mlp.c_fc.weight, (2 * w) ** -0.5),
                        (mm.cross_attn[0].mlp.c_proj.weight, w ** -0.5 * 4 ** -0.5),
                        (mm.text_projection, w ** -0.5)):
        assert abs(tensor.std().item() / std - 1) < 0.05
    ct = ex.CustomTransformer(64, 1, 2, device="cpu", scale_cosine_attn=True,
                              scale_heads=True).reset_parameters(gen)
    attn = ct.resblocks[0].attn
    assert torch.allclose(attn.logit_scale, torch.full((2, 1, 1), math.log(10.0)))
    assert torch.equal(attn.head_scale, torch.ones(2, 1, 1))
    pooler = ex.AttentionalPooler(64, 48, n_queries=512, device="cpu").reset_parameters(gen)
    assert abs(pooler.query.std().item() - 1) < 0.05
    block = ex.CausalBlock(64, 2, ls_init_value=0.1, device="cpu").reset_parameters(gen)
    assert torch.equal(block.ls1.gamma, torch.full((64,), 0.1))
    assert all(torch.isfinite(t).all() for t in (*mm.parameters(), *ct.parameters(),
                                                 *pooler.parameters(), *block.parameters()))
