"""The port's blocks, trunk, decoder and roundtrip against the JAX
package on the CPU, with the JAX weights carried across through
``export_state_dict``: fp32 within 5e-4 abs, bf16 encode within 5e-2 rel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import _blocks_out, export_state_dict
from vtp_tpu.models.blocks import BlockConfig as JaxBlockConfig
from vtp_tpu.models.blocks import block_apply, init_stacked_blocks
from vtp_tpu.models.pixel_decoder import pixel_decoder_forward
from vtp_tpu.models.vit import vit_forward_features
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.models.vtp_model import decoder_config_from, vit_config_from
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.models.blocks import Block, BlockConfig
from vtp_tpu_torch.models.pixel_decoder import exact_fp32
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
TINY = dict(image_size=64, vision_embed_dim=128, vision_depth=2, vision_num_heads=2,
            decoder_embed_dim=128, decoder_depth=2, decoder_num_heads=2,
            text_embed_dim=64, text_depth=1, text_num_heads=1, text_vocab_size=512,
            text_context_length=16)
VARIANT = dict(TINY, train_clip=False, vision_n_storage_tokens=4, vision_untie_cls_and_patch_norms=True,
               vision_mask_k_bias=True, vision_init_values=0.5, decoder_init_values=0.5)
QK_NORM = dict(TINY, train_clip=False, vision_use_qk_norm=True, decoder_use_qk_norm=True)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, gate):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if gate == "bf16":
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())
    else:
        assert err <= F32_ABS, err


def _pair(overrides, seed=0):
    jc = JaxConfig(**overrides)
    jm = JaxModel.init(jax.random.key(seed), jc)
    sd = export_state_dict(jm.params, jc)
    tm = VTPModel(VTPConfig(**overrides), device="cpu")
    tm.load_numpy_state_dict(sd)
    return jc, jm, sd, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)


# ------------------------------------------------------------ weight bridge


def test_bridge_sets_aside_unbuilt_towers(tiny):
    _, _, sd, tm = tiny
    assert any(k.startswith("text_transformer.") for k in sd) and "logit_scale" in sd
    own = tm.state_dict()
    for name in ("trunk.blocks.1.attn.qkv.weight", "pixel_decoder.proj_in.weight", "trunk.cls_token"):
        np.testing.assert_array_equal(own[name].numpy(), sd[name])
    periods = own["trunk.rope_embed.periods"]
    assert periods.dtype == torch.bfloat16
    np.testing.assert_array_equal(periods.float().numpy(), sd["trunk.rope_embed.periods"])


def test_bridge_rejects_an_unexpected_key(tiny):
    _, _, sd, _ = tiny
    model = VTPModel(VTPConfig(**TINY), device="cpu")
    with pytest.raises(KeyError, match="trunk.blocks.0.attn.extra"):
        model.load_numpy_state_dict({**sd, "trunk.blocks.0.attn.extra": np.zeros(3, np.float32)})


def test_bridge_rejects_a_missing_key(tiny):
    _, _, sd, _ = tiny
    model = VTPModel(VTPConfig(**TINY), device="cpu")
    partial = {k: v for k, v in sd.items() if k != "pixel_decoder.norm.weight"}
    with pytest.raises(KeyError, match="pixel_decoder.norm.weight"):
        model.load_numpy_state_dict(partial)


def test_bridge_rejects_a_shape_mismatch(tiny):
    _, _, sd, _ = tiny
    model = VTPModel(VTPConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="trunk.norm.weight"):
        model.load_numpy_state_dict({**sd, "trunk.norm.weight": np.ones(64, np.float32)})


def test_k_bias_mask_in_a_checkpoint_is_folded_into_the_bias():
    _, _, sd, _ = _pair(VARIANT)
    mask = np.concatenate([np.ones(128), np.zeros(128), np.ones(128)]).astype(np.float32)
    model = VTPModel(VTPConfig(**VARIANT), device="cpu")
    model.load_numpy_state_dict({**sd, "trunk.blocks.0.attn.qkv.bias_mask": mask})
    np.testing.assert_array_equal(model.state_dict()["trunk.blocks.0.attn.qkv.bias"].numpy(),
                                  sd["trunk.blocks.0.attn.qkv.bias"] * mask)


# ------------------------------------------------------------------ modules


BLOCK_VARIANTS = {
    "swiglu_rmsnorm": dict(norm_kind="rmsnorm"),
    "qk_norm_layerscale": dict(norm_kind="rmsnorm", use_qk_norm=True, layerscale_init=0.5),
    "mlp_layernorm_kmask": dict(norm_kind="layernorm", ffn_layer="mlp", mask_k_bias=True),
}


@pytest.mark.parametrize("variant", list(BLOCK_VARIANTS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_block_matches_jax(variant, dtype):
    kw = dict(dim=128, num_heads=2, **BLOCK_VARIANTS[variant])
    jcfg = JaxBlockConfig(**kw)
    stacked = init_stacked_blocks(jax.random.key(1), jcfg, 1)
    stacked = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(jax.random.key(2), a.shape), stacked)
    sd = {}
    _blocks_out(sd, "b", stacked, 1)
    block = Block(BlockConfig(**kw))
    block.load_state_dict({k[len("b.0."):]: torch.tensor(v) for k, v in sd.items()})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 17, 128)).astype(np.float32)
    sin, cos = pad_rope_prefix(*rope_sincos(rope_periods_init(64), 4, 4), 1)
    jrope = tuple(jnp.asarray(_f32(t), jnp.bfloat16) for t in (sin, cos))
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bf16" else (None, None)
    tx = torch.tensor(x).to(tdt or torch.float32)
    got = block(tx, (sin, cos), 17, tdt)
    (want,) = block_apply((jnp.asarray(x, jdt or jnp.float32),), jax.tree.map(lambda a: a[0], stacked),
                          jcfg, [jrope], compute_dtype=jdt)
    _check(got, want, dtype)


def _jax_features(jm, jc, img, dtype):
    fn = jax.jit(functools.partial(vit_forward_features, cfg=vit_config_from(jc), use_bottleneck=True,
                                   compute_dtype=dtype))
    return fn(jm.params["trunk"], images=jnp.asarray(img))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_trunk_matches_jax(tiny, images, dtype):
    jc, jm, _, tm = tiny
    want = _jax_features(jm, jc, images, jnp.bfloat16 if dtype == "bf16" else None)
    got = tm.trunk.forward_features(torch.tensor(images), use_bottleneck=True,
                                    compute_dtype=torch.bfloat16 if dtype == "bf16" else None)
    for key in ("x_norm_clstoken", "x_norm_patchtokens", "x_prenorm"):
        _check(got[key], want[key], dtype)


def test_trunk_variant_matches_jax(images):
    jc, jm, _, tm = _pair(VARIANT, seed=4)
    want = _jax_features(jm, jc, images, None)
    got = tm.trunk.forward_features(torch.tensor(images), use_bottleneck=True)
    for key in ("x_norm_clstoken", "x_storage_tokens", "x_norm_patchtokens", "x_prenorm"):
        _check(got[key], want[key], "fp32")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_trunk_qk_norm_matches_jax(images, dtype):
    """With qk-norm, RoPE (bf16 arithmetic) follows an fp32 RMSNorm whose
    mean of squares torch and XLA sum in different orders; an ulp there
    can flip a bf16 rounding of q or k, so both arms are held to the bf16
    gate."""
    jc, jm, _, tm = _pair(QK_NORM, seed=4)
    want = _jax_features(jm, jc, images, jnp.bfloat16 if dtype == "bf16" else None)
    got = tm.trunk.forward_features(torch.tensor(images), use_bottleneck=True,
                                    compute_dtype=torch.bfloat16 if dtype == "bf16" else None)
    for key in ("x_norm_clstoken", "x_norm_patchtokens", "x_prenorm"):
        _check(got[key], want[key], "bf16")


@pytest.mark.parametrize("overrides", [TINY, VARIANT, QK_NORM], ids=["tiny", "variant", "qk_norm"])
def test_decoder_matches_jax(overrides):
    jc, jm, _, tm = _pair(overrides, seed=5)
    lat = np.random.default_rng(6).standard_normal((2, 64, 4, 4)).astype(np.float32)
    fn = jax.jit(functools.partial(pixel_decoder_forward, cfg=decoder_config_from(jc)))
    want = fn(jm.params["pixel_decoder"], latents=jnp.asarray(lat))
    got = tm.pixel_decoder(torch.tensor(lat))
    assert got.dtype == torch.float32
    _check(got, want, "fp32")


def test_roundtrip_matches_jax(tiny, images):
    jc, jm, _, tm = tiny
    j_lat = jm.get_reconstruction_latents(jnp.asarray(images))
    t_lat = tm.get_reconstruction_latents(torch.tensor(images))
    assert t_lat.dtype == torch.bfloat16 and t_lat.shape == (2, 64, 4, 4)
    _check(t_lat, j_lat, "bf16")
    # decode the same latents in both
    lat = _f32(j_lat)
    want = jm.get_latents_decoded_images(jnp.asarray(lat))
    got = tm.get_latents_decoded_images(torch.tensor(lat))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 64, 64)
    _check(got, want, "fp32")
    # and the fp32 encode
    j32 = JaxModel(jc, jm.params, encode_dtype=None).get_reconstruction_latents(jnp.asarray(images))
    tm32 = VTPModel(VTPConfig(**TINY), device="cpu", encode_dtype=None)
    tm32.load_state_dict(tm.state_dict())
    _check(tm32.get_reconstruction_latents(torch.tensor(images)), j32, "fp32")


def test_decode_refuses_the_unported_high_precision(tiny):
    """"high" is ported (tests/test_torch_serving.py); a precision that is
    neither it nor "float32" (JAX's "tensorfloat32" alias, torch's
    single-pass TF32 "medium") is refused."""
    *_, tm = tiny
    for precision in ("tensorfloat32", "medium"):
        with pytest.raises(ValueError, match="precision"):
            tm.get_latents_decoded_images(torch.zeros(1, 64, 4, 4), precision=precision)


def test_exact_fp32_turns_tf32_off_and_restores_it():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with exact_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_random_init_is_seeded_and_runs_on_the_cpu(images):
    cfg = VTPConfig(**TINY)
    a = VTPModel.init(cfg, torch.Generator().manual_seed(7), device="cpu")
    b = VTPModel.init(cfg, torch.Generator().manual_seed(7), device="cpu")
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    w = a.trunk.blocks[0].attn.qkv.weight
    assert w.abs().max() <= 0.04 and 0.01 < w.std() < 0.02
    assert torch.equal(a.trunk.rope_embed.periods, rope_periods_init(64))
    lat = a.get_reconstruction_latents(torch.tensor(images))
    rec = a.get_latents_decoded_images(lat)
    assert torch.isfinite(lat.float()).all() and torch.isfinite(rec).all()
    assert rec.shape == (2, 3, 64, 64)
