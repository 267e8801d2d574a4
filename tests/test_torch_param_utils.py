"""The port's serving-time parameter transforms and small utilities against
the JAX package on the CPU (``vtp_tpu_torch.utils.{params,buckets,misc}``
against ``vtp_tpu.utils.{params,buckets,misc}``), on the same weights
(carried across with ``export_state_dict``) and numpy inputs:

- ``cast_matmul_params``: the bf16 encode of the cast trunk bit-equal to the
  per-call cast, the norm weights, tokens and RoPE periods unchanged and
  shared, the source model unchanged; the bytes JAX's cast keeps, but for
  the LayerNorm biases that the JAX function casts and the port keeps in
  fp32 (named below);
- ``fuse_ffn_params``: the fused SwiGLU against JAX's fused ``swiglu``
  within 1e-6 of max|ref| in fp32, the fused model's fp32 encode and
  decode against the JAX fused model's (the fp32 gate, 5e-4 abs) and
  against the unfused port model (1e-6 of max|ref|), and fused then
  quantized;
- ``param_count`` and ``tree_bytes`` equal to JAX's on the same config,
  int8 included;
- the buckets, the dtype map and the packing cases of
  ``tests/test_misc_utils.py``, and the rest of ``misc``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.ops.ffn import swiglu as jax_swiglu
from vtp_tpu.utils import buckets as jbuckets
from vtp_tpu.utils import misc as jmisc
from vtp_tpu.utils import params as jparams
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.models.blocks import SwiGLUFFN, pack, unpack
from vtp_tpu_torch.utils import buckets, misc
from vtp_tpu_torch.utils.params import (
    cast_matmul_params,
    fuse_ffn_params,
    param_count,
    tree_bytes,
)
from vtp_tpu_torch.utils.quantization import Int8Weight, quantize_matmul_params, shallow_copy

torch.set_num_threads(1)
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=12,
            text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
# storage tokens, LayerScale and the K-masked bias change the leaves counted
VARIANT = dict(TINY, vision_n_storage_tokens=2, vision_init_values=1e-5, vision_mask_k_bias=True)


def _pair(overrides, **kw):
    jc = JaxConfig(**overrides)
    jm = JaxModel.init(jax.random.key(0), jc, **kw)
    tm = VTPModel(VTPConfig(**overrides), device="cpu", **kw)
    tm.load_numpy_state_dict(export_state_dict(jm.params, jc))
    return jm, tm


def _with(model, **parts):
    new = shallow_copy(model)
    for name, module in parts.items():
        setattr(new, name, module)
    return new


@pytest.fixture(scope="module")
def pair():
    return _pair(TINY)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)


def test_cast_trunk_encodes_bit_equal_and_keeps_fp32_leaves(pair, images):
    _, tm = pair
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    trunk = cast_matmul_params(tm.trunk)
    x = torch.tensor(images)
    assert torch.equal(_with(tm, trunk=trunk).get_reconstruction_latents(x),
                       tm.get_reconstruction_latents(x))
    blk, cblk = tm.trunk.blocks[0], trunk.blocks[0]
    for lin in (cblk.attn.qkv, cblk.attn.proj, cblk.mlp.w1, cblk.mlp.w3,
                trunk.patch_embed.proj, trunk.feature_bottleneck):
        assert lin.weight.dtype == torch.bfloat16
    assert cblk.attn.qkv.bias.dtype == torch.bfloat16
    assert cblk.norm1.weight is blk.norm1.weight and trunk.cls_token is tm.trunk.cls_token
    assert trunk.rope_embed.periods is tm.trunk.rope_embed.periods
    assert trunk.norm.weight.dtype == torch.float32
    after = tm.state_dict()
    assert all(after[k].dtype == v.dtype and torch.equal(after[k], v) for k, v in before.items())


def test_cast_bytes_match_jax_but_for_layernorm_biases(pair):
    """JAX's cast takes every fp32 leaf named "bias", LayerNorm's too; the
    port keeps norm biases in fp32 (2 bytes more per element). The trunk
    (RMSNorm) matches exactly; the text tower (ln_1, ln_2 a block, ln_final)
    and the decoder (norm1, norm2 a block, norm) differ by exactly those."""
    jm, tm = pair
    cfg = tm.config
    ln_bias = {"trunk": 0,
               "text": (2 * cfg.text_depth + 1) * cfg.text_embed_dim,
               "pixel_decoder": (2 * cfg.decoder_depth + 1) * cfg.decoder_embed_dim}
    for part, n in ln_bias.items():
        want = jparams.tree_bytes(jparams.cast_matmul_params(jm.params[part], jnp.bfloat16))
        assert tree_bytes(cast_matmul_params(getattr(tm, part))) == want + 2 * n, part


def test_cast_weights_meet_fp32_inputs_in_fp32(images):
    """An fp32 encode (no compute dtype) of a cast trunk: the bf16 weights and
    the fp32 activations meet in fp32, as JAX promotes them."""
    jm, tm = _pair(TINY, encode_dtype=None)
    jp = dict(jm.params, trunk=jparams.cast_matmul_params(jm.params["trunk"], jnp.bfloat16))
    want = JaxModel(jm.config, jp, encode_dtype=None).get_reconstruction_latents(
        jnp.asarray(images))
    got = _with(tm, trunk=cast_matmul_params(tm.trunk)).get_reconstruction_latents(
        torch.tensor(images))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 5e-4


def test_fused_swiglu_matches_jax():
    rng = np.random.default_rng(1)
    ffn = SwiGLUFFN(48, 96, bias=True)
    with torch.no_grad():
        for p in ffn.parameters():
            p.copy_(torch.tensor(0.1 * rng.standard_normal(tuple(p.shape)), dtype=torch.float32))
    lin = lambda m: {"kernel": jnp.asarray(m.weight.detach().numpy().T),
                     "bias": jnp.asarray(m.bias.detach().numpy())}
    jp = jparams.fuse_ffn_params({"mlp": {"w1": lin(ffn.w1), "w2": lin(ffn.w2),
                                          "w3": lin(ffn.w3)}})["mlp"]
    assert set(jp) == {"w12", "w3"}
    fused = fuse_ffn_params(ffn)
    assert fused.w1 is None and fused.w2 is None and ffn.w1 is not None
    assert fused.w3 is ffn.w3 and tuple(fused.w12.weight.shape) == (192, 48)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    want = np.asarray(jax_swiglu(jnp.asarray(x), jp))
    got = fused(torch.tensor(x)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(ffn(torch.tensor(x)).detach().numpy() - got).max() <= 1e-6 * np.abs(got).max()


def test_fused_model_matches_jax_and_the_unfused(images):
    """Trunk and decoder fused, fp32 encode and exact decode, against the JAX
    model with ``fuse_ffn_params`` on the same towers; then fused and
    quantized (the int8 tier takes the fused ``w12``)."""
    jm, tm = _pair(TINY, encode_dtype=None)
    jp = dict(jm.params)
    for part in ("trunk", "pixel_decoder"):
        jp[part] = jparams.fuse_ffn_params(jp[part])
    jf = JaxModel(jm.config, jp, encode_dtype=None)
    tf = _with(tm, trunk=fuse_ffn_params(tm.trunk),
               pixel_decoder=fuse_ffn_params(tm.pixel_decoder))
    x = torch.tensor(images)
    lat = tf.get_reconstruction_latents(x)
    rec = tf.get_latents_decoded_images(lat)
    want_lat = np.asarray(jf.get_reconstruction_latents(jnp.asarray(images)))
    want_rec = np.asarray(jf.get_latents_decoded_images(want_lat))
    assert np.abs(lat.numpy() - want_lat).max() <= 5e-4
    assert np.abs(rec.numpy() - want_rec).max() <= 5e-4
    ref = tm.get_reconstruction_latents(x)
    assert (lat - ref).abs().max() <= 1e-6 * ref.abs().max()
    q = quantize_matmul_params(tf.trunk)
    assert isinstance(q.blocks[0].mlp.w12.weight, Int8Weight)
    ql = _with(tf, trunk=q).get_reconstruction_latents(x)
    cos = torch.nn.functional.cosine_similarity(ql.ravel(), ref.ravel(), dim=0)
    assert cos > 0.99


@pytest.mark.parametrize("overrides", [TINY, VARIANT], ids=["tiny", "variant"])
def test_param_count_and_bytes_match_jax(overrides):
    jm, tm = _pair(overrides)
    assert param_count(tm) == jparams.param_count(jm.params)
    assert tree_bytes(tm) == jparams.tree_bytes(jm.params)
    parts = ("trunk", "text", "pixel_decoder")
    jq = jm.quantize_for_serving(parts)
    tq = tm.quantize_for_serving(parts)
    assert param_count(tq) == jparams.param_count(jq.params)
    assert tree_bytes(tq) == jparams.tree_bytes(jq.params) < tree_bytes(tm)


def test_resolution_buckets(rng):
    """``tests/test_misc_utils.py::test_resolution_buckets``, and the same
    output as the JAX functions."""
    assert buckets.pick_bucket(200) == 224
    assert buckets.pick_bucket(256) == 256
    assert buckets.pick_bucket(1000) == 512
    x = rng.standard_normal((2, 3, 200, 300)).astype(np.float32)
    out, (h, w) = buckets.snap_to_bucket(x)
    assert out.shape == (2, 3, 384, 384) and (h, w) == (200, 300)
    np.testing.assert_array_equal(out[:, :, 92:292, 42:342], x)
    big = rng.standard_normal((1, 3, 600, 600)).astype(np.float32)
    out2, _ = buckets.snap_to_bucket(big)
    assert out2.shape == (1, 3, 512, 512)
    for arr, kw in ((x, {}), (big, {}), (x, dict(buckets=(96, 160), patch=32, pad_value=-1.0))):
        got, want = buckets.snap_to_bucket(arr, **kw), jbuckets.snap_to_bucket(arr, **kw)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
    with pytest.raises(ValueError):
        buckets.snap_to_bucket(x, buckets=(200,), patch=16)


@pytest.mark.parametrize("spec,want", [("bf16", torch.bfloat16), ("fp32", torch.float32),
                                       ("float16", torch.float16), (np.float32, torch.float32),
                                       ("int8", torch.int8), (np.int64, torch.int64),
                                       (torch.bfloat16, torch.bfloat16)])
def test_dtype_map(spec, want):
    """``tests/test_misc_utils.py::test_dtype_map``, by the torch names."""
    assert misc.as_torch_dtype(spec) == want
    if not isinstance(spec, torch.dtype):
        assert str(jnp.dtype(jmisc.as_jax_dtype(spec))) == str(want).split(".")[-1]


def test_cat_uncat(rng):
    """``tests/test_misc_utils.py::test_cat_uncat``, through
    ``models.blocks.pack`` / ``unpack``."""
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((2, 3, 4), (5, 4))]
    xs = [torch.tensor(a) for a in arrays]
    flat, shapes, nt = misc.cat_keep_shapes(xs)
    jflat, jshapes, jnt = jmisc.cat_keep_shapes([jnp.asarray(a) for a in arrays])
    assert flat.shape == (11, 4) and shapes == jshapes and nt == jnt == [6, 5]
    assert np.array_equal(flat.numpy(), np.asarray(jflat))
    for a, b in zip(xs, misc.uncat_with_shapes(flat, shapes, nt)):
        assert torch.equal(a, b)
    assert torch.equal(pack(xs), flat) and all(
        torch.equal(a, b) for a, b in zip(unpack(flat, shapes), xs))
    with pytest.raises(ValueError):
        misc.uncat_with_shapes(flat, shapes, [5, 6])


def test_misc_helpers():
    assert misc.to_2tuple(3) == jmisc.to_2tuple(3) == (3, 3)
    assert misc.to_ntuple(3)([1, 2, 3]) == (1, 2, 3) and misc.to_2tuple("ab") == ("ab", "ab")
    g = misc.fix_random_seeds(5, device="cpu")
    a = (np.random.rand(), torch.rand(2, generator=g))
    g = misc.fix_random_seeds(5, device="cpu")
    b = (np.random.rand(), torch.rand(2, generator=g))
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    sha = misc.get_sha()
    assert sha == "unknown" or len(sha.split()[0]) == 40
    ffn = SwiGLUFFN(4, 8, bias=True)
    shapes = misc.named_apply(lambda path, p: (path, tuple(p.shape)), ffn)
    assert shapes["w1.weight"] == (("w1", "weight"), (8, 4)) and len(shapes) == 6
