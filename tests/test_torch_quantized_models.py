"""The int8 W8A8 serving tier end to end against the JAX package on the CPU:
``VTPModel.quantize_for_serving``, ``VTPTokenizer(quantize_int8=True)``,
``VTPServer`` over a quantized model and the int8 DiT (the
``sample_dit --int8`` quantization), on the same weights (carried across
with ``export_state_dict`` / ``load_numpy_dit_params``) and inputs made from
a seed with numpy.

- Port against JAX: latents, images and DiT outputs within 5e-2 of max|ref|
  (the bf16 gate: the two packages' attention paths differ below it), CLIP
  text features within 5e-2 of max|ref|.
- JAX's own int8 gates against the float model, met by the port
  (``tests/test_quantization.py``, ``tests/test_dit.py:224-262``): cosine >
  0.99 (latents, text features), decoder images rel < 0.2, DiT rel < 0.15.
- The decoder tier forces a bf16 decode and an int8 decoder refuses the
  fp32 protocol decode; the default keeps the exact decode; the source
  model is unchanged and shares the towers left in float."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.dit import model as jdit
from vtp_tpu.dit import transport as jtransport
from vtp_tpu.generation.vtp_tokenizer import VTPTokenizer as JaxTokenizer
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.utils.quantization import quantize_matmul_params as jax_quantize
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.dit import transport as ttransport
from vtp_tpu_torch.dit.model import DiT, DiTConfig, load_numpy_dit_params
from vtp_tpu_torch.generation import VTPTokenizer
from vtp_tpu_torch.serve import VTPServer
from vtp_tpu_torch.tools.sample_dit import quantize_dit_for_serving
from vtp_tpu_torch.utils.quantization import Int8Weight

torch.set_num_threads(1)
BF16_REL = 5e-2
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=12,
            text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
DIT = dict(input_size=4, in_channels=8, dim=128, depth=2, num_heads=2, num_classes=10)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _near(got, want, rel=BF16_REL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _cos(a, b):
    a, b = _f32(a).ravel(), _f32(b).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def pair():
    """A JAX model and the port's on the same weights (bf16 encode)."""
    jc = JaxConfig(**TINY)
    jm = JaxModel.init(jax.random.key(0), jc)
    tm = VTPModel(VTPConfig(**TINY), device="cpu")
    tm.load_numpy_state_dict(export_state_dict(jm.params, jc))
    return jm, tm


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((2, 3, 32, 32)).astype(np.float32),
            rng.integers(1, 120, (2, 12)))


def test_trunk_and_text_tier_matches_jax(pair, inputs):
    jm, tm = pair
    images, text = inputs
    jq, tq = (m.quantize_for_serving(parts=("trunk", "text")) for m in (jm, tm))
    lat, qlat = tm.get_reconstruction_latents(torch.tensor(images)), \
        tq.get_reconstruction_latents(torch.tensor(images))
    assert qlat.dtype == torch.bfloat16
    _near(qlat, jq.get_reconstruction_latents(jnp.asarray(images)))
    assert _cos(qlat, lat) > 0.99
    feat = tm.get_clip_text_feature(torch.tensor(text))
    qfeat = tq.get_clip_text_feature(torch.tensor(text))
    _near(qfeat, jq.get_clip_text_feature(jnp.asarray(text)))
    assert _cos(qfeat, feat) > 0.99
    # CLIP image features run the int8 trunk and the float visual_proj
    _near(tq.get_clip_image_feature(torch.tensor(images)),
          jq.get_clip_image_feature(jnp.asarray(images)))


def test_source_unchanged_and_float_towers_shared(pair):
    _, tm = pair
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tq = tm.quantize_for_serving(parts=("trunk", "text"))
    after = tm.state_dict()
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert not any(isinstance(m, Int8Weight) for m in tm.modules())
    assert tq.pixel_decoder is tm.pixel_decoder and tq.visual_proj is tm.visual_proj
    assert tq.logit_scale is tm.logit_scale
    blk, qblk = tm.trunk.blocks[0], tq.trunk.blocks[0]
    assert qblk is not blk and qblk.norm1 is blk.norm1 and qblk.attn.qkv.bias is blk.attn.qkv.bias
    assert isinstance(qblk.mlp.w3.weight, Int8Weight)
    # patch_embed and feature_bottleneck read their weights directly: float
    assert tq.trunk.patch_embed is tm.trunk.patch_embed
    assert tq.trunk.feature_bottleneck is tm.trunk.feature_bottleneck
    assert isinstance(tq.text.text_transformer.resblocks[0].attn.in_proj_weight, Int8Weight)
    assert isinstance(tq.text.text_projection, Int8Weight)
    assert tq.text.token_embedding is tm.text.token_embedding
    with pytest.raises(ValueError):
        tm.quantize_for_serving(parts=("visual_proj",))


def test_decoder_tier_forces_bf16_and_default_keeps_the_exact_decode(pair, inputs):
    """ROADMAP's trap "int8 decoder weights under an fp32 decode": the
    decoder tier decodes in bf16 even from a model set to decode at "high"
    or in an explicit fp32, and its decoder refuses an fp32 decode."""
    jm, tm = pair
    images, _ = inputs
    lat = tm.get_reconstruction_latents(torch.tensor(images))
    exact = tm.get_latents_decoded_images(lat)
    trunk_only = tm.quantize_for_serving()
    assert trunk_only.decode_dtype is None
    got = trunk_only.get_latents_decoded_images(lat)
    assert got.dtype == torch.float32 and torch.equal(got, exact)

    qdec = tm.quantize_for_serving(parts=("trunk", "pixel_decoder"))
    assert qdec.decode_dtype == torch.bfloat16
    assert isinstance(qdec.pixel_decoder.proj_in.weight, Int8Weight)
    rec = qdec.get_latents_decoded_images(lat)
    assert rec.dtype == torch.bfloat16 and np.isfinite(_f32(rec)).all()
    assert _rel(rec, exact) < 0.2
    want = jm.quantize_for_serving(parts=("trunk", "pixel_decoder")).get_latents_decoded_images(
        jnp.asarray(_f32(lat)))
    _near(rec, want)
    for precision in ("float32", "high"):
        with pytest.raises(ValueError, match="int8"):
            qdec.pixel_decoder(lat, precision=precision)
    for kw in (dict(decode_precision="high"), dict(decode_dtype=torch.float32)):
        src = VTPModel(tm.config, device="cpu", **kw)
        src.load_state_dict(tm.state_dict())
        assert src.quantize_for_serving(("pixel_decoder",)).decode_dtype == torch.bfloat16


def test_int8_tokenizer_matches_jax(pair, inputs):
    jm, tm = pair
    images, _ = inputs
    jtok = JaxTokenizer(jm.config, jm.params, img_size=32, quantize_int8=True)
    tok = VTPTokenizer(tm, img_size=32, quantize_int8=True)
    assert tok.model is not tm and tok.model.decode_dtype is None
    assert isinstance(tok.model.trunk.blocks[0].attn.qkv.weight, Int8Weight)
    z = tok.encode_images(images)
    assert z.dtype == torch.float32
    _near(z, jtok.encode_images(images))
    assert _cos(z, VTPTokenizer(tm, img_size=32).encode_images(images)) > 0.99
    # the decode stays the exact fp32 one
    got = tok.decode_to_images(z).numpy().astype(np.int32)
    want = np.asarray(jtok.decode_to_images(_f32(z))).astype(np.int32)
    assert got.shape == want.shape == (2, 32, 32, 3) and np.abs(got - want).max() <= 1


def test_server_serves_a_quantized_model(pair):
    """``tests/test_serve.py:74-90`` on the port: int8 encode through the
    queue, close to the float model's latents and equal to a direct call;
    the fp32 decode untouched."""
    _, tm = pair
    qm = tm.quantize_for_serving()
    srv = VTPServer(qm, batch_size=4, max_wait_ms=5, warmup=False)
    try:
        img = np.random.default_rng(9).standard_normal((2, 3, 32, 32)).astype(np.float32)
        z = srv.submit_encode(img).result(timeout=120)
        assert _cos(z, tm.get_reconstruction_latents(torch.tensor(img))) > 0.99
        _near(z, qm.get_reconstruction_latents(torch.tensor(img)))
        dec = srv.submit_decode(_f32(z)).result(timeout=120)
        assert tuple(dec.shape) == (2, 3, 32, 32) and dec.dtype == torch.float32
    finally:
        srv.shutdown()


# --------------------------------------------------------------------- DiT


@pytest.fixture(scope="module")
def dit_pair():
    """The JAX DiT tree, every leaf perturbed by 0.02 N(0, 1) as
    ``tests/test_dit.py:232-238`` does (a fresh DiT predicts 0), its int8
    tree, and the port's float and int8 DiTs on the same weights."""
    cfg = jdit.DiTConfig(**DIT)
    params = jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.key(0), cfg))
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(9)
    params = jax.tree.unflatten(treedef, [
        (l + 0.02 * rng.standard_normal(l.shape)).astype(l.dtype) for l in leaves])
    jq = jax_quantize(params, exclude=lambda k: k in ("x_embed", "final"))
    model = DiT(DiTConfig(**DIT), device="cpu")
    load_numpy_dit_params(model, params)
    return cfg, params, jq, model, quantize_dit_for_serving(model)


def test_int8_dit_forward_matches_jax(dit_pair):
    cfg, params, jq, model, qmodel = dit_pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 4, 4)).astype(np.float32)
    t = np.full((2,), 0.5, np.float32)
    y = np.zeros((2,), np.int32)
    want = jdit.dit_forward(jq, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                            compute_dtype=jnp.bfloat16)
    args = (torch.tensor(x), torch.tensor(t), torch.tensor(y).long())
    with torch.no_grad():
        got = qmodel(*args)
        ref = model(*args)
    assert got.dtype == torch.float32 and np.abs(_f32(want)).max() > 1e-2
    _near(got, want)
    assert _rel(got, ref) < 0.15
    assert isinstance(qmodel.blocks[0].ada.weight, Int8Weight)
    assert qmodel.x_embed is model.x_embed and qmodel.final is model.final
    assert qmodel.y_embed is model.y_embed


def test_int8_dit_sampler_matches_jax(dit_pair):
    """Four euler steps from the JAX noise: the port's int8 sampler against
    JAX's int8 one, and within JAX's rel 0.15 of the port's bf16 sampler."""
    cfg, params, jq, model, qmodel = dit_pair
    y = np.array([1, 3], np.int32)
    key = jax.random.key(2)
    shape = (2, cfg.in_channels, cfg.input_size, cfg.input_size)
    kw = dict(num_steps=4, timestep_shift=0.075, cfg_scale=1.0, null_label=cfg.null_label)
    want = jtransport.euler_sample(
        lambda x, t, yy: jdit.dit_forward(jq, cfg, x, t, yy), key, shape, jnp.asarray(y), **kw)
    noise = torch.tensor(np.asarray(jax.random.normal(key, shape)))
    with torch.no_grad():
        got = ttransport.euler_sample(lambda x, t, yy: qmodel(x, t, yy), shape,
                                      torch.tensor(y).long(), x=noise, **kw)
        ref = ttransport.euler_sample(lambda x, t, yy: model(x, t, yy), shape,
                                      torch.tensor(y).long(), x=noise, **kw)
    assert np.isfinite(_f32(got)).all()
    _near(got, want)
    assert _rel(got, ref) < 0.15
