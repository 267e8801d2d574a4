"""The head-major VTP checkpoint path and the non-causal CLIP text path of
the port on the CPU, against the JAX package.

- ``qkv_head_major`` and ``permute_trunk_qkv`` equal to the JAX package's,
  exactly; the K-bias mask tiled per rank group.
- A ``vision_qkv_head_major = 2`` ``VTPModel`` against the JAX model on the
  same weights, so that JAX takes ``flash_attention_bnhd`` (its Pallas
  kernel in interpret mode): fp32 within 5e-4 abs, bf16 within 5e-2 of
  max|ref|, with a ``mask_k_bias`` variant and a qk-norm variant; and
  against the canonical model's latents on the same weights.
- Native checkpoints (``model_format: "vtp_tpu"``) both ways, canonical and
  head-major, with the BF16 RoPE periods and the ``__none__`` leaves; a
  head-major model's ``save_hf_checkpoint`` read by the JAX package as
  canonical weights.
- Non-causal text (``text_no_causal_mask``), with and without
  ``embed_cls``, against JAX, which takes ``flash_attention`` there.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu import checkpoint as jax_checkpoint
from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.from_torch import load_vtp_checkpoint as jax_load_checkpoint
from vtp_tpu.convert.to_torch import export_state_dict as jax_export_state_dict
from vtp_tpu.models import vtp_model as jvm
from vtp_tpu.ops import flash_attention as jfa
from vtp_tpu.parallel import sharding as jsh
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.checkpoint import load_pretrained, save_pretrained
from vtp_tpu_torch.convert import save_hf_checkpoint
from vtp_tpu_torch.convert.safetensors_io import load_safetensors
from vtp_tpu_torch.convert.to_torch import export_state_dict
from vtp_tpu_torch.models.blocks import Attention, BlockConfig
from vtp_tpu_torch.ops import flash_attention as fa
from vtp_tpu_torch.parallel import sharding as tsh
from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state, make_ssl_batch

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
# 4 heads of 32 in 2 rank groups; a 4x4 patch grid (17 tokens)
TINY = dict(image_size=64, vision_embed_dim=128, vision_depth=2, vision_num_heads=4,
            vision_feature_bottleneck=16, decoder_embed_dim=64, decoder_depth=1,
            decoder_num_heads=2, text_embed_dim=64, text_num_heads=2, text_depth=2,
            text_vocab_size=64, text_context_length=8)
HM = dict(TINY, vision_qkv_head_major=2)
VARIANTS = {"plain": dict(HM, train_clip=False),
            "mask_k_bias": dict(HM, train_clip=False, vision_mask_k_bias=True),
            "qk_norm": dict(HM, train_clip=False, vision_use_qk_norm=True)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, gate):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    if gate == "bf16":
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())
    else:
        assert err <= F32_ABS, err


@pytest.fixture(scope="module")
def base_tree():
    """One JAX init of TINY (canonical, with the CLIP towers) as numpy. Made
    once, before any test configures the kernels: that clears JAX's caches,
    and an init compiles for seconds."""
    init = jax.jit(jvm.init_vtp_params, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.key(0), JaxConfig(**TINY)))


def _jax_params(base, overrides, seed=0):
    """JAX weights for ``overrides`` from the base tree, in the config's
    layout (the head-major init is the permutation of the canonical one,
    ``init_vtp_params`` :128-135): the CLIP towers dropped without
    ``train_clip``; qk-norm scales, and the appended cls token with its
    position, added where the config has them; the qkv biases and qk-norm
    scales moved off their zero/one init so that the K mask and the norm
    weights show."""
    jc = JaxConfig(**overrides)
    params = {k: v for k, v in base.items()
              if jc.train_clip or k not in ("text", "visual_proj", "logit_scale", "logit_bias")}
    trunk = dict(params["trunk"], blocks=dict(params["trunk"]["blocks"]))
    attn = dict(trunk["blocks"]["attn"], qkv=dict(trunk["blocks"]["attn"]["qkv"]))
    rng = np.random.default_rng(seed)
    attn["qkv"]["bias"] = rng.standard_normal(attn["qkv"]["bias"].shape).astype(np.float32)
    if jc.vision_use_qk_norm:
        shape = (jc.vision_depth, jc.vision_head_dim)
        for name in ("q_norm", "k_norm"):
            attn[name] = {"scale": (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)}
    trunk["blocks"]["attn"] = attn
    params["trunk"] = jsh.permute_trunk_qkv(trunk, jc.vision_num_heads, jc.vision_qkv_head_major)
    if jc.train_clip and jc.text_embed_cls:
        text = dict(params["text"])
        w = jc.text_embed_dim
        text["cls_emb"] = (0.01 * rng.standard_normal(w)).astype(np.float32)
        cls_pos = (0.01 * rng.standard_normal((1, w))).astype(np.float32)
        text["positional_embedding"] = np.concatenate([text["positional_embedding"], cls_pos])
        params["text"] = text
    return jc, params


def _port(overrides, sd, **kw):
    model = VTPModel(VTPConfig(**overrides), device="cpu", **kw)
    model.load_numpy_state_dict(sd)
    return model


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)


# ------------------------------------------------------------------ layout

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_qkv_head_major_matches_jax(tp, inverse):
    rng = np.random.default_rng(tp)
    kernel = rng.standard_normal((2, 16, 3 * 128)).astype(np.float32)
    bias = rng.standard_normal(3 * 128).astype(np.float32)
    for w in (kernel, bias):
        want = np.asarray(jsh.qkv_head_major(w, 4, tp, inverse=inverse))
        np.testing.assert_array_equal(tsh.qkv_head_major(w, 4, tp, inverse=inverse), want)
        np.testing.assert_array_equal(
            tsh.qkv_head_major(torch.tensor(w), 4, tp, inverse=inverse).numpy(), want)
    with pytest.raises(ValueError, match="not permutable"):
        tsh.qkv_head_major(bias, 3, 2)


@pytest.mark.parametrize("inverse", [False, True])
def test_permute_trunk_qkv_matches_jax(inverse, base_tree):
    trunk = _jax_params(base_tree, TINY, seed=3)[1]["trunk"]
    want = jsh.permute_trunk_qkv(trunk, 4, 2, inverse=inverse)
    got = tsh.permute_trunk_qkv(trunk, 4, 2, inverse=inverse)
    flat_w, flat_g = jax_checkpoint.flatten_params(want), jax_checkpoint.flatten_params(got)
    assert sorted(flat_w) == sorted(flat_g)
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k])
    assert not np.array_equal(got["blocks"]["attn"]["qkv"]["kernel"],
                              trunk["blocks"]["attn"]["qkv"]["kernel"])


@pytest.mark.parametrize("hm", [1, 2, 4])
def test_k_bias_mask_is_tiled_per_rank_group(hm):
    attn = Attention(BlockConfig(dim=128, num_heads=4, mask_k_bias=True, qkv_head_major=hm))
    bias = torch.tensor(np.random.default_rng(hm).standard_normal(3 * 128).astype(np.float32))
    attn.qkv.bias.data.copy_(bias)
    dg = 128 // hm
    # the JAX package's mask (vtp_tpu/models/blocks.py:177-189)
    mask = np.tile(np.concatenate([np.ones(dg), np.zeros(dg), np.ones(dg)]), hm)
    np.testing.assert_array_equal(attn.qkv_bias().detach().numpy(),
                                  bias.numpy() * mask.astype(np.float32))


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_head_major_model_matches_jax(variant, dtype, images, base_tree, kernels, monkeypatch):
    kernels(interpret=True)
    overrides = VARIANTS[variant]
    jc, params = _jax_params(base_tree, overrides)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    jax_calls = _count_calls(monkeypatch, jfa, "flash_attention_bnhd")
    port_calls = _count_calls(monkeypatch, fa, "_flash_bnhd_forward")
    fn = jax.jit(functools.partial(jvm.get_reconstruction_latents, cfg=jc, compute_dtype=jdt))
    want = fn(params, image=jnp.asarray(images))
    model = _port(overrides, jax_export_state_dict(params, jc), encode_dtype=tdt)
    got = model.get_reconstruction_latents(torch.tensor(images))
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    _check(got, want, dtype)
    # bf16 takes the kernel's entry on both sides (JAX traces its scanned
    # block once, the port calls it once a block); fp32 the einsum path
    assert bool(jax_calls) == (dtype == "bf16")
    assert len(port_calls) == (jc.vision_depth if dtype == "bf16" else 0)


@pytest.mark.parametrize("variant", ["plain", "qk_norm"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_head_major_and_canonical_latents_agree(variant, dtype, images, base_tree):
    overrides = VARIANTS[variant]
    jc, params = _jax_params(base_tree, overrides)
    sd = jax_export_state_dict(params, jc)
    tdt = torch.bfloat16 if dtype == "bf16" else None
    hm = _port(overrides, sd, encode_dtype=tdt)
    canon = _port(dict(overrides, vision_qkv_head_major=1), sd, encode_dtype=tdt)
    key = "trunk.blocks.0.attn.qkv.weight"
    assert not torch.equal(hm.state_dict()[key], canon.state_dict()[key])
    x = torch.tensor(images)
    want = canon.get_reconstruction_latents(x)
    got = hm.get_reconstruction_latents(x)
    if dtype == "bf16":
        _check(got, want, "bf16")
    else:
        assert (got - want).abs().max().item() <= 1e-5


def test_init_draws_canonical_weights_then_permutes():
    a = VTPModel.init(VTPConfig(**VARIANTS["plain"]), torch.Generator().manual_seed(5),
                      device="cpu")
    b = VTPModel.init(VTPConfig(**dict(VARIANTS["plain"], vision_qkv_head_major=1)),
                      torch.Generator().manual_seed(5), device="cpu")
    ea, eb = export_state_dict(a), export_state_dict(b)
    assert sorted(ea) == sorted(eb)
    for k in ea:
        np.testing.assert_array_equal(ea[k], eb[k])
    w = b.state_dict()["trunk.blocks.1.attn.qkv.weight"].numpy()
    np.testing.assert_array_equal(a.state_dict()["trunk.blocks.1.attn.qkv.weight"].numpy(),
                                  tsh.qkv_head_major(w.T, 4, 2).T)


def test_training_a_head_major_model_is_refused():
    """A head-major model trains (the single-process half of the JAX
    package's ``test_train_step_tp_head_major``): from the same canonical
    init, permuted, one fp32 step gives the canonical step's loss (1e-5 rel)
    and grad norm (1e-4 rel), and its updated trunk equals the canonical
    one's through the inverse permutation (atol 1e-3, rtol 5e-3)."""
    tcfg = TrainConfig(compute_dtype="fp32", dino_out_dim=256, dino_hidden_dim=32,
                       dino_bottleneck_dim=16, warmup_steps=0, total_steps=10, remat=False)
    gen = torch.Generator().manual_seed(2)
    batch = {"rec_image": torch.randn((2, 3, 64, 64), generator=gen),
             "ssl": make_ssl_batch(gen, 2, global_size=64, local_size=32, n_local=2,
                                   device="cpu")}
    runs = {}
    for hm in (1, 2):
        cfg = VTPConfig(**dict(VARIANTS["plain"], vision_qkv_head_major=hm))
        state = init_state(cfg, tcfg, torch.Generator().manual_seed(0), device="cpu")
        runs[hm] = build_train_step(cfg, tcfg)(state, batch)
    (s1, m1), (s2, m2) = runs[1], runs[2]
    assert s2.model.config.vision_qkv_head_major == 2
    assert abs(float(m2["loss/total"]) - float(m1["loss/total"])) <= 1e-5 * abs(
        float(m1["loss/total"]))
    assert abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) <= 1e-4 * float(m1["grad_norm"])
    want = s1.model.trunk.state_dict()
    got = tsh.permute_qkv_state_dict({f"trunk.{k}": v for k, v in s2.model.trunk.state_dict()
                                      .items()}, 4, 2, inverse=True)
    for k, v in want.items():
        torch.testing.assert_close(got[f"trunk.{k}"].float(), v.float(), atol=1e-3, rtol=5e-3)


# ------------------------------------------------------------- checkpoints

def _same_state(a: VTPModel, b: VTPModel):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("hm", [1, 2])
def test_jax_native_checkpoint_loads_in_the_port(hm, tmp_path, base_tree):
    jc, params = _jax_params(base_tree, dict(TINY, vision_qkv_head_major=hm), seed=2)
    jax_checkpoint.save_pretrained(str(tmp_path), jc, jax.tree.map(jnp.asarray, params))
    header = load_safetensors(str(tmp_path / "model.safetensors"))
    assert "trunk/feature_bottleneck/bias/__none__" in header
    loaded = VTPModel.from_checkpoint(str(tmp_path), device="cpu")
    assert loaded.config == VTPConfig(**dict(TINY, vision_qkv_head_major=hm))
    _same_state(loaded, _port(dict(TINY, vision_qkv_head_major=hm),
                              jax_export_state_dict(params, jc)))


@pytest.mark.parametrize("hm", [1, 2])
def test_port_native_checkpoint_loads_in_jax(hm, tmp_path, base_tree):
    overrides = dict(TINY, vision_qkv_head_major=hm)
    jc, params = _jax_params(base_tree, overrides, seed=4)
    model = _port(overrides, jax_export_state_dict(params, jc))
    save_pretrained(str(tmp_path), model)
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["model_format"] == "vtp_tpu"
    cfg, got = jax_checkpoint.load_pretrained(str(tmp_path))
    assert cfg == jc
    want_flat = jax_checkpoint.flatten_params(params)
    got_flat = jax_checkpoint.flatten_params(got)
    assert sorted(got_flat) == sorted(want_flat)
    for k, want in want_flat.items():
        assert got_flat[k].dtype == want.dtype, (k, got_flat[k].dtype, want.dtype)
        np.testing.assert_array_equal(np.asarray(got_flat[k], np.float32),
                                      np.asarray(want, np.float32), err_msg=k)
    assert got_flat["trunk/rope/periods"].dtype == jnp.bfloat16
    # and back into the port, through the port's own reader
    cfg2, tree = load_pretrained(str(tmp_path))
    assert cfg2 == VTPConfig(**overrides) and tree["trunk"]["feature_bottleneck"]["bias"] is None
    _same_state(VTPModel.from_checkpoint(str(tmp_path), device="cpu"), model)


def test_head_major_hf_checkpoint_is_canonical_for_jax(tmp_path, base_tree):
    jc, params = _jax_params(base_tree, HM, seed=6)
    model = _port(HM, jax_export_state_dict(params, jc))
    save_hf_checkpoint(str(tmp_path), model)
    cfg, got = jax_load_checkpoint(str(tmp_path))
    assert cfg.vision_qkv_head_major == 1
    with pytest.raises(ValueError, match="not a native checkpoint"):
        load_pretrained(str(tmp_path))
    canon = jsh.permute_trunk_qkv(params["trunk"], 4, 2, inverse=True)
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(np.asarray(got["trunk"]["blocks"]["attn"]["qkv"][leaf]),
                                      canon["blocks"]["attn"]["qkv"][leaf])


# -------------------------------------------------------- non-causal text

@pytest.mark.parametrize("embed_cls", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_non_causal_text_matches_jax(embed_cls, dtype, base_tree, kernels, monkeypatch):
    kernels(interpret=True)
    overrides = dict(TINY, text_no_causal_mask=True, text_embed_cls=embed_cls)
    jc, params = _jax_params(base_tree, overrides, seed=7)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    text = np.random.default_rng(8).integers(1, 63, (3, 8))
    jax_calls = _count_calls(monkeypatch, jfa, "flash_attention")
    port_calls = _count_calls(monkeypatch, fa, "_flash_forward")
    fn = jax.jit(functools.partial(jvm.get_clip_text_feature, cfg=jc, compute_dtype=jdt))
    want = fn(params, text=jnp.asarray(text))
    model = _port(overrides, jax_export_state_dict(params, jc))
    got = model.get_clip_text_feature(torch.tensor(text), compute_dtype=tdt)
    _check(got, want, dtype)
    assert bool(jax_calls) == (dtype == "bf16")
    assert len(port_calls) == (jc.text_depth if dtype == "bf16" else 0)
