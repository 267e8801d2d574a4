"""Head dims 32 and 128: the port's plain fused attention (forward in its
four arms, backward in both) against the JAX package on the CPU, as the
existing tests run it (``_fused_reference_impl`` and its ``jax.vjp``, and
the interpret-mode Pallas kernels), a depth-2 tiny VTP at each head dim end
to end, one tiny DiT train step at head dim 128 against a JAX reference
step, and the CUDA kernels' thread-to-column maps (mirrored from
``csrc/``) at every head dim.

Gates (ROADMAP): fp32 within 5e-4 abs, bf16 within 5e-2 of max|ref|,
losses within 5e-3 rel, grad norm within 2e-2 rel. Where RoPE meets an fp32
input that may differ by an ulp (qk-norm sums, JAX's autograd of bf16
RoPE) a bf16 rounding can flip, and the fp32 arm is held to the bf16 gate,
as in the head-dim-64 tests.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.dit import model as jmodel
from vtp_tpu.dit import train as jtrain
from vtp_tpu.dit import transport as jtransport
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.models.vtp_model import get_latents_decoded_images
from vtp_tpu.ops.flash_attention import (
    _fused_bwd_kernel_call,
    _fused_kernel_call,
    _fused_reference_impl,
)
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.dit.model import DiTConfig, load_numpy_dit_params
from vtp_tpu_torch.dit.train import DiTTrainConfig, build_dit_train_step, init_dit_state
from vtp_tpu_torch.ops import flash_attention as fa
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
H, N = 2, 17
DIMS = (32, 128)
# case: (rope with a 1-token prefix on a 4x4 grid, n_valid, causal, qk-norm)
CASES = {"rope_prefix": (True, 0, False, False), "n_valid_rope": (True, 13, False, False),
         "causal": (False, 0, True, False), "qk_norm_rope": (True, 0, False, True),
         "causal_n_valid_qk_norm": (False, 11, True, True)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, gate):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    if gate == "bf16":
        assert err <= BF16_REL * scale, (err, scale)
    else:
        assert err <= F32_ABS, err


def _inputs(d, dtype, case, seed=0):
    rng = np.random.default_rng(seed)
    rope, n_valid, causal, qk = CASES[case]
    x = rng.standard_normal((2, N, 3 * H * d)).astype(np.float32)
    g = rng.standard_normal((2, N, H * d)).astype(np.float32)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}[dtype]
    t = dict(qkv=torch.tensor(x).to(tdt), g=torch.tensor(g).to(tdt), sin=None, cos=None, qs=None,
             ks=None)
    j = dict(qkv=jnp.asarray(x, jdt), g=jnp.asarray(g, jdt), sin=None, cos=None, qs=None, ks=None)
    if rope:
        sin, cos = pad_rope_prefix(*rope_sincos(rope_periods_init(d), 4, 4), 1)
        t["sin"], t["cos"] = sin, cos
        j["sin"], j["cos"] = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (sin, cos))
    if qk:
        qs, ks = ((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(2))
        t["qs"], t["ks"] = torch.tensor(qs), torch.tensor(ks)
        j["qs"], j["ks"] = jnp.asarray(qs), jnp.asarray(ks)
    return t, j, n_valid, causal


def _gate(dtype, case):
    rope, _, _, qk = CASES[case]
    return "bf16" if dtype == "bf16" or (rope and qk) else "fp32"


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("d", DIMS)
def test_forward_plain_matches_jax_reference(d, dtype, case):
    t, j, n_valid, causal = _inputs(d, dtype, case)
    got = fa.fused_qkv_rope_attention(t["qkv"], t["sin"], t["cos"], H, t["qs"], t["ks"],
                                      n_valid=n_valid, is_causal=causal)
    assert got.dtype == t["qkv"].dtype and got.shape == (2, N, H * d)
    want = _fused_reference_impl(j["qkv"], j["sin"], j["cos"], j["qs"], j["ks"], H,
                                 n_valid=n_valid, is_causal=causal)
    _check(got, want, _gate(dtype, case))


@pytest.mark.parametrize("case", ["rope_prefix", "causal", "qk_norm_rope"])
@pytest.mark.parametrize("arm", ["bf16", "fp32", "high"])
@pytest.mark.parametrize("d", DIMS)
def test_forward_plain_matches_pallas_kernel_interpret(d, arm, case, kernels):
    """Every arm, "high" (bf16x3) included, against the TPU kernel run in
    interpret mode; the Pallas kernel rotates in fp32 and rounds once where
    the port rounds each product, so RoPE cases take the bf16 gate."""
    kernels(interpret=True)
    t, j, n_valid, causal = _inputs(d, "bf16" if arm == "bf16" else "fp32", case, seed=1)
    prec = "high" if arm == "high" else "float32"
    got = fa.fused_qkv_rope_attention(t["qkv"], t["sin"], t["cos"], H, t["qs"], t["ks"],
                                      n_valid=n_valid, is_causal=causal, fp32_precision=prec)
    want = _fused_kernel_call(j["qkv"], j["sin"], j["cos"], H, j["qs"], j["ks"], n_valid=n_valid,
                              is_causal=causal, fp32_precision=prec)
    _check(got, want, "bf16" if arm == "bf16" or CASES[case][0] else "fp32")


# ------------------------------------------------------------ backward


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("d", DIMS)
def test_backward_plain_matches_jax_vjp(d, dtype, case):
    """Both arms (qk-norm by the case) against ``jax.vjp`` of the JAX
    reference; fp32 with RoPE takes the bf16 gate (JAX's autograd rounds
    the q/k cotangent to bf16 in RoPE)."""
    t, j, n_valid, causal = _inputs(d, dtype, case, seed=2)
    rope, _, _, qk = CASES[case]
    if qk:
        got = fa.fused_qkv_rope_attention_qk_norm_bwd(t["qkv"], t["g"], t["sin"], t["cos"],
                                                      t["qs"], t["ks"], H, n_valid, causal)
        _, vjp = jax.vjp(lambda a, qs, ks: _fused_reference_impl(
            a, j["sin"], j["cos"], qs, ks, H, n_valid=n_valid, is_causal=causal),
            j["qkv"], j["qs"], j["ks"])
    else:
        got = (fa.fused_qkv_rope_attention_bwd(t["qkv"], t["g"], t["sin"], t["cos"], H, n_valid,
                                               causal),)
        _, vjp = jax.vjp(lambda a: _fused_reference_impl(a, j["sin"], j["cos"], None, None, H,
                                                         n_valid=n_valid, is_causal=causal),
                         j["qkv"])
    gate = "bf16" if dtype == "bf16" or rope else "fp32"
    for a, b in zip(got, vjp(j["g"])):
        _check(a, b, gate)


@pytest.mark.parametrize("case", ["n_valid_rope", "causal_n_valid_qk_norm"])
@pytest.mark.parametrize("d", DIMS)
def test_backward_plain_matches_pallas_kernel_interpret(d, case, kernels):
    """The TPU backward kernel in interpret mode, its per-batch dw rows
    folded as its caller folds them."""
    kernels(interpret=True)
    t, j, n_valid, causal = _inputs(d, "bf16", case, seed=3)
    if CASES[case][3]:
        d_qkv, dwq, dwk = fa.fused_qkv_rope_attention_qk_norm_bwd(
            t["qkv"], t["g"], t["sin"], t["cos"], t["qs"], t["ks"], H, n_valid, causal)
        want, dws = _fused_bwd_kernel_call(j["qkv"], j["g"], j["sin"], j["cos"], H, j["qs"],
                                           j["ks"], n_valid=n_valid, is_causal=causal)
        _check(dwq, dws[:, 0, :].sum(0).reshape(H, d).sum(0), "bf16")
        _check(dwk, dws[:, 1, :].sum(0).reshape(H, d).sum(0), "bf16")
    else:
        d_qkv = fa.fused_qkv_rope_attention_bwd(t["qkv"], t["g"], t["sin"], t["cos"], H, n_valid,
                                                causal)
        want = _fused_bwd_kernel_call(j["qkv"], j["g"], j["sin"], j["cos"], H, n_valid=n_valid,
                                      is_causal=causal)
    _check(d_qkv, want, "bf16")


# ------------------------------------------------- the kernels' column maps


def _prologue_columns(d, f):
    """The columns half f of a row owns in the forward's prologue and the
    chunks load_tile_async copies for it (tensor_core.cuh: rope_chunk)."""
    per = d // 32
    chunks = [(per * f if i < per else d // 16 + per * f) + i % per for i in range(2 * per)]
    return sorted(8 * c + e for c in chunks for e in range(8))


def _epilogue_columns(d, c):
    """The columns quarter c of a row owns in the backward's epilogue
    (acc[4i + e] is column 4c + 16i + e, i < d/16)."""
    return sorted(4 * c + 16 * i + e for i in range(d // 16) for e in range(4))


@pytest.mark.parametrize("d", (32, 64, 128))
def test_kernel_column_maps_keep_rotate_half_partners_together(d):
    """Each thread's columns hold every rotate-half partner j + d/2 of its
    j < d/2, and the threads of a row cover the row once: the forward's
    prologue (two threads a row) and the fp32 arms' (the same map on fp32
    rows), and the backward's epilogue (four threads a row)."""
    for owner, parts in ((_prologue_columns, 2), (_epilogue_columns, 4)):
        cols = [owner(d, p) for p in range(parts)]
        assert sorted(c for part in cols for c in part) == list(range(d))
        for part in cols:
            assert sorted({c % (d // 2) for c in part}) == sorted(c for c in part if c < d // 2)
            assert all((c + d // 2) in part for c in part if c < d // 2)


@pytest.mark.parametrize("d", DIMS)
def test_launch_names_at_head_dim(d):
    assert fa.at_head_dim(fa.BWD_NAME, 64) == fa.BWD_NAME
    assert fa.arm_name(torch.bfloat16, qk_norm=True, d=d) == f"{fa.NORM_NAME}_d{d}"
    assert fa.arm_name(torch.float32, "high", d=d) == f"{fa.HIGH_NAME}_d{d}"
    assert fa.fused_attention_supported((2, N, 3 * H * d), torch.bfloat16, H)


# ---------------------------------------------------------------- models


def _vtp_config(d):
    heads = 128 // d
    return dict(image_size=32, vision_patch_size=16, vision_embed_dim=128, vision_depth=2,
                vision_num_heads=heads, vision_feature_bottleneck=16, decoder_embed_dim=128,
                decoder_depth=2, decoder_num_heads=heads, text_embed_dim=128, text_depth=2,
                text_num_heads=heads, text_vocab_size=64, text_context_length=8)


@pytest.mark.parametrize("d", DIMS)
def test_tiny_vtp_matches_jax(d):
    """A depth-2 VTP whose trunk, decoder and causal text tower all run at
    head dim d (the fused function at every block): the bf16 latents, the
    exact and "high" decodes and the text features against JAX on the same
    weights."""
    overrides = _vtp_config(d)
    jc = JaxConfig(**overrides)
    jm = JaxModel.init(jax.random.key(d), jc)
    model = VTPModel(VTPConfig(**overrides), device="cpu")
    model.load_numpy_state_dict(export_state_dict(jm.params, jc))
    assert model.config.vision_head_dim == model.config.decoder_head_dim == d
    rng = np.random.default_rng(d)
    images = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    latents = model.get_reconstruction_latents(torch.tensor(images))
    _check(latents, jm.get_reconstruction_latents(jnp.asarray(images)), "bf16")
    lat = rng.standard_normal((2, 16, 2, 2)).astype(np.float32)
    _check(model.get_latents_decoded_images(torch.tensor(lat)),
           jm.get_latents_decoded_images(jnp.asarray(lat)), "fp32")
    high = jax.jit(functools.partial(get_latents_decoded_images, cfg=jc, precision="high"))
    _check(model.get_latents_decoded_images(torch.tensor(lat), precision="high"),
           high(jm.params, latents=jnp.asarray(lat)), "fp32")
    ids = rng.integers(1, 63, (2, 8))
    _check(model.get_clip_text_feature(torch.tensor(ids)),
           jm.get_clip_text_feature(jnp.asarray(ids)), "bf16")


def test_tiny_dit_train_step_at_head_dim_128_matches_jax():
    """One bf16 train step of a DiT of one head of 128 (qk-norm forward and
    backward at d = 128) against a JAX step from ``dit_forward``,
    ``training_losses`` and the optimizer, on the same weights and draws,
    the RoPE periods under ``stop_gradient`` as in the port: the losses
    within 5e-3 rel and the grad norm within 2e-2 rel."""
    cfg = dict(input_size=4, in_channels=8, dim=128, depth=2, num_heads=1, num_classes=10)
    jcfg = jmodel.DiTConfig(**cfg)
    params = jax.tree.map(np.asarray, jmodel.init_dit_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(100)
    draw = lambda a: (0.02 * rng.standard_normal(a.shape)).astype(np.float32)
    for lin in (params["blocks"]["ada"], params["final"]["ada"], params["final"]["proj"]):
        lin["kernel"], lin["bias"] = draw(lin["kernel"]), draw(lin["bias"])
    tcfg = DiTTrainConfig(learning_rate=1e-3, total_steps=3, class_dropout_prob=0.5,
                          compute_dtype="bf16")
    jtcfg = jtrain.DiTTrainConfig(**dataclasses.asdict(tcfg))
    B = 4
    latents = rng.standard_normal((B, 8, 4, 4)).astype(np.float32)
    labels = rng.integers(0, 10, (B,)).astype(np.int32)
    key = jax.random.key(11)
    k_drop, k_loss = jax.random.split(key)
    drop = jax.random.uniform(k_drop, (B,)) < tcfg.class_dropout_prob
    y = jnp.where(drop, jcfg.null_label, jnp.asarray(labels))

    def loss_fn(p):
        frozen = dict(p, rope={"periods": jax.lax.stop_gradient(p["rope"]["periods"])})
        fn = lambda xt, t, yy: jmodel.dit_forward(frozen, jcfg, xt, t, yy,
                                                  compute_dtype=jtcfg.jnp_compute_dtype,
                                                  remat=jtcfg.remat)
        return jtransport.training_losses(fn, k_loss, jnp.asarray(latents), y,
                                          use_lognorm=jtcfg.use_lognorm, mu=jtcfg.lognorm_mu,
                                          sigma=jtcfg.lognorm_sigma,
                                          use_cosine_loss=jtcfg.use_cosine_loss)

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(jax.tree.map(jnp.asarray, params))
    want = dict(want, grad_norm=optax.global_norm(grads))

    k_t, k_noise = jax.random.split(k_loss)
    t = jtransport.sample_timesteps(k_t, B, use_lognorm=tcfg.use_lognorm, mu=tcfg.lognorm_mu,
                                    sigma=tcfg.lognorm_sigma)
    draws = {"drop": torch.tensor(np.asarray(drop)), "t": torch.tensor(np.asarray(t)),
             "x0": torch.tensor(np.asarray(jax.random.normal(k_noise, latents.shape, jnp.float32)))}
    state = init_dit_state(DiTConfig(**cfg), tcfg, device="cpu")
    load_numpy_dit_params(state.model, params)
    load_numpy_dit_params(state.ema, params)
    assert state.model.config.head_dim == 128
    step = build_dit_train_step(state.model.config, tcfg)
    _, got = step(state, torch.tensor(latents), torch.tensor(labels).long(), None, draws)
    assert set(got) == set(want)
    for k in got:
        rel = 2e-2 if k == "grad_norm" else 5e-3
        assert abs(float(got[k]) - float(want[k])) <= rel * abs(float(want[k])), k
