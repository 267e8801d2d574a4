"""The port's training pieces against the JAX package on the CPU: the plain
attention backward (against ``jax.vjp`` of ``_fused_reference_impl``, the
interpret-mode Pallas ``_fused_bwd_kernel_call`` and torch autograd of the
plain forward), the differentiable fused attention, the fused DINO/iBOT
cross-entropy, each loss, the DINO head, the text tower, the multi-crop
masked trunk and the optimizer. Inputs come from numpy with a seed and
weights are carried across through ``export_state_dict``.

Tolerances: fp32 within 5e-4 abs and bf16 within 5e-2 of max |want| (the
JAX package's parity gates), except where a case says why it differs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models import vtp_model as jvtp
from vtp_tpu.models.dino_head import DinoHeadConfig as JaxHeadConfig
from vtp_tpu.models.dino_head import dino_head_forward, init_dino_head_params
from vtp_tpu.models.vit import vit_forward_features
from vtp_tpu.ops.flash_attention import _fused_bwd_kernel_call, _fused_reference_impl
from vtp_tpu.ops.fused_ce import _run_bwd, _run_fwd
from vtp_tpu.ops.fused_ce import fused_ce_rows as jax_fused_ce_rows
from vtp_tpu.train import losses as jl
from vtp_tpu.train.step import TrainConfig as JaxTrainConfig
from vtp_tpu.train.step import make_optimizer as jax_make_optimizer
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.models.dino_head import DinoHead, DinoHeadConfig
from vtp_tpu_torch.ops.flash_attention import (
    fused_qkv_rope_attention,
    fused_qkv_rope_attention_bwd_reference,
    fused_qkv_rope_attention_reference,
)
from vtp_tpu_torch.ops.fused_ce import fused_ce_bwd_reference, fused_ce_fwd_reference, fused_ce_rows
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos
from vtp_tpu_torch.train import losses as tl
from vtp_tpu_torch.train.optim import AdamW

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
H, D_HEAD, N = 2, 64, 17
# case: (rope with a 1-token prefix on a 4x4 grid, n_valid, causal)
BWD_CASES = {"rope_prefix": (True, 0, False), "n_valid": (True, 13, False),
             "causal": (False, 0, True), "causal_n_valid_rope": (True, 11, True)}
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
            text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, gate):
    """gate: "fp32" (5e-4 abs) or "bf16" (5e-2 of max |want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    if gate == "bf16":
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())
    else:
        assert err <= F32_ABS, err


def _bwd_inputs(dtype, case, seed=0):
    rng = np.random.default_rng(seed)
    rope, n_valid, causal = BWD_CASES[case]
    x = rng.standard_normal((2, N, 3 * H * D_HEAD)).astype(np.float32)
    g = rng.standard_normal((2, N, H * D_HEAD)).astype(np.float32)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}[dtype]
    t = dict(qkv=torch.tensor(x).to(tdt), g=torch.tensor(g).to(tdt), sin=None, cos=None)
    j = dict(qkv=jnp.asarray(x, jdt), g=jnp.asarray(g, jdt), sin=None, cos=None)
    if rope:
        sin, cos = pad_rope_prefix(*rope_sincos(rope_periods_init(D_HEAD), 4, 4), 1)
        t["sin"], t["cos"] = sin, cos
        j["sin"], j["cos"] = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (sin, cos))
    return t, j, n_valid, causal


def _plain_bwd(t, n_valid, causal):
    return fused_qkv_rope_attention_bwd_reference(t["qkv"], t["g"], t["sin"], t["cos"], H,
                                                  n_valid, causal)


def _bwd_gate(dtype, case):
    """fp32 with RoPE is held to the bf16 gate: RoPE is bf16 arithmetic, so
    autograd rounds the q/k cotangent to bf16 where the written-out
    adjoint keeps it in fp32."""
    return "bf16" if dtype == "bf16" or BWD_CASES[case][0] else "fp32"


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_attention_bwd_plain_matches_jax_vjp(dtype, case):
    t, j, n_valid, causal = _bwd_inputs(dtype, case)
    got = _plain_bwd(t, n_valid, causal)
    assert got.dtype == t["qkv"].dtype and got.shape == t["qkv"].shape
    _, vjp = jax.vjp(lambda a: _fused_reference_impl(a, j["sin"], j["cos"], None, None, H,
                                                     n_valid=n_valid, is_causal=causal), j["qkv"])
    _check(got, vjp(j["g"])[0], _bwd_gate(dtype, case))


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_attention_bwd_plain_matches_pallas_kernel_interpret(case, kernels):
    kernels(interpret=True)
    t, j, n_valid, causal = _bwd_inputs("bf16", case, seed=1)
    got = _plain_bwd(t, n_valid, causal)
    want = _fused_bwd_kernel_call(j["qkv"], j["g"], j["sin"], j["cos"], H, n_valid=n_valid,
                                  is_causal=causal)
    _check(got, want, "bf16")


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_attention_bwd_plain_matches_torch_autograd(dtype, case):
    t, _, n_valid, causal = _bwd_inputs(dtype, case, seed=2)
    got = _plain_bwd(t, n_valid, causal)
    qkv = t["qkv"].clone().requires_grad_()
    out = fused_qkv_rope_attention_reference(qkv, t["sin"], t["cos"], H, n_valid=n_valid,
                                             is_causal=causal)
    out.backward(t["g"])
    _check(got, qkv.grad, _bwd_gate(dtype, case))


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_differentiable_attention_matches_plain_gradients(dtype, qk_norm):
    """Gradients through the autograd.Function (the backward's plain version
    for bf16, its qk-norm arm's with qk-norm; the recompute for fp32)
    against torch autograd of the plain forward: bit-equal where the
    Function recomputes, the bf16 gate where it runs the written-out
    backward."""
    t, _, n_valid, causal = _bwd_inputs(dtype, "n_valid", seed=3)
    rng = np.random.default_rng(4)
    scales = [None, None]
    if qk_norm:
        scales = [torch.tensor(1 + 0.1 * rng.standard_normal(D_HEAD).astype(np.float32))
                  for _ in range(2)]
    grads = []
    for fn in (fused_qkv_rope_attention, fused_qkv_rope_attention_reference):
        leaves = [t["qkv"].clone().requires_grad_()]
        leaves += [s.clone().requires_grad_() for s in scales if s is not None]
        qs, ks = (leaves[1], leaves[2]) if qk_norm else (None, None)
        out = fn(leaves[0], t["sin"], t["cos"], H, qs, ks, n_valid=n_valid, is_causal=causal)
        out.backward(t["g"])
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        if dtype == "fp32":
            assert torch.equal(got, want)
        else:
            _check(got, want, "bf16")


def test_rope_tables_get_no_gradient():
    t, _, n_valid, causal = _bwd_inputs("bf16", "rope_prefix")
    sin, cos = (x.clone().requires_grad_() for x in (t["sin"], t["cos"]))
    qkv = t["qkv"].clone().requires_grad_()
    fused_qkv_rope_attention(qkv, sin, cos, H).float().sum().backward()
    assert qkv.grad is not None and sin.grad is None and cos.grad is None


# ------------------------------------------------------------ fused CE


def _ce_inputs(R, C, dtype, seed=0):
    rng = np.random.default_rng(seed)
    t, s = (3 * rng.standard_normal((R, C)).astype(np.float32) for _ in range(2))
    center = 0.1 * rng.standard_normal(C).astype(np.float32)
    g = rng.random(R).astype(np.float32)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}[dtype]
    return ([torch.tensor(a).to(tdt) for a in (t, s)] + [torch.tensor(center), torch.tensor(g)],
            [jnp.asarray(a, jdt) for a in (t, s)] + [jnp.asarray(center), jnp.asarray(g)])


@pytest.mark.parametrize("R,C", [(8, 2048), (16, 4096)])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_fused_ce_plain_matches_pallas_interpret(dtype, R, C, kernels):
    """The stats are fp32 in both arms, so both are held to the fp32 gate
    (ce and stats) and to 5e-4 abs on ds (|ds| <= g / T_s)."""
    kernels(interpret=True)
    (t, s, c, g), (jt, js, jc, jg) = _ce_inputs(R, C, dtype)
    ce, stats = fused_ce_fwd_reference(t, s, c, 0.07, 0.1)
    jce, jstats = _run_fwd(jt, js, jc, 0.07, 0.1, save_stats=True)
    _check(ce, jce, "fp32")
    for got, want in zip(stats, jstats):
        _check(got / max(1.0, float(want.max())), want / max(1.0, float(want.max())), "fp32")
    ds = fused_ce_bwd_reference(t, s, c, g, stats, 0.07, 0.1)
    assert ds.dtype == s.dtype
    _check(ds, _run_bwd(jt, js, jc, jg, jstats, 0.07, 0.1), "fp32" if dtype == "fp32" else "bf16")


@pytest.mark.parametrize("R", [12, 13])
def test_fused_ce_rows_matches_jax_vjp(R, kernels):
    """R = 12 against the Pallas ``fused_ce_rows`` VJP (interpret); R = 13 and
    C = 1000, which the TPU kernel does not take, against ``jax.vjp`` of the
    XLA loss math. fp32 within 5e-4 abs."""
    C = 2048 if R == 12 else 1000
    (t, s, c, g), (jt, js, jc, jg) = _ce_inputs(R, C, "fp32", seed=R)
    s = s.clone().requires_grad_()
    ce = fused_ce_rows(t, s, c, 0.07, 0.1)
    ce.backward(g)
    if R == 12:
        kernels(interpret=True)
        fn = lambda s_: jax_fused_ce_rows(jt, s_, jc, 0.07, 0.1)
    else:
        def fn(s_):
            p_t = jax.nn.softmax((jt - jc) / 0.07, axis=-1)
            return -jnp.sum(p_t * jax.nn.log_softmax(s_ / 0.1, axis=-1), axis=-1)
    jce, vjp = jax.vjp(fn, js)
    _check(ce, jce, "fp32")
    _check(s.grad, vjp(jg)[0], "fp32")


@pytest.mark.parametrize("bad", ["rank", "shape", "center", "dtype"])
def test_fused_ce_rejects_bad_inputs(bad):
    (t, s, c, _), _ = _ce_inputs(4, 64, "fp32")
    if bad == "rank":
        t, s = t[0], s[0]
    elif bad == "shape":
        s = s[:, :32]
    elif bad == "center":
        c = c[:32]
    else:
        s = s.half()
    with pytest.raises((ValueError, TypeError)):
        fused_ce_rows(t, s, c, 0.07, 0.1)


# --------------------------------------------------------------- losses


def _grad_pair(t_fn, j_fn, *arrays):
    """Value and gradient w.r.t. the first array of a torch and a JAX loss."""
    xs = [torch.tensor(a) for a in arrays]
    xs[0].requires_grad_()
    tv = t_fn(*xs)
    tv.backward()
    jv, jg = jax.value_and_grad(j_fn)(*[jnp.asarray(a) for a in arrays])
    return (tv, xs[0].grad), (jv, jg)


def _features(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


LOSSES = ["clip", "siglip", "dino", "ibot", "ibot_unweighted", "rec_mse", "rec_l1",
          "rec_smooth_l1", "koleo"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name):
    rng = np.random.default_rng(hash(name) % 2 ** 32)
    if name in ("clip", "siglip"):
        args = [_features(rng, 6, 16), _features(rng, 6, 16), np.float32(np.log(1 / 0.07))]
        if name == "clip":
            fns = (tl.clip_loss, jl.clip_loss)
        else:
            args.append(np.float32(-10.0))
            fns = (tl.siglip_loss, jl.siglip_loss)
    elif name.startswith("ibot") or name == "dino":
        # R = 10 takes the XLA path in the JAX package (R % 8 != 0)
        s, t = (3 * rng.standard_normal((10, 300)).astype(np.float32) for _ in range(2))
        center = 0.1 * rng.standard_normal(300).astype(np.float32)
        args = [s, t, center]
        if name == "dino":
            fns = (tl.dino_loss, jl.dino_loss)
        else:
            if name == "ibot":
                args.append((np.arange(10) < 7).astype(np.float32))
            fns = (tl.ibot_loss, jl.ibot_loss)
    elif name.startswith("rec"):
        kind = name[len("rec_"):]
        args = [rng.standard_normal((2, 3, 8, 8)).astype(np.float32) * 2,
                rng.standard_normal((2, 3, 8, 8)).astype(np.float32)]
        fns = (functools.partial(tl.reconstruction_loss, loss_type=kind),
               functools.partial(jl.reconstruction_loss, loss_type=kind))
    else:
        args = [rng.standard_normal((6, 16)).astype(np.float32)]
        fns = (tl.koleo_loss, jl.koleo_loss)
    (tv, tg), (jv, jg) = _grad_pair(*fns, *args)
    _check(tv, jv, "fp32")
    _check(tg, jg, "fp32")


@pytest.mark.parametrize("weighted", [False, True])
def test_update_center_matches_jax(weighted):
    rng = np.random.default_rng(5)
    center = rng.standard_normal(300).astype(np.float32)
    logits = rng.standard_normal((10, 300)).astype(np.float32)
    w = (np.arange(10) < 6).astype(np.float32) if weighted else None
    got = tl.update_center(torch.tensor(center), torch.tensor(logits).bfloat16(), 0.9,
                           None if w is None else torch.tensor(w))
    want = jl.update_center(jnp.asarray(center), jnp.asarray(logits, jnp.bfloat16), 0.9,
                            None if w is None else jnp.asarray(w))
    _check(got, want, "fp32")


# ------------------------------------------------------------ DINO head


def _head_pair(seed=0, out_dim=512):
    jcfg = JaxHeadConfig(in_dim=64, out_dim=out_dim, hidden_dim=32, bottleneck_dim=16)
    params = init_dino_head_params(jax.random.key(seed), jcfg)
    head = DinoHead(DinoHeadConfig(in_dim=64, out_dim=out_dim, hidden_dim=32, bottleneck_dim=16))
    head.load_state_dict(head_state_dict(params))
    return jcfg, params, head


def head_state_dict(params):
    """The JAX head's weights under the port's names, torch layout."""
    sd = {}
    for name, lin in params["mlp"].items():
        sd[f"mlp.{name}.weight"] = torch.tensor(np.asarray(lin["kernel"]).T.copy())
        sd[f"mlp.{name}.bias"] = torch.tensor(np.asarray(lin["bias"]))
    sd["last_layer.v"] = torch.tensor(np.asarray(params["last_layer"]["v"]).T.copy())
    sd["last_layer.g"] = torch.tensor(np.asarray(params["last_layer"]["g"]))
    return sd


@pytest.mark.parametrize("zero_safe", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_dino_head_matches_jax(dtype, zero_safe):
    jcfg, params, head = _head_pair()
    x = np.random.default_rng(6).standard_normal((5, 64)).astype(np.float32)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bf16" else (None, None)
    got = head(torch.tensor(x), compute_dtype=tdt, zero_safe_normalize=zero_safe)
    want = dino_head_forward(params, jcfg, jnp.asarray(x), compute_dtype=jdt,
                             zero_safe_normalize=zero_safe)
    assert got.dtype == (tdt or torch.float32)
    _check(got, want, dtype)


def test_dino_head_zero_row_has_zero_jacobian():
    """The zero-safe normalize gives an exactly-zero row a zero, finite
    gradient where the clamped one has ~1/eps (dino_head.py:94-98)."""
    _, _, head = _head_pair(out_dim=64)
    for lin in head.mlp.values():  # a zero input row stays zero through the MLP
        torch.nn.init.zeros_(lin.bias)
    x = torch.randn(3, 64)
    x[1] = 0
    grads = {}
    for zero_safe in (False, True):
        xi = x.clone().requires_grad_()
        out = head(xi, zero_safe_normalize=zero_safe)
        assert torch.equal(out[1], torch.zeros_like(out[1]))
        out.sum().backward()
        grads[zero_safe] = xi.grad
    assert torch.isfinite(grads[True]).all()
    assert torch.equal(grads[True][1], torch.zeros(64))
    assert grads[False][1].abs().max() > 1e3 * grads[True].abs().max()


# ----------------------------------------- text tower, CLIP, multi-crop


@functools.lru_cache(maxsize=None)
def _model_pair():
    jc = JaxConfig(**TINY)
    jm = jvtp.VTPModel.init(jax.random.key(0), jc)
    tm = VTPModel(VTPConfig(**TINY), device="cpu")
    tm.load_numpy_state_dict(export_state_dict(jm.params, jc))
    return jc, jm, tm


def _text_ids(seed):
    ids = np.random.default_rng(seed).integers(1, 100, (3, 8)).astype(np.int32)
    ids[1, 2] = ids[1, 5] = 127  # a tie for the argmax pool: both take the first
    return ids


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_text_tower_matches_jax(dtype):
    jc, jm, tm = _model_pair()
    ids = _text_ids(7)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bf16" else (None, None)
    got = tm.get_clip_text_feature(torch.tensor(ids).long(), compute_dtype=tdt)
    want = jvtp.get_clip_text_feature(jm.params, jc, jnp.asarray(ids), compute_dtype=jdt)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_clip_logits_match_jax(dtype):
    jc, jm, tm = _model_pair()
    img = np.random.default_rng(8).standard_normal((3, 3, 32, 32)).astype(np.float32)
    ids = _text_ids(9)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bf16" else (None, None)
    got, got_t = tm.get_clip_logits(torch.tensor(img), torch.tensor(ids).long(), compute_dtype=tdt)
    want, _ = jvtp.get_clip_logits(jm.params, jc, jnp.asarray(img), jnp.asarray(ids),
                                   compute_dtype=jdt)
    _check(got, want, dtype)
    assert torch.equal(got_t, got.t())


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_multicrop_masked_trunk_matches_jax(dtype):
    jc, jm, tm = _model_pair()
    rng = np.random.default_rng(10)
    g = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    loc = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
    masks = rng.random((4, 4)) < 0.4
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bf16" else (None, None)
    got = tm.trunk.forward_features([torch.tensor(g), torch.tensor(loc)],
                                    masks=[torch.tensor(masks), None], use_bottleneck=False,
                                    compute_dtype=tdt, training=True)
    want = vit_forward_features(jm.params["trunk"], jvtp.vit_config_from(jc),
                                [jnp.asarray(g), jnp.asarray(loc)],
                                masks=[jnp.asarray(masks), None], use_bottleneck=False,
                                compute_dtype=jdt, training=True)
    for a, b in zip(got, want):
        for key in ("x_norm_clstoken", "x_norm_patchtokens"):
            _check(a[key], b[key], dtype)


# ------------------------------------------------------------ optimizer


@pytest.mark.parametrize("warmup,clip", [(0, 1.0), (2, 100.0)])
def test_optimizer_matches_optax(warmup, clip):
    """Three steps of clip_by_global_norm -> AdamW -> warmup-cosine against
    ``make_optimizer`` on the same parameters and gradients; the first
    case clips every step, the second never does. fp32 within 5e-4 abs is
    vacuous at lr 1e-3, so parameters and moments are held to 1e-6 abs."""
    rng = np.random.default_rng(11)
    shapes = {"a": (4, 5), "b": (7,), "c": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    tcfg = JaxTrainConfig(warmup_steps=warmup, total_steps=10, grad_clip=clip)
    opt = jax_make_optimizer(tcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jp)
    leaves = {k: torch.tensor(v) for k, v in params.items()}
    port = AdamW(leaves, learning_rate=tcfg.learning_rate, warmup_steps=warmup, total_steps=10,
                 weight_decay=tcfg.weight_decay, b1=tcfg.beta1, b2=tcfg.beta2, grad_clip=clip)
    for _ in range(3):
        grads = {k: np.asarray(3 * rng.standard_normal(s), np.float32) for k, s in shapes.items()}
        jgrads = {k: jnp.asarray(v) for k, v in grads.items()}
        updates, jstate = opt.update(jgrads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        norm = port.step({k: torch.tensor(v) for k, v in grads.items()})
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jgrads)), rtol=1e-6)
    adam = jstate[1][0]
    for k in shapes:
        np.testing.assert_allclose(_np(leaves[k]), _np(jp[k]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(_np(port.mu[k]), _np(adam.mu[k]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(_np(port.nu[k]), _np(adam.nu[k]), atol=1e-6, rtol=0)
    assert port.count == int(adam.count) == 3
