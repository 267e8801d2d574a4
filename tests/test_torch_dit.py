"""The port's DiT generation path against the JAX package on the CPU: the
plain qk-norm arm of the attention backward (against ``jax.vjp`` of
``_fused_reference_impl`` and the interpret-mode Pallas
``_fused_bwd_kernel_call``), ``DiT.forward``, the transport's losses and
euler sampler, two train steps and one accumulated step, the VTP tokenizer
and the sampler end to end. Inputs come from numpy with a seed; the JAX
parameter tree is carried across with ``load_numpy_dit_params``, its
zero-init leaves (every block's ``ada``, ``final.ada``, ``final.proj``)
first drawn from N(0, 0.02²) and its qk-norm scales from 1 + N(0, 0.1²),
since an adaLN-zero DiT predicts exactly 0 and passes no gradient to its
attention. Random draws (label dropout, t, x0, the sampler's noise) are
the JAX package's, fed to the port.

The JAX DiT takes its split attention path on the CPU (the fused kernels
only on a TPU), where the RoPE periods get a gradient; the JAX reference
steps here hold the periods under ``stop_gradient``, as the fused VJP does
and as the port keeps them (a buffer).

Tolerances, from the JAX package's parity gates: fp32 within 5e-4 abs and
bf16 within 5e-2 of max |want|; losses within 5e-3 rel, the grad norm
within 2e-2 rel; per-leaf Adam moments (the gradients) at the train-step
test's gates (fp32 1e-3 of the leaf's max |want|, bf16 5e-2 relative L2
with the leaf's norm floored at 1e-3 of the whole). Where a case differs
it says why."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxVTPConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.dit import model as jmodel
from vtp_tpu.dit import sample as jsample
from vtp_tpu.dit import train as jtrain
from vtp_tpu.dit import transport as jtransport
from vtp_tpu.generation.vtp_tokenizer import VTPTokenizer as JaxTokenizer
from vtp_tpu.models.vtp_model import VTPModel as JaxVTPModel
from vtp_tpu.ops.flash_attention import _fused_bwd_kernel_call, _fused_reference_impl
from vtp_tpu.train.state import ema_update as jax_ema_update
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.dit import model as tmodel
from vtp_tpu_torch.dit import transport as ttransport
from vtp_tpu_torch.dit.model import DiT, DiTConfig, load_numpy_dit_params, make_dit_config
from vtp_tpu_torch.dit.sample import make_sampler, sample_images
from vtp_tpu_torch.dit.train import DiTTrainConfig, build_dit_train_step, init_dit_state
from vtp_tpu_torch.generation import VTPTokenizer
from vtp_tpu_torch.ops.flash_attention import (
    fused_qkv_rope_attention,
    fused_qkv_rope_attention_qk_norm_bwd,
    fused_qkv_rope_attention_qk_norm_bwd_reference,
)
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
B = 4
# head dim 64: the fused attention and its qk-norm backward; 48: the split path
CONFIGS = {
    "d64": dict(input_size=4, in_channels=8, dim=128, depth=2, num_heads=2, num_classes=10),
    "d48": dict(input_size=4, in_channels=8, dim=96, depth=2, num_heads=2, num_classes=10),
}
H, D_HEAD, N = 2, 64, 17
# case: (rope with a 1-token prefix on a 4x4 grid, n_valid, causal)
BWD_CASES = {"no_rope": (False, 0, False), "rope_prefix": (True, 0, False),
             "n_valid": (True, 13, False), "causal": (False, 0, True),
             "causal_n_valid_rope": (True, 11, True)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, gate):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    if gate == "bf16":
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())
    else:
        assert err <= F32_ABS, err


# ------------------------------------------------------------ qk-norm bwd


def _bwd_inputs(dtype, case, seed=0):
    rng = np.random.default_rng(seed)
    rope, n_valid, causal = BWD_CASES[case]
    x = rng.standard_normal((2, N, 3 * H * D_HEAD)).astype(np.float32)
    g = rng.standard_normal((2, N, H * D_HEAD)).astype(np.float32)
    qs, ks = (1.0 + 0.1 * rng.standard_normal(D_HEAD)).astype(np.float32), \
        (1.0 + 0.1 * rng.standard_normal(D_HEAD)).astype(np.float32)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}[dtype]
    t = dict(qkv=torch.tensor(x).to(tdt), g=torch.tensor(g).to(tdt), sin=None, cos=None,
             qs=torch.tensor(qs), ks=torch.tensor(ks))
    j = dict(qkv=jnp.asarray(x, jdt), g=jnp.asarray(g, jdt), sin=None, cos=None,
             qs=jnp.asarray(qs), ks=jnp.asarray(ks))
    if rope:
        sin, cos = pad_rope_prefix(*rope_sincos(rope_periods_init(D_HEAD), 4, 4), 1)
        t["sin"], t["cos"] = sin, cos
        j["sin"], j["cos"] = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (sin, cos))
    return t, j, n_valid, causal


def _plain_norm_bwd(t, n_valid, causal):
    return fused_qkv_rope_attention_qk_norm_bwd_reference(t["qkv"], t["g"], t["sin"], t["cos"],
                                                          t["qs"], t["ks"], H, n_valid, causal)


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_qk_norm_bwd_plain_matches_jax_vjp(dtype, case):
    """fp32 with RoPE is held to the bf16 gate: RoPE is bf16 arithmetic, so
    JAX's autograd rounds the q/k cotangent to bf16 where the written-out
    adjoint keeps it in fp32."""
    t, j, n_valid, causal = _bwd_inputs(dtype, case)
    d_qkv, dwq, dwk = _plain_norm_bwd(t, n_valid, causal)
    assert d_qkv.dtype == t["qkv"].dtype and dwq.dtype == torch.float32
    _, vjp = jax.vjp(lambda a, qs, ks: _fused_reference_impl(a, j["sin"], j["cos"], qs, ks, H,
                                                             n_valid=n_valid, is_causal=causal),
                     j["qkv"], j["qs"], j["ks"])
    want = vjp(j["g"])
    gate = "bf16" if dtype == "bf16" or BWD_CASES[case][0] else "fp32"
    for got, w in zip((d_qkv, dwq, dwk), want):
        _check(got, w, gate)


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_qk_norm_bwd_plain_matches_pallas_kernel_interpret(case, kernels):
    """The TPU kernel's qk-norm arm, its per-batch dw rows folded as its
    caller folds them (flash_attention.py:375-378)."""
    kernels(interpret=True)
    t, j, n_valid, causal = _bwd_inputs("bf16", case, seed=1)
    d_qkv, dwq, dwk = _plain_norm_bwd(t, n_valid, causal)
    want, dws = _fused_bwd_kernel_call(j["qkv"], j["g"], j["sin"], j["cos"], H, j["qs"], j["ks"],
                                       n_valid=n_valid, is_causal=causal)
    _check(d_qkv, want, "bf16")
    _check(dwq, dws[:, 0, :].sum(0).reshape(H, D_HEAD).sum(0), "bf16")
    _check(dwk, dws[:, 1, :].sum(0).reshape(H, D_HEAD).sum(0), "bf16")


def test_bf16_qk_norm_backward_takes_the_arm():
    """On a CPU tensor the autograd Function's bf16 qk-norm backward is the
    arm's plain version, the scales' gradients included."""
    t, _, n_valid, causal = _bwd_inputs("bf16", "causal_n_valid_rope", seed=2)
    qkv = t["qkv"].clone().requires_grad_()
    qs, ks = t["qs"].clone().requires_grad_(), t["ks"].clone().requires_grad_()
    out = fused_qkv_rope_attention(qkv, t["sin"], t["cos"], H, qs, ks, n_valid=n_valid,
                                   is_causal=causal)
    out.backward(t["g"])
    want = fused_qkv_rope_attention_qk_norm_bwd(t["qkv"], t["g"], t["sin"], t["cos"], t["qs"],
                                                t["ks"], H, n_valid, causal)
    for got, w in zip((qkv.grad, qs.grad, ks.grad), want):
        assert torch.equal(got, w)


# ------------------------------------------------------------------ model


def _jax_params(name, seed=0):
    """The JAX tree as numpy, zero-init leaves and qk-norm scales perturbed;
    ``name`` is a key of CONFIGS or a config's keywords."""
    cfg = jmodel.DiTConfig(**(CONFIGS[name] if isinstance(name, str) else name))
    params = jax.tree.map(np.asarray, jmodel.init_dit_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed + 100)
    draw = lambda a: (0.02 * rng.standard_normal(a.shape)).astype(np.float32)
    for lin in (params["blocks"]["ada"], params["final"]["ada"], params["final"]["proj"]):
        lin["kernel"], lin["bias"] = draw(lin["kernel"]), draw(lin["bias"])
    for norm in ("q_norm", "k_norm"):
        s = params["blocks"]["attn"][norm]["scale"]
        params["blocks"]["attn"][norm]["scale"] = (1.0 + 5 * draw(s)).astype(np.float32)
    return cfg, params


def _port_model(name, params):
    model = DiT(DiTConfig(**(CONFIGS[name] if isinstance(name, str) else name)), device="cpu")
    load_numpy_dit_params(model, params)
    return model


def _inputs(cfg, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.in_channels, cfg.input_size, cfg.input_size))
    t = rng.uniform(0.02, 0.98, batch)
    y = rng.integers(0, cfg.num_classes + 1, batch)
    return x.astype(np.float32), t.astype(np.float32), y.astype(np.int32)


def _by_port_name(name, tree):
    """A JAX params-shaped tree (params, EMA or an Adam moment) by port name."""
    model = _port_model(name, jax.tree.map(lambda a: np.asarray(a, np.float32), tree))
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name,dtype", [("d64", "fp32"), ("d64", "bf16"), ("d48", "fp32"),
                                        ("d48", "bf16")])
def test_dit_forward_matches_jax(name, dtype):
    jcfg, params = _jax_params(name)
    model = _port_model(name, params)
    x, t, y = _inputs(jcfg)
    cdt_j, cdt_t = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jmodel.dit_forward(params, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                              compute_dtype=cdt_j)
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(t), torch.tensor(y).long(), compute_dtype=cdt_t)
    assert got.dtype == torch.float32 and np.abs(_np(want)).max() > 1e-2
    _check(got, want, dtype)


def test_fresh_dit_predicts_zero_and_its_first_step_is_finite():
    """adaLN-zero: a fresh DiT predicts exactly 0, and the cosine loss's eps
    keeps the first step's gradients finite."""
    cfg = DiTConfig(**CONFIGS["d64"])
    tcfg = DiTTrainConfig(total_steps=10)
    state = init_dit_state(cfg, tcfg, torch.Generator().manual_seed(0), device="cpu")
    x, t, y = _inputs(cfg)
    with torch.no_grad():
        out = state.model(torch.tensor(x), torch.tensor(t), torch.tensor(y).long())
    assert torch.equal(out, torch.zeros_like(out))
    gen = torch.Generator().manual_seed(1)
    state, metrics = build_dit_train_step(cfg, tcfg)(state, torch.tensor(x), torch.tensor(y).long(),
                                                    gen)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_presets_and_config_match_jax():
    fields = lambda c: [(f.name, str(f.type), f.default) for f in dataclasses.fields(c)]
    assert fields(DiTConfig) == fields(jmodel.DiTConfig)
    assert fields(DiTTrainConfig) == fields(jtrain.DiTTrainConfig)
    assert tmodel.DIT_PRESETS == jmodel.DIT_PRESETS
    xl_t, xl_j = make_dit_config("DiT-XL/1"), jmodel.make_dit_config("DiT-XL/1")
    assert dataclasses.asdict(xl_t) == dataclasses.asdict(xl_j)
    for prop in ("head_dim", "tokens_per_side", "token_dim", "ffn_hidden", "null_label"):
        assert getattr(xl_t, prop) == getattr(xl_j, prop)
    meta = DiT(xl_t, device="meta")
    n_params = sum(p.numel() for p in meta.parameters())
    jparams = jax.eval_shape(lambda: jmodel.init_dit_params(jax.random.key(0), xl_j))
    want = sum(np.prod(a.shape) for a in jax.tree.leaves(jparams)) - xl_j.head_dim // 4
    assert n_params == want


def test_timestep_embedding_and_shift_match_jax():
    t = np.random.default_rng(0).uniform(0, 1, 16).astype(np.float32)
    got = tmodel.timestep_embedding(torch.tensor(t))
    want = jmodel.timestep_embedding(jnp.asarray(t))
    # args reach 1000 rad, where one fp32 ulp of the argument moves sin/cos by 6e-5
    assert np.abs(_np(got) - _np(want)).max() <= 2e-4
    grid = np.linspace(0, 1, 9).astype(np.float32)
    _check(ttransport.shift_timesteps(torch.tensor(grid), 0.075),
           jtransport.shift_timesteps(jnp.asarray(grid), 0.075), "fp32")


# -------------------------------------------------------------- transport


def _jax_loss_draws(key, batch, shape, tcfg):
    """The t and x0 ``training_losses`` draws from ``key``."""
    k_t, k_noise = jax.random.split(key)
    t = jtransport.sample_timesteps(k_t, batch, use_lognorm=tcfg.use_lognorm,
                                    mu=tcfg.lognorm_mu, sigma=tcfg.lognorm_sigma)
    return {"t": torch.tensor(np.asarray(t)),
            "x0": torch.tensor(np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))}


@pytest.mark.parametrize("name", ["d64", "d48"])
def test_training_losses_match_jax(name):
    jcfg, params = _jax_params(name)
    model = _port_model(name, params)
    x1, _, y = _inputs(jcfg, seed=1)
    key = jax.random.key(3)
    tcfg = DiTTrainConfig()
    fn = lambda xt, t, yy: jmodel.dit_forward(params, jcfg, xt, t, yy, compute_dtype=None)
    _, want = jtransport.training_losses(fn, key, jnp.asarray(x1), jnp.asarray(y))
    draws = _jax_loss_draws(key, B, x1.shape, tcfg)
    with torch.no_grad():
        _, got = ttransport.training_losses(
            lambda xt, t, yy: model(xt, t, yy, compute_dtype=None), torch.tensor(x1),
            torch.tensor(y).long(), draws=draws)
    assert set(got) == set(want) == set(ttransport.metric_keys(True))
    for k in got:
        assert abs(float(got[k]) - float(want[k])) <= 5e-3 * abs(float(want[k])), k


@pytest.mark.parametrize("cfg_scale", [1.0, 2.5])
def test_euler_sample_matches_jax(cfg_scale):
    """Four euler steps on the shifted grid from the JAX noise, bf16 DiT."""
    jcfg, params = _jax_params("d64")
    model = _port_model("d64", params)
    _, _, y = _inputs(jcfg, seed=2)
    key = jax.random.key(5)
    shape = (B, jcfg.in_channels, jcfg.input_size, jcfg.input_size)
    kw = dict(num_steps=4, timestep_shift=0.075, cfg_scale=cfg_scale, null_label=jcfg.null_label)
    want = jtransport.euler_sample(
        lambda x, t, yy: jmodel.dit_forward(params, jcfg, x, t, yy), key, shape,
        jnp.asarray(y), **kw)
    noise = torch.tensor(np.asarray(jax.random.normal(key, shape)))
    got = ttransport.euler_sample(lambda x, t, yy: model(x, t, yy), shape, torch.tensor(y).long(),
                                  x=noise, **kw)
    _check(got, want, "bf16")
    # the sampler moved the noise: the comparison is not of the noise alone
    assert np.abs(_np(want) - noise.numpy()).max() > 0.05 * np.abs(_np(want)).max()


# -------------------------------------------------------------- training


def _jax_reference_step(jcfg, jtcfg):
    """The JAX step from ``dit_forward``, ``training_losses``,
    ``make_dit_optimizer`` and ``ema_update`` (the in-jit accumulation's
    math), with the RoPE periods under ``stop_gradient``."""
    optimizer = jtrain.make_dit_optimizer(jtcfg)
    cdt = jtcfg.jnp_compute_dtype

    def loss_and_grads(params, latents, labels, key):
        k_drop, k_loss = jax.random.split(key)
        drop = jax.random.uniform(k_drop, labels.shape) < jtcfg.class_dropout_prob
        y = jnp.where(drop, jcfg.null_label, labels)

        def loss_fn(params):
            frozen = dict(params, rope={"periods": jax.lax.stop_gradient(params["rope"]["periods"])})
            fn = lambda xt, t, yy: jmodel.dit_forward(frozen, jcfg, xt, t, yy, compute_dtype=cdt,
                                                      remat=jtcfg.remat)
            return jtransport.training_losses(
                fn, k_loss, latents, y, use_lognorm=jtcfg.use_lognorm, mu=jtcfg.lognorm_mu,
                sigma=jtcfg.lognorm_sigma, use_cosine_loss=jtcfg.use_cosine_loss)

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return grads, metrics

    def step(state, latents, labels, key):
        accum = jtcfg.accum_steps
        if accum == 1:
            grads, metrics = loss_and_grads(state["params"], latents, labels, key)
        else:
            keys = jax.random.split(key, accum)
            grads, metrics = loss_and_grads(state["params"], latents[0], labels[0], keys[0])
            for i in range(1, accum):
                g, m = loss_and_grads(state["params"], latents[i], labels[i], keys[i])
                grads = jax.tree.map(jnp.add, grads, g)
                metrics = jax.tree.map(jnp.add, metrics, m)
            grads = jax.tree.map(lambda g: g / accum, grads)
            metrics = jax.tree.map(lambda m: m / accum, metrics)
        updates, opt_state = optimizer.update(grads, state["opt_state"], state["params"])
        params = optax.apply_updates(state["params"], updates)
        metrics = dict(metrics, grad_norm=optax.global_norm(grads))
        return {"params": params, "ema": jax_ema_update(state["ema"], params, jtcfg.ema_decay),
                "opt_state": opt_state}, metrics

    return jax.jit(step), optimizer


def _port_draws(key, labels_shape, latents_shape, tcfg):
    """The JAX reference step's draws from ``key`` for one microbatch."""
    k_drop, k_loss = jax.random.split(key)
    drop = np.asarray(jax.random.uniform(k_drop, labels_shape) < tcfg.class_dropout_prob)
    return dict(_jax_loss_draws(k_loss, labels_shape[0], latents_shape, tcfg),
                drop=torch.tensor(drop))


def _run_both(name, tcfg, n_steps, accum=1):
    jcfg, params = _jax_params(name)
    jtcfg = jtrain.DiTTrainConfig(**dataclasses.asdict(tcfg))
    jstep, optimizer = _jax_reference_step(jcfg, jtcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jparams, "ema": jparams, "opt_state": optimizer.init(jparams)}

    state = init_dit_state(DiTConfig(**CONFIGS[name]), tcfg, device="cpu")
    load_numpy_dit_params(state.model, params)
    load_numpy_dit_params(state.ema, params)
    step = build_dit_train_step(state.model.config, tcfg)
    rng = np.random.default_rng(7)
    shape = (B, jcfg.in_channels, jcfg.input_size, jcfg.input_size)
    lead = (accum,) if accum > 1 else ()
    history = []
    for i in range(n_steps):
        latents = rng.standard_normal(lead + shape).astype(np.float32)
        labels = rng.integers(0, jcfg.num_classes, lead + (B,)).astype(np.int32)
        key = jax.random.key(11 + i)
        jstate, jmetrics = jstep(jstate, jnp.asarray(latents), jnp.asarray(labels), key)
        if accum > 1:
            per = [_port_draws(k, (B,), shape, tcfg) for k in jax.random.split(key, accum)]
            draws = {k: torch.stack([d[k] for d in per]) for k in per[0]}
        else:
            draws = _port_draws(key, (B,), shape, tcfg)
        state, metrics = step(state, torch.tensor(latents), torch.tensor(labels).long(), None,
                              draws)
        history.append((metrics, jmetrics))
    return params, state, jstate, history


def _check_metrics(history):
    for metrics, jmetrics in history:
        assert set(metrics) == set(jmetrics)
        for k in metrics:
            got, want = float(metrics[k]), float(jmetrics[k])
            rel = 2e-2 if k == "grad_norm" else 5e-3
            assert np.isfinite(got) and abs(got - want) <= rel * abs(want), (k, got, want)


def _check_moments(name, state, jstate, dtype):
    mu = _by_port_name(name, jstate["opt_state"][1][0].mu)
    assert set(state.optimizer.mu) == set(mu)
    total = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in mu.values()))
    for k, m in state.optimizer.mu.items():
        got, want = _np(m), mu[k]
        if dtype == "fp32":
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), k
        else:
            assert np.linalg.norm(got - want) <= 5e-2 * max(np.linalg.norm(want), 1e-3 * total), k


@pytest.mark.parametrize("name,dtype", [("d64", "bf16"), ("d48", "fp32")])
def test_train_steps_match_jax(name, dtype):
    """Three steps under a constant learning rate (no warmup) with
    ``total_steps = 3``, where a cosine schedule would halve the second
    step's rate. In fp32 the parameters' and the EMA's moves are held per
    leaf to 1e-2 of the leaf's largest JAX move (Adam's first steps move
    every element by about the learning rate, so the move, not the
    parameter, shows a wrong rate or update). In bf16 Adam divides each
    element by its own gradient, and bf16 noise flips the sign of the few
    elements whose gradient is near zero (a 64-wide qk-norm scale leaf moves
    21% off in L2 from one such element): the values are held per leaf to
    the bf16 moment gate, and the moves of the whole tree to 5e-2 relative
    L2 (a halved second step would be 0.3 off)."""
    tcfg = DiTTrainConfig(learning_rate=1e-3, total_steps=3, ema_decay=0.5,
                          class_dropout_prob=0.5, compute_dtype=dtype)
    params, state, jstate, history = _run_both(name, tcfg, 3)
    _check_metrics(history)
    _check_moments(name, state, jstate, dtype)
    start = _by_port_name(name, params)
    moves = {"params": (state.model, jstate["params"]), "ema": (state.ema, jstate["ema"])}
    for part, (module, jtree) in moves.items():
        want_tree = _by_port_name(name, jtree)
        total = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in want_tree.values()))
        err2 = move2 = 0.0
        for k, v in module.state_dict().items():
            got, want = _np(v), want_tree[k]
            move, want_move = got - start[k], want - start[k]
            if k == "rope_periods":
                assert not move.any() and not want_move.any()
            elif dtype == "fp32":
                assert np.abs(move - want_move).max() <= 1e-2 * np.abs(want_move).max(), (part, k)
            else:
                floor = max(np.linalg.norm(want), 1e-3 * total)
                assert np.linalg.norm(got - want) <= 5e-2 * floor, (part, k)
            err2 += np.sum(np.square(move - want_move, dtype=np.float64))
            move2 += np.sum(np.square(want_move, dtype=np.float64))
        assert np.sqrt(err2 / move2) <= 5e-2, part
    assert state.step == 3 and state.optimizer.count == int(jstate["opt_state"][1][0].count)


def test_accumulated_step_matches_jax():
    """accum_steps = 2: the microbatch losses and gradients averaged before
    one update, against the JAX in-jit accumulation's math (fp32, split
    attention path)."""
    tcfg = DiTTrainConfig(learning_rate=1e-3, total_steps=10, ema_decay=0.5,
                          class_dropout_prob=0.5, compute_dtype="fp32", accum_steps=2)
    _, state, jstate, history = _run_both("d48", tcfg, 1, accum=2)
    _check_metrics(history)
    _check_moments("d48", state, jstate, "fp32")



# ------------------------------------------------------- tokenizer, sampler

VTP_TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
                vision_num_heads=1, vision_feature_bottleneck=16, decoder_embed_dim=64,
                decoder_num_heads=1, decoder_depth=2, train_clip=False)


@pytest.fixture(scope="module")
def tokenizers():
    jc = JaxVTPConfig(**VTP_TINY)
    jm = JaxVTPModel.init(jax.random.key(0), jc)
    model = VTPModel(VTPConfig(**VTP_TINY), device="cpu")
    model.load_numpy_state_dict(export_state_dict(jm.params, jc))
    return JaxTokenizer(jc, jm.params, img_size=32), VTPTokenizer(model, img_size=32)


def test_tokenizer_matches_jax(tokenizers):
    jtok, tok = tokenizers
    for attr in ("patch_size", "embed_dim", "downsample_ratio", "latent_size"):
        assert getattr(tok, attr) == getattr(jtok, attr)
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    lat = tok.encode_images(images)
    assert lat.dtype == torch.float32
    _check(lat, jtok.encode_images(images), "bf16")
    z = rng.standard_normal((2, 16, 2, 2)).astype(np.float32)
    got, want = tok.decode_to_images(z), jtok.decode_to_images(z)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (2, 32, 32, 3)
    # exact-fp32 decode in both: pixels agree but for a level where the
    # sum order puts a value on the other side of a truncation boundary
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2


@pytest.mark.parametrize("p_hflip", [0.0, 1.0])
def test_tokenizer_img_transform_matches_jax(tokenizers, p_hflip):
    from PIL import Image

    jtok, tok = tokenizers
    pixels = np.random.default_rng(5).integers(0, 256, (75, 53, 3), dtype=np.uint8)
    img = Image.fromarray(pixels)
    got = tok.img_transform(p_hflip)(img)
    want = jtok.img_transform(p_hflip)(img)
    assert got.shape == want.shape == (3, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_tokenizer_unported_options_raise(tokenizers):
    """A ``data_sharding`` that is not a DeviceMesh raises (a mesh encodes:
    tests/test_torch_parallel_serve.py); the int8 encoder is ported (its
    tokenizer quantizes the trunk only: tests/test_torch_quantized_models.py)."""
    _, tok = tokenizers
    with pytest.raises(TypeError):
        VTPTokenizer(tok.model, data_sharding=object())
    int8 = VTPTokenizer(tok.model, quantize_int8=True)
    assert int8.model is not tok.model and int8.model.pixel_decoder is tok.model.pixel_decoder


def test_sample_images_matches_jax(tokenizers):
    """The slice end to end: two euler steps of a bf16 DiT on the tiny
    tokenizer's 2x2x16 latents, de-normalised and decoded to uint8. The
    bf16 DiT's latents are held to the bf16 gate; the images then differ
    by the decoder's response to that error, so they are held to 2% of the
    pixel range on average and 10% at most."""
    jtok, tok = tokenizers
    cfg_kw = dict(input_size=2, in_channels=16, dim=128, depth=2, num_heads=2, num_classes=10)
    jcfg, params = _jax_params(cfg_kw)
    model = _port_model(cfg_kw, params)
    labels = np.array([1, 7], np.int32)
    rng = np.random.default_rng(9)
    mean = (0.1 * rng.standard_normal((1, 16, 1, 1))).astype(np.float32)
    std = (1.0 + 0.1 * rng.random((1, 16, 1, 1))).astype(np.float32)
    key = jax.random.key(13)
    want = jsample.sample_images(params, jcfg, jtok, labels, key, latent_stats=(mean, std),
                                 num_steps=2)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (2, 16, 2, 2))))
    got = sample_images(model, tok, torch.tensor(labels).long(), latent_stats=(
        torch.tensor(mean), torch.tensor(std)), num_steps=2, noise=noise)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (2, 32, 32, 3)
    z_want = jsample.make_sampler(jcfg, num_steps=2)(params, key, jnp.asarray(labels))
    z_got = make_sampler(model.config, num_steps=2)(model, torch.tensor(labels).long(),
                                                    noise=noise)
    _check(z_got, z_want, "bf16")
    diff = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert diff.mean() <= 0.02 * 255 and diff.max() <= 0.1 * 255, (diff.mean(), diff.max())
