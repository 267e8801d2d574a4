"""The port's bf16 Adam moments, bf16 gradient accumulators and train-state
checkpoints, against the JAX package on the CPU where it has a twin:

- ``AdamW(moment_dtype="bf16")`` against ``vtp_tpu.train.optim.adamw(...,
  moment_dtype=jnp.bfloat16)`` over three steps: parameters within 5e-4
  abs, the moments at the bf16 moment gate of ``test_torch_dit`` (5e-2
  relative L2 per leaf, the leaf's norm floored at 1e-3 of the whole);
- one ``accum_dtype="bf16"``, ``moment_dtype="bf16"`` DiT step at
  ``accum_steps=2`` against JAX ``run_accum_step`` over the jitted pair of
  ``build_dit_microbatch_steps``: losses within 5e-3 rel, the grad norm
  within 2e-2 rel (the JAX package's parity gates), fed JAX's draws;
- ``save_train_state`` / ``restore_train_state`` bit for bit, blocking and
  not, ``latest_train_state_step``, the dtype-mismatch refusal, a resumed
  step bit-equal to an uninterrupted one, and a JAX DiT train state carried
  across by ``load_numpy_dit_state`` stepping within the gates.

The JAX DiT takes its split attention path on the CPU, where the RoPE
periods get a gradient (the fused kernel's VJP gives them none, and the
port keeps them as a buffer): the JAX grad norm here includes the periods'
gradient, which the gate covers at these sizes (the test says by how much).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vtp_tpu.dit import model as jmodel
from vtp_tpu.dit import train as jtrain
from vtp_tpu.dit import transport as jtransport
from vtp_tpu.train.optim import adamw as jax_adamw
from vtp_tpu_torch.checkpoint import (
    latest_train_state_step,
    restore_train_state,
    save_train_state,
    train_state_tensors,
    wait_for_checkpoints,
)
from vtp_tpu_torch.dit.model import DiTConfig, load_numpy_dit_params, load_numpy_dit_state
from vtp_tpu_torch.dit.train import DiTTrainConfig, build_dit_train_step, init_dit_state
from vtp_tpu_torch.train.optim import AdamW

torch.set_num_threads(1)
B = 4
CFG = dict(input_size=4, in_channels=8, dim=128, depth=2, num_heads=2, num_classes=10)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _moment_gate(got, want, total):
    return np.linalg.norm(got - want) <= 5e-2 * max(np.linalg.norm(want), 1e-3 * total)


# --------------------------------------------------------------- bf16 moments


def test_bf16_moment_adamw_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "s": (3, 5, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1)
    opt = jax_adamw(1e-3, moment_dtype=jnp.bfloat16, **kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jparams)
    leaves = {k: torch.tensor(v) for k, v in params.items()}
    port = AdamW(leaves, learning_rate=1e-3, warmup_steps=0, total_steps=10, grad_clip=1e9,
                 moment_dtype="bf16", constant_lr=True, **kw)
    assert all(m.dtype == torch.bfloat16 for m in (*port.mu.values(), *port.nu.values()))
    for g in grads:
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port.step({k: torch.tensor(v) for k, v in g.items()})
    adam = jstate[0]
    assert port.count == int(adam.count) == 3
    for k in shapes:
        assert np.abs(_np(leaves[k]) - _np(jparams[k])).max() <= 5e-4, k
    for moment in ("mu", "nu"):
        want = {k: _np(v) for k, v in getattr(adam, moment).items()}
        total = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in want.values()))
        for k, m in getattr(port, moment).items():
            assert m.dtype == torch.bfloat16
            assert _moment_gate(_np(m), want[k], total), (moment, k)


def test_unknown_moment_and_accum_dtypes_raise():
    with pytest.raises(ValueError):
        AdamW({"w": torch.zeros(2)}, learning_rate=1e-3, warmup_steps=0, total_steps=1,
              weight_decay=0.0, b1=0.9, b2=0.95, grad_clip=1.0, moment_dtype="fp8")
    for bad in (dict(accum_dtype="fp16"), dict(moment_dtype="fp16")):
        with pytest.raises(ValueError):
            build_dit_train_step(DiTConfig(**CFG), DiTTrainConfig(**bad))


# ---------------------------------------------------------- bf16 accumulators


def _jax_params(seed=0):
    """The JAX DiT tree as numpy with the adaLN-zero leaves and the qk-norm
    scales perturbed (a fresh DiT predicts exactly 0)."""
    cfg = jmodel.DiTConfig(**CFG)
    params = jax.tree.map(np.asarray, jmodel.init_dit_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed + 100)
    draw = lambda a: (0.02 * rng.standard_normal(a.shape)).astype(np.float32)
    for lin in (params["blocks"]["ada"], params["final"]["ada"], params["final"]["proj"]):
        lin["kernel"], lin["bias"] = draw(lin["kernel"]), draw(lin["bias"])
    for norm in ("q_norm", "k_norm"):
        s = params["blocks"]["attn"][norm]["scale"]
        params["blocks"]["attn"][norm]["scale"] = (1.0 + 5 * draw(s)).astype(np.float32)
    return cfg, params


def _port_draws(key, tcfg, shape):
    """What the JAX microbatch step draws from ``key``: the label dropout
    mask, then the transport's t and x0."""
    k_drop, k_loss = jax.random.split(key)
    drop = np.asarray(jax.random.uniform(k_drop, (shape[0],)) < tcfg.class_dropout_prob)
    k_t, k_noise = jax.random.split(k_loss)
    t = jtransport.sample_timesteps(k_t, shape[0], use_lognorm=tcfg.use_lognorm,
                                    mu=tcfg.lognorm_mu, sigma=tcfg.lognorm_sigma)
    x0 = jax.random.normal(k_noise, shape, jnp.float32)
    return {"drop": torch.tensor(drop), "t": torch.tensor(np.asarray(t)),
            "x0": torch.tensor(np.asarray(x0))}


def _batch(cfg, accum, seed):
    rng = np.random.default_rng(seed)
    shape = (accum, B, cfg.in_channels, cfg.input_size, cfg.input_size)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, cfg.num_classes, (accum, B)).astype(np.int32))


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_bf16_accumulated_dit_step_matches_jax_run_accum_step(compute_dtype):
    tcfg = DiTTrainConfig(learning_rate=1e-3, total_steps=10, ema_decay=0.5,
                          class_dropout_prob=0.5, compute_dtype=compute_dtype, remat=False,
                          accum_steps=2, accum_dtype="bf16", moment_dtype="bf16")
    jcfg, params = _jax_params()
    jtcfg = jtrain.DiTTrainConfig(**dataclasses.asdict(tcfg))
    micro, apply = jtrain.build_dit_microbatch_steps(jcfg, jtcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jparams, "ema": jparams,
              "opt_state": jtrain.make_dit_optimizer(jtcfg).init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    latents, labels = _batch(jcfg, 2, seed=7)
    key = jax.random.key(11)
    jstate, jmetrics = jtrain.run_accum_step(jax.jit(micro), jax.jit(apply), jtcfg, jstate,
                                             jnp.asarray(latents), jnp.asarray(labels), key)

    state = init_dit_state(DiTConfig(**CFG), tcfg, device="cpu")
    load_numpy_dit_params(state.model, params)
    load_numpy_dit_params(state.ema, params)
    per = [_port_draws(k, tcfg, latents.shape[1:]) for k in jax.random.split(key, 2)]
    draws = {k: torch.stack([d[k] for d in per]) for k in per[0]}
    state, metrics = build_dit_train_step(state.model.config, tcfg)(
        state, torch.tensor(latents), torch.tensor(labels).long(), None, draws)

    assert set(metrics) == set(jmetrics)
    for k in metrics:
        got, want = float(metrics[k]), float(jmetrics[k])
        rel = 2e-2 if k == "grad_norm" else 5e-3
        assert np.isfinite(got) and abs(got - want) <= rel * abs(want), (k, got, want)
    # the JAX split path's RoPE-period gradient, inside the grad norm's gate
    mu_periods = float(np.linalg.norm(_np(jstate["opt_state"][1][0].mu["rope"]["periods"])))
    assert mu_periods / 0.1 <= 1e-2 * float(jmetrics["grad_norm"])
    assert all(m.dtype == torch.bfloat16 for m in state.optimizer.mu.values())
    assert state.step == 1 and state.optimizer.count == 1


# ------------------------------------------------------------ checkpoints


def _state(moment_dtype="fp32", seed=0):
    tcfg = DiTTrainConfig(learning_rate=1e-3, total_steps=10, ema_decay=0.5,
                          class_dropout_prob=0.5, compute_dtype="bf16", remat="attn",
                          moment_dtype=moment_dtype)
    state = init_dit_state(DiTConfig(**CFG), tcfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    _, params = _jax_params(seed)
    load_numpy_dit_params(state.model, params)
    load_numpy_dit_params(state.ema, params)
    return state, build_dit_train_step(state.model.config, tcfg)


def _step(state, step_fn, seed):
    latents, labels = _batch(state.model.config, 1, seed)
    return step_fn(state, torch.tensor(latents[0]), torch.tensor(labels[0]).long(),
                   torch.Generator().manual_seed(seed))


def _equal_states(a, b):
    ta, tb = train_state_tensors(a), train_state_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    assert a.step == b.step and a.optimizer.count == b.optimizer.count


@pytest.mark.parametrize("moment_dtype", ["fp32", "bf16"])
def test_train_state_roundtrip_is_bit_equal(tmp_path, moment_dtype):
    state, step_fn = _state(moment_dtype)
    for i in range(2):
        state, _ = _step(state, step_fn, i)
    path = save_train_state(str(tmp_path), state)
    assert path.endswith("step_00000002") and latest_train_state_step(str(tmp_path)) == 2
    names = train_state_tensors(state)
    assert any(k.startswith("ema/") for k in names) and "optimizer/nu/rope_periods" in names
    template, _ = _state(moment_dtype, seed=1)
    restored = restore_train_state(str(tmp_path), template)
    assert restored is template
    _equal_states(restored, state)


def test_async_saves_copy_the_state_before_it_moves(tmp_path):
    """``block=False`` copies the state to the host first: the steps taken
    while the files are written do not reach them, and the restore reads
    the last of several saves."""
    state, step_fn = _state("bf16")
    snapshots = []
    for i in range(3):
        state, _ = _step(state, step_fn, i)
        save_train_state(str(tmp_path), state, block=False)
        snapshots.append({k: v.clone() for k, v in train_state_tensors(state).items()})
    state, _ = _step(state, step_fn, 3)
    wait_for_checkpoints()
    assert latest_train_state_step(str(tmp_path)) == 3
    for step, snap in ((1, snapshots[0]), (3, snapshots[2])):
        restored = restore_train_state(str(tmp_path), _state("bf16", seed=1)[0], step=step)
        got = train_state_tensors(restored)
        assert restored.step == step and all(torch.equal(got[k], snap[k]) for k in snap)
    assert latest_train_state_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "none"), state)


def test_restore_refuses_a_dtype_change_unless_allowed(tmp_path):
    state, step_fn = _state("fp32")
    state, _ = _step(state, step_fn, 0)
    save_train_state(str(tmp_path), state)
    template, _ = _state("bf16", seed=1)
    with pytest.raises(ValueError, match="moment_dtype"):
        restore_train_state(str(tmp_path), template)
    restored = restore_train_state(str(tmp_path), template, allow_dtype_mismatch=True)
    assert all(m.dtype == torch.bfloat16 for m in restored.optimizer.mu.values())
    got, want = train_state_tensors(restored), train_state_tensors(state)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    other = init_dit_state(DiTConfig(**dict(CFG, depth=1)), DiTTrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        restore_train_state(str(tmp_path), other)


def test_resumed_step_equals_an_uninterrupted_one(tmp_path):
    state, step_fn = _state("bf16")
    for i in range(2):
        state, _ = _step(state, step_fn, i)
    save_train_state(str(tmp_path), state)
    state, metrics = _step(state, step_fn, 2)
    resumed, step_fn2 = _state("bf16", seed=1)
    restore_train_state(str(tmp_path), resumed)
    resumed, metrics2 = _step(resumed, step_fn2, 2)
    _equal_states(resumed, state)
    assert all(torch.equal(metrics[k], metrics2[k]) for k in metrics)


def test_jax_state_carried_across_steps_within_the_gates():
    """A JAX DiT train state after one step (bf16 moments, nonzero count and
    moments) loaded with ``load_numpy_dit_state``; one more step on each side
    from the same batch and draws."""
    tcfg = DiTTrainConfig(learning_rate=1e-3, total_steps=10, ema_decay=0.5,
                          class_dropout_prob=0.5, compute_dtype="fp32", remat=False,
                          accum_steps=2, moment_dtype="bf16")
    jcfg, params = _jax_params()
    jtcfg = jtrain.DiTTrainConfig(**dataclasses.asdict(tcfg))
    micro, apply = (jax.jit(f) for f in jtrain.build_dit_microbatch_steps(jcfg, jtcfg))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jparams, "ema": jparams,
              "opt_state": jtrain.make_dit_optimizer(jtcfg).init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    latents, labels = _batch(jcfg, 2, seed=3)
    jstate, _ = jtrain.run_accum_step(micro, apply, jtcfg, jstate, jnp.asarray(latents),
                                      jnp.asarray(labels), jax.random.key(4))
    state = init_dit_state(DiTConfig(**CFG), tcfg, device="cpu")
    load_numpy_dit_state(state, jax.tree.map(np.asarray, jstate))
    assert state.step == 1 and state.optimizer.count == 1
    mu = jstate["opt_state"][1][0].mu
    assert torch.equal(state.optimizer.mu["x_embed.weight"],
                       torch.tensor(_np(mu["x_embed"]["kernel"]).T).to(torch.bfloat16))

    latents, labels = _batch(jcfg, 2, seed=5)
    key = jax.random.key(6)
    jstate, jmetrics = jtrain.run_accum_step(micro, apply, jtcfg, jstate, jnp.asarray(latents),
                                             jnp.asarray(labels), key)
    per = [_port_draws(k, tcfg, latents.shape[1:]) for k in jax.random.split(key, 2)]
    draws = {k: torch.stack([d[k] for d in per]) for k in per[0]}
    state, metrics = build_dit_train_step(state.model.config, tcfg)(
        state, torch.tensor(latents), torch.tensor(labels).long(), None, draws)
    for k in metrics:
        got, want = float(metrics[k]), float(jmetrics[k])
        rel = 2e-2 if k == "grad_norm" else 5e-3
        assert np.isfinite(got) and abs(got - want) <= rel * abs(want), (k, got, want)
    assert state.step == 2 and state.optimizer.count == int(jstate["opt_state"][1][0].count)


def test_vtp_train_state_roundtrip_is_bit_equal(tmp_path):
    """The VTP CLIP+SSL+rec state through the same files: student, DINO head,
    teacher (bf16 RoPE periods), centers, bf16 moments, count and step."""
    from vtp_tpu_torch import VTPConfig
    from vtp_tpu_torch.train.step import TrainConfig, init_state

    cfg = VTPConfig(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
                    vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
                    text_vocab_size=64, text_embed_dim=64, text_num_heads=2, text_depth=2,
                    decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
    tcfg = TrainConfig(dino_out_dim=32, dino_hidden_dim=16, dino_bottleneck_dim=8,
                       total_steps=10, moment_dtype="bf16")
    state = init_state(cfg, tcfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in (*state.optimizer.mu.values(), *state.optimizer.nu.values(), state.dino_center,
                  state.ibot_center):
            t.copy_(torch.randn(t.shape, generator=g))
    state.step = state.optimizer.count = 5
    save_train_state(str(tmp_path), state)
    names = train_state_tensors(state)
    assert {"dino_center", "ibot_center", "teacher/trunk.rope_embed.periods"} <= set(names)
    assert names["teacher/trunk.rope_embed.periods"].dtype == torch.bfloat16
    template = init_state(cfg, tcfg, torch.Generator().manual_seed(2), device="cpu")
    _equal_states(restore_train_state(str(tmp_path), template), state)
