"""One whole CLIP+SSL+rec train step of the port against the JAX package on
the CPU, from the same state and batch: the JAX train state (parameters
and teacher) is carried across with ``load_numpy_train_state`` and both
sides run the step with the fused attention, its backward and the fused
CE (the JAX package's Pallas kernels in interpret mode, the port's plain
versions).

Gates, from the JAX package's parity gates (ROADMAP): each loss within
5e-3 rel, the grad norm within 2e-2 rel; teacher within 5e-4 abs. The
per-leaf gradients are read from the first Adam moment after the step
(mu = 0.1 * the clipped gradient, from zero moments): fp32 within 1e-3 of
the leaf's max |mu| (the sum-order noise of two frameworks on fp32
gradients; 5e-4 abs would be vacuous at these magnitudes), bf16 within
5e-2 relative L2 per leaf, with the leaf's norm floored at 1e-3 of the
whole gradient's norm (bf16 rounds the attention's p and ds and every GEMM
input; leaves that carry less than 0.1% of the gradient, such as
logit_scale and the text biases under the contrastive loss, are sums with
heavy cancellation whose bf16 noise is 10% of themselves and 1e-6 of the
gradient); the centers fp32 within 5e-4 abs, bf16 within 5e-2 of max
|want|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.train.step import TrainConfig as JaxTrainConfig
from vtp_tpu.train.step import build_train_step as jax_build_train_step
from vtp_tpu.train.step import init_state as jax_init_state
from vtp_tpu_torch import VTPConfig
from vtp_tpu_torch.models.vtp_model import checkpoint_name
from vtp_tpu_torch.train.state import load_numpy_train_state
from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state, make_ssl_batch

torch.set_num_threads(1)
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
            text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
TRAIN = dict(dino_out_dim=2048, dino_hidden_dim=32, dino_bottleneck_dim=16, warmup_steps=0,
             total_steps=10, remat=False)
B = 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _batch(seed=0):
    """The same numpy batch for both sides, in make_ssl_batch's layout
    (2 global crops of 32² with 4 patches each, 2 local crops of 16²)."""
    rng = np.random.default_rng(seed)
    n_tok = 2 * B * 4
    upper, n_masked = int(n_tok * 0.5), int(n_tok * 0.3)
    perm = rng.permutation(n_tok)
    mask_indices = np.zeros(upper, np.int64)
    mask_indices[:n_masked] = perm[:n_masked]
    masks = np.zeros(n_tok, bool)
    masks[perm[:n_masked]] = True
    ssl = dict(global_crops=rng.standard_normal((2 * B, 3, 32, 32)).astype(np.float32),
               local_crops=rng.standard_normal((2 * B, 3, 16, 16)).astype(np.float32),
               masks=masks.reshape(2 * B, 4), mask_indices=mask_indices,
               mask_weight=(np.arange(upper) < n_masked).astype(np.float32))
    return dict(image=rng.standard_normal((B, 3, 32, 32)).astype(np.float32),
                text=rng.integers(1, 127, (B, 8)), ssl=ssl,
                rec_image=rng.standard_normal((B, 3, 32, 32)).astype(np.float32))


def _to(batch, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(k, v) for k, v in batch.items()}


def _jax_array(key, v):
    return jnp.asarray(v, jnp.int32) if key in ("text", "mask_indices") else jnp.asarray(v)


def _head_sd(head):
    sd = {}
    for name, lin in head["mlp"].items():
        sd[f"dino_head.mlp.{name}.weight"] = np.asarray(lin["kernel"], np.float32).T
        sd[f"dino_head.mlp.{name}.bias"] = np.asarray(lin["bias"], np.float32)
    sd["dino_head.last_layer.v"] = np.asarray(head["last_layer"]["v"], np.float32).T
    sd["dino_head.last_layer.g"] = np.asarray(head["last_layer"]["g"], np.float32)
    return sd


def _state_sd(tree, cfg):
    """A JAX params-shaped tree (params, teacher or an Adam moment) under the
    reference checkpoint's names, the DINO head under the port's."""
    sd = export_state_dict({k: v for k, v in tree.items() if k != "dino_head"}, cfg)
    sd.update(_head_sd(tree["dino_head"]))
    return sd


def _jax_step(dtype, batch, **train_kw):
    jcfg = JaxConfig(**TINY)
    jtcfg = JaxTrainConfig(compute_dtype=dtype, **dict(TRAIN, **train_kw))
    state = jax_init_state(jax.random.key(0), jcfg, jtcfg)
    new, metrics = jax.jit(jax_build_train_step(jcfg, jtcfg))(state, _to(batch, _jax_array),
                                                               jax.random.key(1))
    return jcfg, state, new, metrics


def _port_state(jcfg, jstate, dtype, **train_kw):
    cfg, tcfg = VTPConfig(**TINY), TrainConfig(compute_dtype=dtype, **dict(TRAIN, **train_kw))
    state = init_state(cfg, tcfg, device="cpu")
    load_numpy_train_state(state, _state_sd(jstate["params"], jcfg),
                           teacher=_state_sd(jstate["teacher"], jcfg))
    return state, build_train_step(cfg, tcfg)


def _port_batch(batch):
    return _to(batch, lambda k, v: torch.tensor(v).long() if k in ("text", "mask_indices")
               else torch.tensor(v))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_train_step_matches_jax(dtype, kernels):
    kernels(interpret=True)
    batch = _batch()
    jcfg, jstate, jnew, jmetrics = _jax_step(dtype, batch)
    state, step = _port_state(jcfg, jstate, dtype)
    state, metrics = step(state, _port_batch(batch))

    assert set(metrics) == set(jmetrics)
    for name in metrics:
        got, want = float(metrics[name]), float(jmetrics[name])
        rel = 2e-2 if name == "grad_norm" else 5e-3
        assert np.isfinite(got) and abs(got - want) <= rel * abs(want), (name, got, want)

    mu = _state_sd(jnew["opt_state"][1][0].mu, jcfg)
    assert set(map(checkpoint_name, state.optimizer.mu)) == set(mu)
    total = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in mu.values()))
    for name, m in state.optimizer.mu.items():
        got, want = _np(m), mu[checkpoint_name(name)]
        if dtype == "fp32":
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), name
        else:
            floor = max(np.linalg.norm(want), 1e-3 * total)
            assert np.linalg.norm(got - want) <= 5e-2 * floor, name

    teacher = _state_sd(jnew["teacher"], jcfg)
    for part, module in state.teacher.items():
        for key, value in module.state_dict().items():
            full = f"{part}.{key}"
            assert np.abs(_np(value) - teacher[full]).max() <= 5e-4, full
    for name in ("dino_center", "ibot_center"):
        got, want = _np(getattr(state, name)), np.asarray(jnew[name])
        err = np.abs(got - want).max()
        assert err <= (5e-4 if dtype == "fp32" else 5e-2 * np.abs(want).max()), name
    assert state.step == 1 and state.optimizer.count == int(jnew["opt_state"][1][0].count)


def test_remat_matches_no_remat():
    """Per-block recompute changes no number of the step (CPU, fp32)."""
    batch = _port_batch(_batch(1))
    results = []
    for remat in (False, True):
        cfg, tcfg = VTPConfig(**TINY), TrainConfig(compute_dtype="fp32", **dict(TRAIN, remat=remat))
        state = init_state(cfg, tcfg, torch.Generator().manual_seed(3), device="cpu")
        state, metrics = build_train_step(cfg, tcfg)(state, batch)
        results.append((metrics, state.optimizer.mu))
    (m0, mu0), (m1, mu1) = results
    for name in m0:
        torch.testing.assert_close(m1[name], m0[name], rtol=1e-6, atol=0)
    for name in mu0:
        torch.testing.assert_close(mu1[name], mu0[name], rtol=1e-5, atol=1e-12)


def test_step_updates_state_and_keeps_periods_of_the_student():
    cfg, tcfg = VTPConfig(**TINY), TrainConfig(compute_dtype="bf16", **TRAIN)
    state = init_state(cfg, tcfg, torch.Generator().manual_seed(4), device="cpu")
    before = {n: t.detach().clone() for n, t in state.optimizer.leaves.items()}
    teacher = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    state, metrics = build_train_step(cfg, tcfg)(state, _port_batch(_batch(2)))
    assert all(torch.isfinite(v) for v in metrics.values())
    moved = [n for n, t in state.optimizer.leaves.items() if not torch.equal(t, before[n])]
    assert "trunk.blocks.0.attn.qkv.weight" in moved and "dino_head.last_layer.v" in moved
    # weight decay reaches the bf16 RoPE periods but is below half an ulp
    assert "trunk.rope_embed.periods" not in moved
    assert any(not torch.equal(v, teacher[k]) for k, v in state.teacher.state_dict().items())
    assert state.dino_center.abs().sum() > 0 and state.ibot_center.abs().sum() > 0


def test_make_ssl_batch_layout():
    batch = make_ssl_batch(torch.Generator().manual_seed(0), 2, global_size=32, local_size=16,
                           n_local=3, device="cpu")
    n_tok, upper, n_masked = 16, 8, 4
    assert batch["global_crops"].shape == (4, 3, 32, 32)
    assert batch["local_crops"].shape == (6, 3, 16, 16)
    assert batch["masks"].shape == (4, 4) and int(batch["masks"].sum()) == n_masked
    idx, w = batch["mask_indices"], batch["mask_weight"]
    assert idx.shape == (upper,) and torch.equal(w, (torch.arange(upper) < n_masked).float())
    assert torch.equal(idx[n_masked:], torch.zeros(upper - n_masked, dtype=idx.dtype))
    assert batch["masks"].reshape(-1)[idx[:n_masked]].all() and idx.max() < n_tok


UNPORTED = {
    "drop_shards": ({}, dict(drop_shards=2)),
    "pipeline_stages": ({}, dict(pipeline_stages=2)),
    "sequence_parallel": ({}, dict(sequence_parallel=True)),
    "tp_head_major": ({}, dict(tp_head_major=2)),
}


@pytest.mark.parametrize("option", list(UNPORTED))
def test_unported_options_raise(option, kernels):
    """Each option runs in one process without a mesh and matches the JAX
    step with the same option on one device, in fp32: ``drop_shards``
    splits drop-path's keep counts (no drop rate here; with one, against
    JAX: tests/test_torch_parallel_step.py), pipeline stages and sequence
    parallelism without their mesh axes change nothing (the stacks run
    their sequential loop; on a pipe axis: tests/test_torch_cp_train.py),
    and ``tp_head_major`` trains the trunk head-major (the split attention
    path) from the permuted canonical init."""
    cfg_kw, train_kw = UNPORTED[option]
    cfg = VTPConfig(**dict(TINY, **cfg_kw))
    kernels(interpret=True)
    batch = _batch()
    jcfg, jstate, _, jmetrics = _jax_step("fp32", batch, **train_kw)
    hm = train_kw.get("tp_head_major", 1)
    # the JAX trunk is stored head-major under tp_head_major: the parameters
    # go across canonical (load_numpy_state_dict permutes them), the teacher
    # as stored (it is copied as it is)
    params = _state_sd(jstate["params"], dataclasses.replace(jcfg, vision_qkv_head_major=hm))
    tcfg = TrainConfig(compute_dtype="fp32", **dict(TRAIN, **train_kw))
    state = init_state(cfg, tcfg, device="cpu")
    assert state.model.config.vision_qkv_head_major == hm
    load_numpy_train_state(state, params, teacher=_state_sd(jstate["teacher"], jcfg))
    state, metrics = build_train_step(cfg, tcfg)(state, _port_batch(batch))
    assert set(metrics) == set(jmetrics)
    for name in metrics:
        got, want = float(metrics[name]), float(jmetrics[name])
        rel = 2e-2 if name == "grad_norm" else 5e-3
        assert np.isfinite(got) and abs(got - want) <= rel * abs(want), (name, got, want)


def test_train_config_fields_match_jax():
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert fields(TrainConfig) == fields(JaxTrainConfig)
