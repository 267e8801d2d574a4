"""The VTP train step with gradient accumulation, drop-path and the RoPE
coordinate augmentation against the JAX package's step, from the same
state and batch, the port fed the JAX step's draws: each microbatch's key
split into the clip, rec and ssl branches, each trained trunk forward's
key split into its RoPE key (folded per crop) and its drop key (split per
block, then into the attention and FFN subsets of each crop).

Gates, from the JAX package's parity gates (ROADMAP): each loss within
5e-3 rel, the grad norm (and each objective's) within 2e-2 rel; the Adam
first moment after the step (0.1 x the clipped, averaged gradient) within
1e-3 of each leaf's max |mu| (as ``test_torch_train_step.py``), and with
bf16 accumulators, whose rounding the two packages share only to the
ulp, within 5e-2 relative L2 per leaf (its norm floored at 1e-3 of the
whole gradient's); teacher 5e-4 abs, centers 5e-4 abs."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models.blocks import drop_keep_count as jax_drop_keep_count
from vtp_tpu.train.step import TrainConfig as JaxTrainConfig
from vtp_tpu.train.step import build_train_step as jax_build_train_step
from vtp_tpu.train.step import init_state as jax_init_state
from vtp_tpu.train.step import run_host_accum_step as jax_run_host_accum_step
from vtp_tpu_torch import VTPConfig
from vtp_tpu_torch.models.dino_head import head_state_dict
from vtp_tpu_torch.models.vtp_model import checkpoint_name
from vtp_tpu_torch.train.state import load_numpy_train_state
from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state

torch.set_num_threads(1)
AUG = (0.1, 1.2, 2.0)  # rope shift, jitter, rescale
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
            text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=1,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=1,
            rope_shift_coords=AUG[0], rope_jitter_coords=AUG[1], rope_rescale_coords=AUG[2])
TRAIN = dict(dino_out_dim=512, dino_hidden_dim=32, dino_bottleneck_dim=16, warmup_steps=0,
             total_steps=10, remat=False, clip_drop_rate=0.3, ssl_drop_rate=0.3,
             rec_drop_rate=0.3, compute_dtype="fp32")
B, N_LOCAL, ACCUM = 4, 2, 2
RATES = {"clip": 0.3, "rec": 0.3, "ssl": 0.3}


# ------------------------------------------------------------ the JAX draws

def _jax_rope_draws(key):
    k_shift, k_jitter, k_rescale = jax.random.split(key, 3)
    shift, jitter, rescale = AUG
    m_j, m_r = math.log(jitter), math.log(rescale)
    out = {"shift": jax.random.uniform(k_shift, (2,), jnp.float32, -shift, shift),
           "jitter": jnp.exp(jax.random.uniform(k_jitter, (2,), jnp.float32, -m_j, m_j)),
           "rescale": jnp.exp(jax.random.uniform(k_rescale, (1,), jnp.float32, -m_r, m_r))}
    return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}


def _jax_forward_draws(key, batches, depth, ratio):
    """``vit_forward_features``' draws for crops of ``batches`` rows."""
    rope_key, drop_key = jax.random.split(key)
    out = {"rope": [_jax_rope_draws(jax.random.fold_in(rope_key, i))
                    for i in range(len(batches))]}
    if ratio > 0:
        out["drop"] = []
        for layer_key in jax.random.split(drop_key, depth):
            keys = jax.random.split(layer_key, 2 * len(batches))
            out["drop"].append([
                torch.tensor(np.asarray(jax.random.permutation(k, b)[:jax_drop_keep_count(b, ratio)]
                                        )).long()
                for k, b in zip(keys, list(batches) * 2)])
    return out


def jax_step_draws(key, accum=ACCUM, depth=TINY["vision_depth"]):
    """The draws of the JAX step for ``key``: one entry per microbatch (or
    one dict without accumulation)."""
    def micro(k):
        k_clip, k_rec, k_ssl = jax.random.split(k, 3)
        return {"clip": _jax_forward_draws(k_clip, [B], depth, RATES["clip"]),
                "rec": _jax_forward_draws(k_rec, [B], depth, RATES["rec"]),
                "ssl": _jax_forward_draws(k_ssl, [2 * B, N_LOCAL * B], depth, RATES["ssl"])}
    if accum == 1:
        return micro(key)
    return [micro(k) for k in jax.random.split(key, accum)]


# ------------------------------------------------------------ batches, states

def _micro(seed):
    """One microbatch in make_ssl_batch's layout (2 global crops of 32² with
    4 patches each, 2 local crops of 16² an image)."""
    rng = np.random.default_rng(seed)
    n_tok = 2 * B * 4
    upper, n_masked = int(n_tok * 0.5), int(n_tok * 0.3)
    perm = rng.permutation(n_tok)
    mask_indices = np.zeros(upper, np.int64)
    mask_indices[:n_masked] = perm[:n_masked]
    masks = np.zeros(n_tok, bool)
    masks[perm[:n_masked]] = True
    ssl = dict(global_crops=rng.standard_normal((2 * B, 3, 32, 32)).astype(np.float32),
               local_crops=rng.standard_normal((N_LOCAL * B, 3, 16, 16)).astype(np.float32),
               masks=masks.reshape(2 * B, 4), mask_indices=mask_indices,
               mask_weight=(np.arange(upper) < n_masked).astype(np.float32))
    return dict(image=rng.standard_normal((B, 3, 32, 32)).astype(np.float32),
                text=rng.integers(1, 127, (B, 8)), ssl=ssl,
                rec_image=rng.standard_normal((B, 3, 32, 32)).astype(np.float32))


def _map(batch, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(k, v) for k, v in batch.items()}


def _stack(*micros):
    return {k: _stack(*[m[k] for m in micros]) if isinstance(micros[0][k], dict)
            else np.stack([m[k] for m in micros]) for k in micros[0]}


def _jax(batch):
    return _map(batch, lambda k, v: jnp.asarray(v, jnp.int32) if k in ("text", "mask_indices")
                else jnp.asarray(v))


def _port(batch):
    return _map(batch, lambda k, v: torch.tensor(v).long() if k in ("text", "mask_indices")
                else torch.tensor(v))


def _state_sd(tree, cfg):
    """A JAX params-shaped tree under the reference checkpoint's names, the
    DINO head under the port's (``head_state_dict``)."""
    sd = export_state_dict({k: v for k, v in tree.items() if k != "dino_head"}, cfg)
    sd.update((f"dino_head.{k}", v.numpy()) for k, v in head_state_dict(tree["dino_head"]).items())
    return sd


def _configs(**train_kw):
    return (JaxConfig(**TINY), JaxTrainConfig(**dict(TRAIN, **train_kw)),
            VTPConfig(**TINY), TrainConfig(**dict(TRAIN, **train_kw)))


def _port_state(jstate, jcfg, cfg, tcfg):
    state = init_state(cfg, tcfg, device="cpu")
    load_numpy_train_state(state, _state_sd(jstate["params"], jcfg),
                           teacher=_state_sd(jstate["teacher"], jcfg))
    return state


def _check_metrics(metrics, jmetrics):
    assert set(metrics) == set(jmetrics)
    for name in metrics:
        got, want = float(metrics[name]), float(jmetrics[name])
        rel = 2e-2 if name.startswith("grad_norm") else 5e-3
        assert np.isfinite(got) and abs(got - want) <= rel * abs(want), (name, got, want)


def _check_moments(state, jnew, jcfg, bf16_accumulators=False):
    mu = _state_sd(jnew["opt_state"][1][0].mu, jcfg)
    assert set(map(checkpoint_name, state.optimizer.mu)) == set(mu)
    total = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in mu.values()))
    for name, m in state.optimizer.mu.items():
        got, want = m.float().numpy(), mu[checkpoint_name(name)]
        if bf16_accumulators:
            floor = max(np.linalg.norm(want), 1e-3 * total)
            assert np.linalg.norm(got - want) <= 5e-2 * floor, name
        else:
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), name


# ------------------------------------------------------------------- tests

def test_accumulated_step_matches_jax_scan(kernels):
    """accum_steps = 2, fp32 accumulators: the JAX step's in-jit scan."""
    kernels(interpret=True)
    jcfg, jtcfg, cfg, tcfg = _configs(accum_steps=ACCUM)
    batch = _stack(_micro(0), _micro(1))
    jstate = jax_init_state(jax.random.key(0), jcfg, jtcfg)
    key = jax.random.key(1)
    jnew, jmetrics = jax.jit(jax_build_train_step(jcfg, jtcfg))(jstate, _jax(batch), key)
    state = _port_state(jstate, jcfg, cfg, tcfg)
    before = state.model.trunk.blocks[0].attn.qkv.weight.detach().clone()
    state, metrics = build_train_step(cfg, tcfg)(state, _port(batch), draws=jax_step_draws(key))

    _check_metrics(metrics, jmetrics)
    _check_moments(state, jnew, jcfg)
    assert not torch.equal(before, state.model.trunk.blocks[0].attn.qkv.weight)
    teacher = _state_sd(jnew["teacher"], jcfg)
    for part, module in state.teacher.items():
        for k, v in module.state_dict().items():
            assert np.abs(v.float().numpy() - teacher[f"{part}.{k}"]).max() <= 5e-4, (part, k)
    for name in ("dino_center", "ibot_center"):
        got, want = getattr(state, name).numpy(), np.asarray(jnew[name])
        assert np.abs(got - want).max() <= 5e-4, name
    assert state.step == 1 and state.optimizer.count == 1


def test_duplicated_microbatch_equals_the_single_step():
    """The same microbatch twice, with the same draws, averages to the
    single step: metrics, parameters, moments and teacher bit for bit
    (g + g and its halving are exact in fp32); the centers, pooled over
    twice the rows, to the ulp."""
    micro = _port(_micro(2))
    results = []
    for accum in (1, 2):
        _, _, cfg, tcfg = _configs(accum_steps=accum)
        state = init_state(cfg, tcfg, torch.Generator().manual_seed(4), device="cpu")
        step = build_train_step(cfg, tcfg)
        if accum == 1:
            draws = step.sample_draws(state, torch.Generator().manual_seed(9), micro)
            state, metrics = step(state, micro, draws=draws)
        else:
            state, metrics = step(state, _map(micro, lambda k, v: torch.stack([v, v])),
                                  draws=[draws, draws])
        results.append((state, metrics))
    (s1, m1), (s2, m2) = results
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    for a, b in ((s1.optimizer.leaves, s2.optimizer.leaves), (s1.optimizer.mu, s2.optimizer.mu),
                 (s1.teacher.state_dict(), s2.teacher.state_dict())):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for name in ("dino_center", "ibot_center"):
        torch.testing.assert_close(getattr(s2, name), getattr(s1, name), rtol=1e-6, atol=1e-9)


def test_bf16_accumulators_match_jax_host_accumulation(kernels):
    """accum_dtype="bf16": the JAX package's ``run_host_accum_step``."""
    kernels(interpret=True)
    jcfg, jtcfg, cfg, tcfg = _configs(accum_steps=ACCUM, accum_dtype="bf16")
    batch = _stack(_micro(3), _micro(4))
    jstate = jax_init_state(jax.random.key(5), jcfg, jtcfg)
    key = jax.random.key(6)
    jnew, jmetrics = jax_run_host_accum_step(jax_build_train_step(jcfg, jtcfg), jtcfg, jstate,
                                             _jax(batch), key)
    state = _port_state(jstate, jcfg, cfg, tcfg)
    state, metrics = build_train_step(cfg, tcfg)(state, _port(batch), draws=jax_step_draws(key))
    _check_metrics(metrics, jmetrics)
    _check_moments(state, jnew, jcfg, bf16_accumulators=True)


def test_objective_grad_norms_match_jax(kernels):
    kernels(interpret=True)
    jcfg, jtcfg, cfg, tcfg = _configs()
    micro = _micro(7)
    jstate = jax_init_state(jax.random.key(8), jcfg, jtcfg)
    key = jax.random.key(9)
    want = jax.jit(jax_build_train_step(jcfg, jtcfg).objective_grad_norms)(jstate, _jax(micro),
                                                                          key)
    state = _port_state(jstate, jcfg, cfg, tcfg)
    got = build_train_step(cfg, tcfg).objective_grad_norms(state, _port(micro),
                                                           draws=jax_step_draws(key, accum=1))
    assert set(got) == {"grad_norm/clip", "grad_norm/rec", "grad_norm/dino", "grad_norm/ibot",
                        "grad_norm/koleo"}
    _check_metrics(got, want)
