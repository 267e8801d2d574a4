"""The gradient-checkpoint policies of ``models/blocks.checkpoint_policy``
(the JAX package's ``remat_wrap``: False, True / "full", "dots", "attn",
"dots_attn") on the CPU.

- Each policy gives gradients bit-equal to ``remat=False`` on a tiny ViT
  trunk (two crops), a tiny DiT and the tiny VTP CLIP+SSL+rec train step:
  a policy changes what is kept between the forward and the backward,
  never the arithmetic.
- What is recomputed, counted by a monkeypatch of the fused attention's
  plain forward: once a block per step under False, "attn" and
  "dots_attn" (the saved output stands in for the recompute), twice under
  True, "full" and "dots" (the recompute runs it again).
- The VTP step at "attn" and "dots" against the JAX step at the same
  policy, at the train-step test's gates (losses 5e-3 rel, grad norm 2e-2
  rel; the JAX Pallas kernels in interpret mode).
- An unknown policy raises ``ValueError``, as in JAX.
"""

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
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.dit.model import DiT, DiTConfig
from vtp_tpu_torch.models.blocks import checkpoint_policy
from vtp_tpu_torch.ops import flash_attention as fa
from vtp_tpu_torch.train.state import load_numpy_train_state
from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state

torch.set_num_threads(1)
POLICIES = [False, True, "full", "dots", "attn", "dots_attn"]
SAVES_ATTENTION = {False, "attn", "dots_attn"}
DEPTH = 2
VTP_TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=DEPTH,
                vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
                text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=DEPTH,
                decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=DEPTH)
DIT_TINY = dict(input_size=4, in_channels=8, dim=128, depth=DEPTH, num_heads=2, num_classes=10)
TRAIN = dict(dino_out_dim=2048, dino_hidden_dim=32, dino_bottleneck_dim=16, warmup_steps=0,
             total_steps=10)
B = 2


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts calls of the fused attention's plain forward (the CPU side of
    ``_forward``; the bf16 backward's plain version does not call it)."""
    calls = [0]
    plain = fa.fused_qkv_rope_attention_reference

    def counting(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "fused_qkv_rope_attention_reference", counting)
    return calls


def _grads(module, loss_fn):
    module.zero_grad(set_to_none=True)
    loss_fn().backward()
    return {n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None}


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _per_policy(module, loss_fn, calls):
    out = {}
    for remat in POLICIES:
        calls[0] = 0
        out[remat] = (_grads(module, lambda: loss_fn(remat)), calls[0])
    return out


def test_vit_policies_bit_equal_and_counted(fused_calls):
    model = VTPModel.init(VTPConfig(**VTP_TINY), torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    crops = [torch.randn(B, 3, 32, 32, generator=g), torch.randn(B, 3, 16, 16, generator=g)]

    def loss(remat):
        outs = model.trunk.forward_features(crops, compute_dtype=torch.bfloat16, remat=remat)
        return sum(o["x_norm_patchtokens"].float().square().mean() for o in outs)

    results = _per_policy(model.trunk, loss, fused_calls)
    for remat, (grads, calls) in results.items():
        _assert_equal(grads, results[False][0])
        # one fused call a crop a block, again in the recompute unless saved
        assert calls == 2 * DEPTH * (1 if remat in SAVES_ATTENTION else 2), (remat, calls)


def test_dit_policies_bit_equal_and_counted(fused_calls):
    model = DiT.init(DiTConfig(**DIT_TINY), torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # adaLN-zero: a fresh DiT passes its attention no gradient
        for lin in [b.ada for b in model.blocks] + [model.final.ada, model.final.proj]:
            lin.weight.normal_(0, 0.02, generator=g)
            lin.bias.normal_(0, 0.02, generator=g)
    x, t = torch.randn(3, 8, 4, 4, generator=g), torch.rand(3, generator=g)
    y = torch.tensor([1, 2, 10])

    def loss(remat):
        return model(x, t, y, compute_dtype=torch.bfloat16, remat=remat).square().mean()

    results = _per_policy(model, loss, fused_calls)
    for remat, (grads, calls) in results.items():
        _assert_equal(grads, results[False][0])
        assert calls == DEPTH * (1 if remat in SAVES_ATTENTION else 2), (remat, calls)
        assert grads["blocks.0.attn.q_scale"].abs().sum() > 0


def _batch(seed=0):
    """A numpy batch in make_ssl_batch's layout (as test_torch_train_step's)."""
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


def _port_batch(batch):
    return _to(batch, lambda k, v: torch.tensor(v).long() if k in ("text", "mask_indices")
               else torch.tensor(v))


def _port_step(remat, jstate=None, jcfg=None):
    cfg = VTPConfig(**VTP_TINY)
    tcfg = TrainConfig(compute_dtype="bf16", **dict(TRAIN, remat=remat))
    state = init_state(cfg, tcfg, torch.Generator().manual_seed(3), device="cpu")
    if jstate is not None:
        load_numpy_train_state(state, _state_sd(jstate["params"], jcfg),
                               teacher=_state_sd(jstate["teacher"], jcfg))
    return state, build_train_step(cfg, tcfg)


def test_vtp_step_policies_bit_equal_and_counted(fused_calls):
    """Metrics and every leaf's first moment (0.1 x the clipped gradient,
    from zero moments) bit-equal to remat=False. The teacher's no-grad
    forwards and the text and decoder towers count too: the recompute adds
    a block's launches for each fused call under grad."""
    batch = _port_batch(_batch(1))
    results = {}
    for remat in POLICIES:
        state, step = _port_step(remat)
        fused_calls[0] = 0
        state, metrics = step(state, batch)
        results[remat] = (metrics, dict(state.optimizer.mu), fused_calls[0])
    m0, mu0, calls0 = results[False]
    recomputed = results[True][2] - calls0
    assert recomputed > 0
    for remat, (metrics, mu, calls) in results.items():
        _assert_equal(metrics, m0)
        _assert_equal(mu, mu0)
        assert calls == calls0 + (0 if remat in SAVES_ATTENTION else recomputed), (remat, calls)


def _head_sd(head):
    sd = {}
    for name, lin in head["mlp"].items():
        sd[f"dino_head.mlp.{name}.weight"] = np.asarray(lin["kernel"], np.float32).T
        sd[f"dino_head.mlp.{name}.bias"] = np.asarray(lin["bias"], np.float32)
    sd["dino_head.last_layer.v"] = np.asarray(head["last_layer"]["v"], np.float32).T
    sd["dino_head.last_layer.g"] = np.asarray(head["last_layer"]["g"], np.float32)
    return sd


def _state_sd(tree, cfg):
    sd = export_state_dict({k: v for k, v in tree.items() if k != "dino_head"}, cfg)
    sd.update(_head_sd(tree["dino_head"]))
    return sd


def _jax_array(key, v):
    return jnp.asarray(v, jnp.int32) if key in ("text", "mask_indices") else jnp.asarray(v)


@pytest.mark.parametrize("remat", ["attn", "dots"])
def test_vtp_step_policy_matches_jax(remat, kernels):
    kernels(interpret=True)
    batch = _batch()
    jcfg = JaxConfig(**VTP_TINY)
    jtcfg = JaxTrainConfig(compute_dtype="bf16", **dict(TRAIN, remat=remat))
    jstate = jax_init_state(jax.random.key(0), jcfg, jtcfg)
    _, jmetrics = jax.jit(jax_build_train_step(jcfg, jtcfg))(jstate, _to(batch, _jax_array),
                                                              jax.random.key(1))
    state, step = _port_step(remat, jstate, jcfg)
    _, metrics = step(state, _port_batch(batch))
    assert set(metrics) == set(jmetrics)
    for name in metrics:
        got, want = float(metrics[name]), float(jmetrics[name])
        rel = 2e-2 if name == "grad_norm" else 5e-3
        assert np.isfinite(got) and abs(got - want) <= rel * abs(want), (name, got, want)


@pytest.mark.parametrize("bad", ["everything", "attn_out", 1])
def test_unknown_policy_raises(bad):
    with pytest.raises(ValueError, match="unknown remat mode"):
        checkpoint_policy(bad)
    model = DiT.init(DiTConfig(**DIT_TINY), torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError):
        model(torch.zeros(1, 8, 4, 4), torch.zeros(1), torch.zeros(1, dtype=torch.long), remat=bad)
