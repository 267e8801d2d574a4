"""Drop-path (``models/blocks.py``) against the JAX package's, and its
traps: a block fed the JAX draws, the keep counts, remat with a generator,
and a sample dropped from every branch.

Gates, from the JAX package's parity gates (ROADMAP): fp32 <= 5e-4 abs,
bf16 <= 5e-2 of max|ref|; remat bit-equal to no remat; the zero-safe
normalize keeps the grad norm below 1e5 where the clamped one passes 1e8
(``tests/test_train_step.py``'s bounds for the JAX step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.convert.to_torch import _blocks_out
from vtp_tpu.models.blocks import BlockConfig as JaxBlockConfig
from vtp_tpu.models.blocks import _block_apply_droppath, init_stacked_blocks
from vtp_tpu.models.blocks import drop_keep_count as jax_drop_keep_count
from vtp_tpu_torch import VTPConfig
from vtp_tpu_torch.models.blocks import Block, BlockConfig, draw_drop_indices, drop_keep_count
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos
from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state, make_ssl_batch

torch.set_num_threads(1)
F32_ABS, BF16_REL = 5e-4, 5e-2
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
            text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=1,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=1,
            rope_shift_coords=0.1, rope_jitter_coords=1.2, rope_rescale_coords=2.0)
TRAIN = dict(dino_out_dim=256, dino_hidden_dim=32, dino_bottleneck_dim=16, warmup_steps=0,
             total_steps=10, clip_drop_rate=0.3, ssl_drop_rate=0.3, rec_drop_rate=0.3)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_drop_keep_count_matches_jax(shards):
    for batch in (1, 2, 3, 7, 8, 16, 33, 64):
        for ratio in (0.0, 0.1, 0.25, 0.5, 0.9, 0.99):
            assert drop_keep_count(batch, ratio, shards) == jax_drop_keep_count(batch, ratio,
                                                                                shards)


def _jax_indices(key, batches, ratio):
    """The rows ``_block_apply_droppath`` keeps for ``key``: attention
    subsets of each crop, then the FFN's."""
    keys = jax.random.split(key, 2 * len(batches))
    return [jax.random.permutation(k, b)[:jax_drop_keep_count(b, ratio)]
            for k, b in zip(keys, list(batches) * 2)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_droppath_block_matches_jax(dtype, kernels):
    """Two crops of different batch and length (a 4x4 and a 2x2 grid after
    a cls token) through one block with LayerScale at drop ratio 0.3, the
    port fed the rows JAX draws from its key. bf16 runs the JAX Pallas
    kernel in interpret mode; fp32 its XLA reference, which rounds the bf16
    RoPE as the port does (the interpret-mode kernel rounds it once, and
    fp32 against it is held to the bf16 gate; ROADMAP, Queue 3)."""
    kernels(interpret=dtype == "bf16")
    kw = dict(dim=128, num_heads=2, layerscale_init=0.5)
    jcfg = JaxBlockConfig(**kw)
    stacked = init_stacked_blocks(jax.random.key(1), jcfg, 1)
    stacked = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(jax.random.key(2), a.shape),
                           stacked)
    sd = {}
    _blocks_out(sd, "b", stacked, 1)
    block = Block(BlockConfig(**kw))
    block.load_state_dict({k[len("b.0."):]: torch.tensor(v) for k, v in sd.items()})
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((6, 17, 128)).astype(np.float32),
          rng.standard_normal((8, 5, 128)).astype(np.float32)]
    ropes = [pad_rope_prefix(*rope_sincos(rope_periods_init(64), g, g), 1) for g in (4, 2)]
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bf16" else (None, jnp.float32)
    key = jax.random.key(7)
    idx = [torch.tensor(np.asarray(i)).long() for i in _jax_indices(key, [6, 8], 0.3)]
    assert [len(i) for i in idx] == [4, 5, 4, 5]
    with torch.no_grad():
        got = block.forward_droppath([torch.tensor(x).to(tdt or torch.float32) for x in xs],
                                     ropes, [17, 5], idx, tdt)
    jropes = [tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in r) for r in ropes]
    want = _block_apply_droppath(tuple(jnp.asarray(x, jdt) for x in xs),
                                 jax.tree.map(lambda a: a[0], stacked), jcfg, jropes,
                                 compute_dtype=None if dtype == "fp32" else jdt, drop_ratio=0.3,
                                 key=key, drop_shards=1, n_valids=[17, 5])
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape
        err = np.abs(g - w).max()
        assert err <= (F32_ABS if dtype == "fp32" else BF16_REL * np.abs(w).max()), err
    # rows outside both subsets pass through unchanged
    kept = set(idx[1].tolist()) | set(idx[3].tolist())
    rest = [r for r in range(8) if r not in kept]
    x1 = torch.tensor(xs[1]).to(tdt or torch.float32)
    assert rest and torch.equal(got[1][rest], x1[rest])


def _batch(seed, B=2):
    g = torch.Generator().manual_seed(seed)
    ssl = make_ssl_batch(g, B, global_size=32, local_size=16, n_local=2, device="cpu")
    image = torch.randn((B, 3, 32, 32), generator=g)
    return dict(image=image, text=torch.randint(1, 127, (B, 8), generator=g), rec_image=image,
                ssl=ssl)


@pytest.mark.parametrize("remat", [True, "attn"])
def test_remat_with_a_generator_matches_no_remat(remat):
    """Drop-path and the RoPE augmentation under remat: the rows and factors
    are drawn before the checkpointed blocks, so the recompute sees the
    forward's and the step is bit-equal to remat off (the Adam moments are
    0.1 x the clipped gradient, from zero)."""
    batch = _batch(1)
    results = []
    for policy in (False, remat):
        cfg, tcfg = VTPConfig(**TINY), TrainConfig(compute_dtype="fp32", remat=policy, **TRAIN)
        state = init_state(cfg, tcfg, torch.Generator().manual_seed(0), device="cpu")
        state, metrics = build_train_step(cfg, tcfg)(state, batch,
                                                     torch.Generator().manual_seed(5))
        results.append((metrics, state.optimizer.mu))
    (m0, mu0), (m1, mu1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(mu0[k], mu1[k]) for k in mu0)
    assert mu0["trunk.blocks.1.attn.qkv.weight"].abs().sum() > 0


def test_step_needs_a_generator_or_draws():
    cfg, tcfg = VTPConfig(**TINY), TrainConfig(compute_dtype="fp32", **TRAIN)
    state = init_state(cfg, tcfg, device="cpu")
    with pytest.raises(ValueError, match="generator or draws"):
        build_train_step(cfg, tcfg)(state, _batch(0))


@pytest.mark.parametrize("zero_safe", [True, False])
def test_fully_dropped_sample_keeps_grad_norm_bounded(zero_safe):
    """Global crop 0, whose patches are masked, is dropped from every branch
    of every block: its masked tokens stay the zero ``mask_token`` through
    the student's trunk and head MLP. The zero-safe normalize keeps the
    grad norm bounded; the clamped one (``zero_safe_normalize=False``)
    spikes by its 1/eps Jacobian, as in the JAX step."""
    cfg = VTPConfig(**dict(TINY, rope_shift_coords=None, rope_jitter_coords=None,
                           rope_rescale_coords=None))
    tcfg = TrainConfig(compute_dtype="fp32", zero_safe_normalize=zero_safe,
                       **dict(TRAIN, clip_drop_rate=0.0, rec_drop_rate=0.0, ssl_drop_rate=0.5))
    state = init_state(cfg, tcfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"ssl": _batch(2, B=4)["ssl"]}
    ssl = batch["ssl"]
    ssl["masks"][0] = True  # every patch of global crop 0 masked
    n_patch = ssl["masks"].shape[1]
    ssl["mask_indices"][:n_patch] = torch.arange(n_patch)
    ssl["mask_weight"][:n_patch] = 1.0
    step = build_train_step(cfg, tcfg)
    draws = step.sample_draws(state, torch.Generator().manual_seed(3), batch)
    n_global = ssl["global_crops"].shape[0]
    keep = drop_keep_count(n_global, 0.5)
    for layer in draws["ssl"]["drop"]:
        layer[0] = layer[2] = torch.arange(1, keep + 1)  # crop 0 dropped from both branches
    _, metrics = step(state, batch, draws=draws)
    norm = float(metrics["grad_norm"])
    if zero_safe:
        assert np.isfinite(norm) and norm < 1e5, norm
    else:
        assert norm > 1e8, norm


def test_draw_drop_indices_layout():
    g = torch.Generator().manual_seed(0)
    draws = draw_drop_indices(g, [8, 16], depth=3, drop_ratio=0.25)
    assert len(draws) == 3 and all(len(layer) == 4 for layer in draws)
    for layer in draws:
        assert [len(i) for i in layer] == [6, 12, 6, 12]
        for i, b in zip(layer, [8, 16, 8, 16]):
            assert len(set(i.tolist())) == len(i) and int(i.max()) < b


@pytest.mark.parametrize("remat", [True, "attn"])
def test_wrapper_calls_of_an_accumulated_step(remat, monkeypatch):
    """The calls of each kernel's wrapper (a launch on the card) in a bf16
    step of 2 microbatches with drop-path and the RoPE augmentation, per
    microbatch: the fused forward once a block in the teacher (v), the clip
    and rec trunks (2v), the student's two crops (2v), the decoder (d) and
    the text tower (t), and again in the backward for the blocks under grad
    at remat "full" (4v + d + t; "attn" saves it); its backward 4v + d + t;
    the fused CE 3 + 3 (DINO globals, locals, iBOT)."""
    from vtp_tpu_torch.ops import flash_attention as fa
    from vtp_tpu_torch.ops import fused_ce

    calls = {}

    def counting(module, name):
        plain = getattr(module, name)

        def fn(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return plain(*args, **kwargs)

        monkeypatch.setattr(module, name, fn)

    for module, name in ((fa, "_forward"), (fa, "fused_qkv_rope_attention_bwd"),
                         (fused_ce, "fused_ce_fwd"), (fused_ce, "fused_ce_bwd")):
        counting(module, name)
    cfg = VTPConfig(**TINY)
    tcfg = TrainConfig(compute_dtype="bf16", remat=remat, accum_steps=2, **TRAIN)
    state = init_state(cfg, tcfg, torch.Generator().manual_seed(0), device="cpu")
    a, b = _batch(3), _batch(4)
    batch = {k: ({kk: torch.stack([a[k][kk], b[k][kk]]) for kk in a[k]} if k == "ssl"
                 else torch.stack([a[k], b[k]])) for k in a}
    build_train_step(cfg, tcfg)(state, batch, torch.Generator().manual_seed(1))
    v, d, t = cfg.vision_depth, cfg.decoder_depth, cfg.text_depth
    under_grad = 4 * v + d + t
    fwd = v + under_grad + (under_grad if remat is True else 0)
    assert calls == {"_forward": 2 * fwd, "fused_qkv_rope_attention_bwd": 2 * under_grad,
                     "fused_ce_fwd": 6, "fused_ce_bwd": 6}
