"""The port's linear probe (``eval/linear_probe.py``) against
``vtp_tpu.eval.linear_probe`` on the CPU, on a tiny VTP with the same
weights and the same initial heads carried across: ``create_linear_input``,
three train steps (losses, heads and momentum), ``evaluate_linear_probe``
(its counts, named by ``pcfg.batch_size`` as JAX names them), ``head_names``
and the cosine scale.

Gates: with the encode in fp32 in both, the features and the heads and
momentum after each step within 5e-4 abs, the losses within 5e-3 rel and
the counts equal; with the encode in bf16, the losses within 5e-3 rel;
``create_linear_input`` on bf16 features within 5e-2 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.eval import linear_probe as jlp
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.eval import linear_probe as lp

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
LOSS_REL = 5e-3
TINY = dict(image_size=32, vision_patch_size=8, vision_embed_dim=64, vision_depth=3,
            vision_num_heads=2, vision_feature_bottleneck=16, decoder_embed_dim=64,
            decoder_depth=1, decoder_num_heads=1, train_clip=False)
PCFG = dict(n_last_blocks_list=(1, 2), learning_rates=(0.5, 2.0, 8.0), num_classes=5, epochs=1,
            epoch_length=4, batch_size=4, feature_blocks=2)


@pytest.fixture(scope="module")
def pair():
    jc = JaxConfig(**TINY)
    jm = JaxModel.init(jax.random.key(0), jc)
    model = VTPModel(VTPConfig(**TINY), device="cpu")
    model.load_numpy_state_dict(export_state_dict(jm.params, jc))
    return jc, jm, model


def _batches(n, seed=1, batch=4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 3, 32, 32)).astype(np.float32),
             rng.integers(0, 5, batch)) for _ in range(n)]


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, atol=F32_ABS):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= atol, np.abs(got - want).max()


@pytest.mark.parametrize("n,avgpool", [(1, True), (2, True), (2, False)])
def test_create_linear_input_matches_jax(n, avgpool):
    rng = np.random.default_rng(2)
    feats = [(rng.standard_normal((3, 5, 8)).astype(np.float32),
              rng.standard_normal((3, 8)).astype(np.float32)) for _ in range(3)]
    for jdt, tdt, atol in ((jnp.float32, torch.float32, 1e-6),
                           (jnp.bfloat16, torch.bfloat16, BF16_REL)):  # bf16 means round
        want = jlp.create_linear_input([(jnp.asarray(p, jdt), jnp.asarray(c, jdt))
                                        for p, c in feats], n, avgpool)
        got = lp.create_linear_input([(torch.from_numpy(p).to(tdt), torch.from_numpy(c).to(tdt))
                                      for p, c in feats], n, avgpool)
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 8 * (n + int(avgpool)))
        _close(got.numpy(), want, atol=atol * np.abs(np.asarray(want)).max())


def test_extract_features_match_jax(pair):
    jc, jm, model = pair
    images = _batches(1)[0][0]
    want = jlp.extract_features(jm.params, jc, jnp.asarray(images), 2, None)
    got = lp.extract_features(model, torch.from_numpy(images), 2, None)
    assert len(got) == len(want) == 2
    for (gp, gc), (wp, wc) in zip(got, want):
        _close(gp.numpy(), wp)
        _close(gc.numpy(), wc)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_train_steps_match_jax(pair, dtype):
    jc, jm, model = pair
    pcfg_j, pcfg_t = jlp.ProbeConfig(**PCFG), lp.ProbeConfig(**PCFG)
    heads = jlp.init_probe_heads(jax.random.key(3), jc, pcfg_j, global_batch=8)
    jstate = jlp.init_probe_state(heads)
    tstate = lp.init_probe_state(_to_torch(heads))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    jstep = jlp.build_probe_train_step(jm.params, jc, pcfg_j, jdt)
    tstep = lp.build_probe_train_step(model, pcfg_t, tdt)
    for images, labels in _batches(3):
        first = tstate
        jstate, jloss = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
        tstate, tloss = tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels))
        assert abs(tloss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
        assert first["step"].item() == tstate["step"].item() - 1  # the state given is kept
        if dtype == "fp32":
            for part in ("heads", "momentum"):
                for key in jstate[part]:
                    for leaf in ("w", "b"):
                        _close(tstate[part][key][leaf].numpy(), jstate[part][key][leaf])
    assert tstate["step"].item() == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    start = _to_torch(heads)
    for key in heads:
        assert torch.equal(tstate["heads"][key]["lr"], start[key]["lr"])
        assert not torch.equal(tstate["heads"][key]["w"], start[key]["w"])  # the heads moved


def test_evaluate_linear_probe_matches_jax(pair):
    jc, jm, model = pair
    pcfg_j, pcfg_t = jlp.ProbeConfig(**PCFG), lp.ProbeConfig(**PCFG)
    heads = jlp.init_probe_heads(jax.random.key(4), jc, pcfg_j, global_batch=8)
    jstate = jlp.init_probe_state(heads)
    jstep = jlp.build_probe_train_step(jm.params, jc, pcfg_j, None)
    for images, labels in _batches(2, seed=5):
        jstate, _ = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
    tstate = lp.init_probe_state(_to_torch(jstate["heads"]))
    val = _batches(3, seed=6, batch=3)
    want = jlp.evaluate_linear_probe(jm.params, jc, jstate, val, pcfg_j, None)
    got = lp.evaluate_linear_probe(model, tstate, val, pcfg_t, None)
    assert got == want  # the same keys (lr x batch_size / 256, not the global batch) and counts
    assert sorted(got) == sorted(lp.head_names(pcfg_t, pcfg_t.batch_size))


@pytest.mark.parametrize("global_batch", [4, 256, 1024])
def test_head_names_and_init_match_jax(pair, global_batch):
    jc, _, model = pair
    pcfg = lp.ProbeConfig()
    assert lp.head_names(pcfg, global_batch) == jlp.head_names(jlp.ProbeConfig(), global_batch)
    assert lp.DEFAULT_LEARNING_RATES == jlp.DEFAULT_LEARNING_RATES
    assert len(lp.DEFAULT_LEARNING_RATES) == 13
    assert pcfg.max_iter == jlp.ProbeConfig().max_iter == 12500
    small = lp.ProbeConfig(**PCFG)
    heads = lp.init_probe_heads(model.config, small, global_batch, device="cpu")
    want = jlp.init_probe_heads(jax.random.key(0), jc, jlp.ProbeConfig(**PCFG), global_batch)
    for key in want:
        for leaf in ("w", "b", "lr"):
            assert tuple(heads[key][leaf].shape) == want[key][leaf].shape
        _close(heads[key]["lr"].numpy(), want[key]["lr"], atol=1e-7)
        assert not heads[key]["b"].any()
        assert abs(heads[key]["w"].std().item() / 0.01 - 1) < 0.1


@pytest.mark.parametrize("step", [0, 1, 7, 12499, 12500, 20000])
def test_cosine_scale_matches_jax(step):
    max_iter = 12500
    t = np.clip(np.float32(step) / max_iter, 0.0, 1.0)
    want = 0.5 * (1.0 + np.cos(np.pi * t, dtype=np.float32))
    got = lp.cosine_lr_scale(torch.tensor(step, dtype=torch.int32), max_iter)
    assert got.dtype == torch.float32 and abs(got.item() - want) <= 1e-6
