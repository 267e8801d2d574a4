"""The VTP and DiT train steps of the port over CPU gloo meshes against the
JAX package's step on the same global batch, state and draws.

The JAX step (one device; its math is the same under GSPMD on any mesh)
runs once, with ``drop_shards = 2``, drop-path on the SSL branch (the CLIP
and reconstruction branches keep every row, so sequence parallelism
engages there) and the RoPE coordinate augmentation; the port is fed the
JAX step's draws. Arms, each one train step from the JAX state:

  * one process without a mesh (drop_shards alone, as the JAX package runs
    it on one device);
  * DP (2, 1) and head-major TP (1, 2) on two ranks;
  * DP x TP + SP (2, 2), ZeRO-3 FSDP (4, 1) and ZeRO-3 FSDP x head-major
    TP (2, 2) on four ranks (FSDP with ``min_elems = 256`` so that the tiny
    model's leaves shard); the (4, 1) state is also saved and restored into
    a replicated state and back;
  * the DiT step data-parallel on two ranks, against the JAX reference
    step of ``test_torch_dit.py``.

Gates, the JAX package's: each loss within 5e-3 rel, the grad norm within
2e-2 rel; the updated student within atol 1e-3 / rtol 5e-3 (the head-major
arm's through the inverse permutation); the Adam first moment (0.1 x the
clipped gradient) within 1e-3 of each leaf's max |mu|; teacher and centers
5e-4 abs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_dit as dit_tests
from tests.torch_dist import run_ranks
from tests.torch_parallel_workers import dit_dp_step, run_both, vtp_step_arms
from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models.blocks import drop_keep_count as jax_drop_keep_count
from vtp_tpu.train.step import TrainConfig as JaxTrainConfig
from vtp_tpu.train.step import build_train_step as jax_build_train_step
from vtp_tpu.train.step import init_state as jax_init_state
from vtp_tpu_torch import VTPConfig
from vtp_tpu_torch.dit.model import DiTConfig
from vtp_tpu_torch.dit.train import DiTTrainConfig, build_dit_train_step, init_dit_state
from vtp_tpu_torch.models.dino_head import head_state_dict
from vtp_tpu_torch.models.vtp_model import checkpoint_name
from vtp_tpu_torch.parallel.sharding import permute_qkv_state_dict
from vtp_tpu_torch.train.state import load_numpy_train_state
from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state

torch.set_num_threads(1)
AUG = (0.1, 1.2, 2.0)
CFG = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
           vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
           text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=1,
           decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=1,
           rope_shift_coords=AUG[0], rope_jitter_coords=AUG[1], rope_rescale_coords=AUG[2])
TRAIN = dict(dino_out_dim=512, dino_hidden_dim=32, dino_bottleneck_dim=16, warmup_steps=0,
             total_steps=10, remat=False, ssl_drop_rate=0.3, drop_shards=2,
             compute_dtype="fp32")
B, N_LOCAL, SHARDS = 4, 2, 2
ARMS2 = [("dp_2x1", (2, 1), {}, False),
         ("tp_1x2_head_major", (1, 2), {"tp_head_major": 2}, False)]
ARMS4 = [("dp_tp_sp_2x2", (2, 2), {"sequence_parallel": True}, False),
         ("fsdp_4x1", (4, 1), {}, True),
         ("fsdp_tp_2x2", (2, 2), {"tp_head_major": 2}, True)]
HEAD_MAJOR = {"tp_1x2_head_major", "fsdp_tp_2x2"}
ARMS = [a[0] for a in ARMS2 + ARMS4]
DIT = dict(input_size=4, in_channels=8, dim=128, depth=2, num_heads=2, num_classes=10)
DIT_TRAIN = dict(learning_rate=1e-3, total_steps=3, ema_decay=0.5, class_dropout_prob=0.5,
                 compute_dtype="fp32")


# ---------------------------------------------------------- the JAX draws

def _rope_draws(key):
    k_shift, k_jitter, k_rescale = jax.random.split(key, 3)
    shift, jitter, rescale = AUG
    m_j, m_r = math.log(jitter), math.log(rescale)
    out = {"shift": jax.random.uniform(k_shift, (2,), jnp.float32, -shift, shift),
           "jitter": jnp.exp(jax.random.uniform(k_jitter, (2,), jnp.float32, -m_j, m_j)),
           "rescale": jnp.exp(jax.random.uniform(k_rescale, (1,), jnp.float32, -m_r, m_r))}
    return {k: np.asarray(v) for k, v in out.items()}


def _forward_draws(key, batches, ratio):
    rope_key, drop_key = jax.random.split(key)
    out = {"rope": [_rope_draws(jax.random.fold_in(rope_key, i)) for i in range(len(batches))]}
    if ratio > 0:
        out["drop"] = []
        for layer_key in jax.random.split(drop_key, CFG["vision_depth"]):
            keys = jax.random.split(layer_key, 2 * len(batches))
            out["drop"].append([
                np.asarray(jax.random.permutation(k, b)[:jax_drop_keep_count(b, ratio, SHARDS)])
                .astype(np.int64) for k, b in zip(keys, list(batches) * 2)])
    return out


def _step_draws(key):
    k_clip, k_rec, k_ssl = jax.random.split(key, 3)
    return {"clip": _forward_draws(k_clip, [B], 0.0), "rec": _forward_draws(k_rec, [B], 0.0),
            "ssl": _forward_draws(k_ssl, [2 * B, N_LOCAL * B], TRAIN["ssl_drop_rate"])}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    t = torch.from_numpy(np.array(tree))
    return t.long() if t.dtype == torch.int64 else t


def _batch(seed=0):
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


def _jax_batch(batch):
    return {k: _jax_batch(v) if isinstance(v, dict) else
            jnp.asarray(v, jnp.int32) if k in ("text", "mask_indices") else jnp.asarray(v)
            for k, v in batch.items()}


def _state_sd(tree, cfg):
    sd = export_state_dict({k: v for k, v in tree.items() if k != "dino_head"}, cfg)
    sd.update((f"dino_head.{k}", v.numpy()) for k, v in head_state_dict(tree["dino_head"]).items())
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


# ------------------------------------------------------------------ runs

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import dataclasses

    from vtp_tpu.ops import dispatch

    jcfg, jtcfg = JaxConfig(**CFG), JaxTrainConfig(**TRAIN)
    jstate = jax_init_state(jax.random.key(0), jcfg, jtcfg)
    batch = _batch()
    key = jax.random.key(1)
    # the JAX step on its kernels (interpret mode), as the port's step mirrors them
    saved = dataclasses.asdict(dispatch.kernel_dispatch())
    dispatch.configure_kernels(interpret=True)
    try:
        jnew, jmetrics = jax.jit(jax_build_train_step(jcfg, jtcfg))(jstate, _jax_batch(batch),
                                                                   key)
    finally:
        dispatch.configure_kernels(**saved)
    draws = _step_draws(key)
    params, teacher = _state_sd(jstate["params"], jcfg), _state_sd(jstate["teacher"], jcfg)
    want = {"metrics": {k: float(v) for k, v in jmetrics.items()},
            "student": _state_sd(jnew["params"], jcfg),
            "teacher": _state_sd(jnew["teacher"], jcfg),
            "mu": _state_sd(jnew["opt_state"][1][0].mu, jcfg),
            "dino_center": np.asarray(jnew["dino_center"]),
            "ibot_center": np.asarray(jnew["ibot_center"])}

    # one process, no mesh
    cfg, tcfg = VTPConfig(**CFG), TrainConfig(**TRAIN)
    state = init_state(cfg, tcfg, device="cpu")
    load_numpy_train_state(state, params, teacher=teacher)
    state, metrics = build_train_step(cfg, tcfg)(state, _torch_tree(batch),
                                                 draws=_torch_tree(draws))
    f32 = lambda t: t.float().numpy()
    got = {"one_process": {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "student": {k: f32(v) for k, v in state.model.state_dict().items()},
        "teacher": {f"{p}.{k}": f32(v) for p, m in state.teacher.items()
                    for k, v in m.state_dict().items()},
        "mu": {n: f32(m) for n, m in state.optimizer.mu.items()},
        "dino_center": f32(state.dino_center), "ibot_center": f32(state.ibot_center)}}

    # the DiT: the JAX reference step of test_torch_dit on a global batch of 4
    dcfg, dparams = dit_tests._jax_params(DIT)
    dtcfg = DiTTrainConfig(**DIT_TRAIN)
    from vtp_tpu.dit import train as jtrain

    jstep, optimizer = dit_tests._jax_reference_step(
        dcfg, jtrain.DiTTrainConfig(**dataclasses.asdict(dtcfg)))
    jp = jax.tree.map(jnp.asarray, dparams)
    rng = np.random.default_rng(7)
    shape = (4, DIT["in_channels"], DIT["input_size"], DIT["input_size"])
    latents = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, DIT["num_classes"], (4,)).astype(np.int64)
    dkey = jax.random.key(11)
    djnew, djmetrics = jstep({"params": jp, "ema": jp, "opt_state": optimizer.init(jp)},
                             jnp.asarray(latents), jnp.asarray(labels, jnp.int32), dkey)
    ddraws = {k: v.numpy() for k, v in dit_tests._port_draws(dkey, (4,), shape, dtcfg).items()}
    port_params = dit_tests._by_port_name(DIT, dparams)
    dstate = init_dit_state(DiTConfig(**DIT), dtcfg, device="cpu")
    dstate.model.load_state_dict({k: torch.tensor(v) for k, v in port_params.items()})
    dstate, _ = build_dit_train_step(dstate.model.config, dtcfg)(
        dstate, torch.tensor(latents), torch.tensor(labels), None,
        {k: torch.tensor(v) for k, v in ddraws.items()})
    dit_want = {"metrics": {k: float(v) for k, v in djmetrics.items()},
                "params": dit_tests._by_port_name(DIT, djnew["params"]), "start": port_params,
                "one_process_mu": {k: v.numpy() for k, v in dstate.optimizer.mu.items()},
                "mu": dit_tests._by_port_name(DIT, djnew["opt_state"][1][0].mu)}

    two = run_ranks(run_both, 2, tmp_path_factory.mktemp("step2"),
                    (vtp_step_arms, (CFG, TRAIN, ARMS2, params, teacher, batch, draws)),
                    (dit_dp_step, (DIT, DIT_TRAIN, port_params, latents, labels, ddraws)))
    four = run_ranks(vtp_step_arms, 4, tmp_path_factory.mktemp("step4"), CFG, TRAIN, ARMS4,
                     params, teacher, batch, draws, str(tmp_path_factory.mktemp("ckpt4")))
    got.update(two[0][0])
    got.update(four[0])
    return want, got, dit_want, two[0][1], (two, four)


def _gate_metrics(got, want):
    assert set(got) == set(want)
    for name in got:
        rel = 2e-2 if name.startswith("grad_norm") else 5e-3
        assert np.isfinite(got[name]) and abs(got[name] - want[name]) <= rel * abs(want[name]), \
            (name, got[name], want[name])


def _canonical(sd, arm):
    if arm in HEAD_MAJOR:
        return permute_qkv_state_dict(sd, CFG["vision_num_heads"], 2, inverse=True)
    return sd


@pytest.mark.parametrize("arm", ["one_process"] + ARMS)
def test_vtp_step_metrics_match_jax(runs, arm):
    want, got, *_ = runs
    _gate_metrics(got[arm]["metrics"], want["metrics"])


@pytest.mark.parametrize("arm", ["one_process"] + ARMS)
def test_vtp_step_state_matches_jax(runs, arm):
    want, got, *_ = runs
    g = got[arm]
    student = _canonical({checkpoint_name(k): v for k, v in g["student"].items()}, arm)
    for k, v in student.items():
        np.testing.assert_allclose(v, want["student"][k], atol=1e-3, rtol=5e-3, err_msg=k)
    mu = _canonical({checkpoint_name(k): v for k, v in g["mu"].items()}, arm)
    assert set(mu) == set(want["mu"])
    for k, v in mu.items():
        assert np.abs(v - want["mu"][k]).max() <= 1e-3 * np.abs(want["mu"][k]).max(), k
    teacher = _canonical(g["teacher"], arm)
    for k, v in teacher.items():
        assert np.abs(v - want["teacher"][k]).max() <= 5e-4, k
    for name in ("dino_center", "ibot_center"):
        assert np.abs(g[name] - want[name]).max() <= 5e-4, name


def test_arms_layouts(runs):
    """The head-major arms keep their trunk declared head-major; the ZeRO-3
    arms' optimizer leaves are the modules' own slabs, read whole through
    their gathers (each reduce-scattered in the backward), and a rank holds
    ``sharded_bytes`` of its state: JAX's rule at a model axis of 1, and
    over a model axis that rule with the moments cut as their parameters
    (``fsdp.held_specs``; JAX's moments take no model dim); SP runs its
    row collectives, plain TP only the Megatron pair, DP none of them."""
    _, got, *_ = runs
    assert got["tp_1x2_head_major"]["config_hm"] == 2
    assert got["fsdp_tp_2x2"]["config_hm"] == 2
    assert got["dp_2x1"]["config_hm"] == 1
    for arm in ("fsdp_4x1", "fsdp_tp_2x2"):
        assert got[arm]["leaves_are_modules"], arm
        calls = got[arm]["calls"]
        assert calls["fsdp_gather"] > 0 and calls["fsdp_reduce_scatter"] > 0, (arm, calls)
        assert calls["fsdp_regather"] > 0, (arm, calls)
    held = got["fsdp_4x1"]["bytes"]
    assert held["held"] == held["jax_rule"] == held["held_specs"] < held["replicated"]
    held = got["fsdp_tp_2x2"]["bytes"]
    assert held["held"] == held["held_specs"] < held["jax_rule"] < held["replicated"]
    assert got["fsdp_tp_2x2"]["calls"].get("reduce_from_model", 0) > 0
    assert got["dp_tp_sp_2x2"]["calls"].get("gather_seq", 0) > 0
    assert got["dp_tp_sp_2x2"]["calls"].get("reduce_scatter_seq", 0) > 0
    assert got["tp_1x2_head_major"]["calls"].get("gather_seq", 0) == 0
    assert got["tp_1x2_head_major"]["calls"].get("reduce_from_model", 0) > 0
    assert got["dp_2x1"]["calls"].get("gather_with_grad", 0) > 0


@pytest.mark.parametrize("arm", ["fsdp_4x1", "fsdp_tp_2x2"])
def test_zero3_checkpoint_roundtrip(runs, arm):
    """A ZeRO-3 state (the (2, 2) arm's beside a head-major model axis),
    saved, restores into a replicated state equal to its gathered slabs, and
    that state, saved, restores into a fresh ZeRO-3 state equal to the
    first, each bit for bit: the format on disk is the whole tensors,
    whatever the layout that wrote it. ``slab`` and ``gather`` invert each
    other on every sharded leaf, the trunk stored canonical or head-major."""
    *_, (two, four) = runs
    for r in four:
        assert r[arm]["roundtrip"] == {"to_replicated": True, "to_zero3": True}
        assert all(r[arm]["slab_gather"].values()) and len(r[arm]["slab_gather"]) == (
            2 if arm == "fsdp_tp_2x2" else 1)


def test_ranks_agree(runs):
    """Every rank of an arm reports the same (globally reduced) metrics."""
    *_, (two, four) = runs
    for ranks, arms in ((two, [a[0] for a in ARMS2]), (four, [a[0] for a in ARMS4])):
        for arm in arms:
            first = (ranks[0][0] if ranks is two else ranks[0])[arm]["metrics"]
            for r in ranks[1:]:
                assert (r[0] if ranks is two else r)[arm]["metrics"] == first, arm


def _rel_l2(got, want, total):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-3 * total)


def _expected_flips(got_mu, want_mu) -> float:
    """The sign flips a leaf would show if each element's first moment
    carried a Gaussian error of the leaf's RMS moment error: the sum of
    Phi(-|mu| / rms) over the elements either side moved (a leaf's untouched
    rows, exactly 0 on both, cannot flip)."""
    active = (got_mu != 0) | (want_mu != 0)
    if not active.any():
        return 0.0
    rms = np.sqrt(np.mean(np.square(got_mu - want_mu, dtype=np.float64)[active]))
    z = torch.from_numpy(-np.abs(want_mu[active]).astype(np.float64) / max(rms, 1e-300))
    return float(torch.special.ndtr(z).sum())


def _hold_flips(name, got, want, got_mu, want_mu, lr):
    """Every element of a trained leaf within atol 1e-3 / rtol 5e-3, but
    for sign flips: Adam's first step moves each element by about ``lr``
    whatever its gradient's size, so an element whose gradient sums to the
    other sign in another order moves 2 lr the other way. A flip must have
    first moments of other signs (the update follows its own gradient) and
    miss by at most 2 lr, and a leaf may hold at most 2 E + 1 of them, E
    its ``_expected_flips`` (2 for errors heavier than Gaussian near zero,
    1 for a leaf that expects less than one). Returns the count."""
    diff = np.abs(got - want)
    bad = diff > 1e-3 + 5e-3 * np.abs(want)
    flips = bad & (diff <= 2 * lr + 1e-6) & (np.sign(got_mu) != np.sign(want_mu))
    assert not (bad & ~flips).any(), (name, float(diff[bad & ~flips].max()))
    expected = _expected_flips(got_mu, want_mu)
    assert flips.sum() <= 2 * expected + 1, (name, int(flips.sum()), expected)
    return int(flips.sum())


def test_dit_dp_step_matches_jax(runs):
    """The DiT step on two ranks against the JAX reference step: metrics at
    the gates; the Adam first moment per leaf within 5e-2 relative L2 (its
    norm floored at 1e-3 of the whole; in one process the fused head-dim-64
    fp32 path already sits 3e-3 of max |mu| from the JAX reference on some
    leaves) and, against the one-process port on the same draws, within
    1e-3 relative L2; the parameters per element within atol 1e-3 / rtol
    5e-3 of JAX's, with Adam's sign flips bounded as ``_hold_flips`` says."""
    _, _, dit_want, dit_got, _ = runs
    _gate_metrics(dit_got["metrics"], dit_want["metrics"])
    total = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in dit_want["mu"].values()))
    for k, v in dit_got["mu"].items():
        assert _rel_l2(v, dit_want["mu"][k], total) <= 5e-2, k
        assert _rel_l2(v, dit_want["one_process_mu"][k], total) <= 1e-3, k
    lr = DIT_TRAIN["learning_rate"]
    for k, v in dit_got["params"].items():
        want = dit_want["params"][k]
        if k in dit_got["mu"]:
            _hold_flips(k, v, want, dit_got["mu"][k], dit_want["mu"][k], lr)
        else:
            np.testing.assert_allclose(v, want, atol=1e-3, rtol=5e-3, err_msg=k)
