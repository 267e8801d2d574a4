"""The port's VTP train step under context and pipeline parallelism on four
CPU gloo ranks, against the port's one-process step and the JAX package's
mesh steps on four of its virtual CPU devices, from the same state and
global batch; and the encode and decode of a model whose trunk and decoder
split their tokens over a seq axis.

The configuration is ``tests/test_cp_train.py``'s (CLIP + reconstruction,
fp32, remat off, depth 2 everywhere, 2 heads), at a global batch of 8 and
the learning rate of the port's parallel step tests (1e-3, where
``test_cp_train`` takes 1e-2): Adam moves an element whose gradient lies
within a few eps of 0 by a share of the rate that the gradient's last bits
set, and the two packages sum in other orders, so at 1e-2 such elements (3
of the 49152 patch-embedding weights) miss atol 1e-3 with their moments'
signs equal. Arms (name, mesh, arm):

  * ``cp_ring_2x2``: ``make_cp_mesh(2, 2)``, mode "ring";
  * ``cp_ulysses_2x2``: the same mesh, mode "auto" (2 heads divide the seq
    axis: Ulysses);
  * ``cp_tp_1x2x2``: ``make_cp_mesh(2, 1, 2)``, CP x TP (a rank's one head
    does not divide the axis: the ring);
  * ``pp_2x2``, ``pp_2x2_remat``: ``make_pp_mesh(2, 2)``, remat off and
    "full".

The CP arms pad N = 5 to 6 (the port pads to the seq axis) where JAX pads
to its tile (8, ``force_token_pad``); both mask the padding as keys.

Gates: against the port's one-process step, losses within 1e-5 rel and the
grad norm within 1e-4 rel (JAX's own for its mesh against its one-device
step); against JAX's mesh step (CP: ``make_cp_mesh(2, 2)``, CP x TP:
``make_cp_mesh(2, 1, 2)``, PP: ``make_pp_mesh(2, 2)``), losses within 5e-3
rel, the grad norm within 2e-2 rel, each leaf's first moment within 1e-3
of its max |mu| and every parameter within atol 1e-3 / rtol 5e-3 but for
Adam's sign flips (``_hold_flips``), the parallel step tests' gates (the
RoPE periods' moments aside: JAX's split path trains them, the port keeps
them as buffers). The encode: features within 2e-5 of the one-process port
(JAX's gate for its CP encode) and 5e-4 of JAX's; latents and the exact
decode within 2e-5 of the one-process port, with no fused attention call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel_step import _hold_flips
from tests.torch_dist import start_ranks
from tests.torch_parallel_workers import vtp_cp_pp_arms
from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models.vit import vit_forward_features
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.models.vtp_model import vit_config_from
from vtp_tpu.parallel.mesh import make_cp_mesh
from vtp_tpu.parallel.pipeline import make_pp_mesh
from vtp_tpu.train.step import TrainConfig as JaxTrainConfig
from vtp_tpu.train.step import build_train_step as jax_build_train_step
from vtp_tpu.train.step import init_state as jax_init_state
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.models.vtp_model import checkpoint_name
from vtp_tpu_torch.train.state import load_numpy_train_state
from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state

torch.set_num_threads(1)
CFG = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
           vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
           text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=2,
           decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
TRAIN = dict(train_ssl=False, dino_out_dim=64, learning_rate=1e-3, warmup_steps=0,
             total_steps=10, compute_dtype=None, remat=False)
ARMS = [("cp_ring_2x2", "cp", (2, 2), "ring", {}),
        ("cp_ulysses_2x2", "cp", (2, 2), "auto", {}),
        ("cp_tp_1x2x2", "cp", (2, 1, 2), "auto", {}),
        ("pp_2x2", "pp", (2, 2), "auto", {"pipeline_stages": 2}),
        ("pp_2x2_remat", "pp", (2, 2), "auto", {"pipeline_stages": 2, "remat": "full"})]
JAX_MESH = {"cp_ring_2x2": "cp", "cp_ulysses_2x2": "cp", "cp_tp_1x2x2": "cp_tp",
            "pp_2x2": "pp", "pp_2x2_remat": "pp"}
# the encode: head dim 32 (the fused gate's), N = 17 split over 4 ranks
ENC = dict(image_size=32, vision_patch_size=8, vision_embed_dim=64, vision_depth=2,
           vision_num_heads=2, vision_feature_bottleneck=16, decoder_embed_dim=64,
           decoder_depth=2, decoder_num_heads=2, train_clip=False)


def _batch():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    return {"image": images, "text": rng.integers(1, 127, (8, 8)), "rec_image": images}


def _numpy_tree(params, cfg):
    return {k: np.asarray(v, np.float32) for k, v in export_state_dict(params, cfg).items()}


def _jax_step(state0, batch, mesh):
    from vtp_tpu.ops import dispatch

    step = jax_build_train_step(JaxConfig(**CFG), JaxTrainConfig(**TRAIN))
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "text" else jnp.float32)
              for k, v in batch.items()}
    saved = dataclasses.asdict(dispatch.kernel_dispatch())
    dispatch.configure_kernels(force_token_pad=True)
    try:
        with jax.set_mesh(mesh):
            new, metrics = jax.jit(step)(state0, jbatch, jax.random.key(3))
    finally:
        dispatch.configure_kernels(**saved)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "student": _numpy_tree(new["params"], JaxConfig(**CFG)),
            "mu": _numpy_tree(new["opt_state"][1][0].mu, JaxConfig(**CFG))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = JaxConfig(**CFG)
    state0 = jax_init_state(jax.random.key(0), jcfg, JaxTrainConfig(**TRAIN))
    params = _numpy_tree(state0["params"], jcfg)
    batch = _batch()
    jenc = JaxConfig(**ENC)
    jm = JaxModel.init(jax.random.key(5), jenc)
    enc_sd = {k: np.asarray(v, np.float32) for k, v in export_state_dict(jm.params, jenc).items()}
    images = np.random.default_rng(2).standard_normal((2, 3, 32, 32)).astype(np.float32)
    # the ranks run while this process computes the references
    join = start_ranks(vtp_cp_pp_arms, 4, tmp_path_factory.mktemp("cp_pp"), CFG, TRAIN, ARMS,
                       params, batch, (ENC, enc_sd, images))
    devices = jax.devices()[:4]
    jax_runs = {"cp": _jax_step(state0, batch, make_cp_mesh(2, 2, devices=devices)),
                "cp_tp": _jax_step(state0, batch, make_cp_mesh(2, 1, 2, devices=devices)),
                "pp": _jax_step(state0, batch, make_pp_mesh(2, 2, devices=devices))}

    cfg, tcfg = VTPConfig(**CFG), TrainConfig(**TRAIN)
    state = init_state(cfg, tcfg, device="cpu")
    load_numpy_train_state(state, params)
    tb = {k: torch.from_numpy(v).long() if k == "text" else torch.from_numpy(v)
          for k, v in batch.items()}
    _, metrics = build_train_step(cfg, tcfg)(state, tb)
    one = {k: float(v) for k, v in metrics.items()}

    jfeat = vit_forward_features(jm.params["trunk"], vit_config_from(jenc), jnp.asarray(images),
                                 use_bottleneck=False)
    ref = VTPModel(VTPConfig(**ENC), device="cpu", encode_dtype=None)
    ref.load_numpy_state_dict(enc_sd)
    with torch.no_grad():
        x = torch.from_numpy(images)
        feats = ref.trunk.forward_features(x, use_bottleneck=False)
        lat = ref.get_reconstruction_latents(x)
        enc_want = {"x_norm_clstoken": feats["x_norm_clstoken"].numpy(),
                    "x_norm_patchtokens": feats["x_norm_patchtokens"].numpy(),
                    "latents": lat.numpy(), "images": ref.get_latents_decoded_images(lat).numpy()}
    enc_jax = {k: np.asarray(jfeat[k]) for k in ("x_norm_clstoken", "x_norm_patchtokens")}

    return dict(jax=jax_runs, one=one, got=join(), enc_want=enc_want, enc_jax=enc_jax)


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_step_matches_the_one_process_step(runs, arm):
    for rank in runs["got"]:
        metrics = rank[arm]["metrics"]
        assert set(metrics) == set(runs["one"])
        for name, want in runs["one"].items():
            limit = 1e-4 if name == "grad_norm" else 1e-5
            assert _rel(metrics[name], want) <= limit, (name, metrics[name], want)


@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_step_matches_jax_mesh_step(runs, arm):
    want = runs["jax"][JAX_MESH[arm]]
    for rank in runs["got"]:
        got = rank[arm]
        for name, w in want["metrics"].items():
            limit = 2e-2 if name == "grad_norm" else 5e-3
            assert _rel(got["metrics"][name], w) <= limit, (name, got["metrics"][name], w)
        student = {checkpoint_name(k): v for k, v in got["student"].items()}
        mu = {checkpoint_name(k): v for k, v in got["mu"].items()}
        assert set(mu) == set(want["mu"]) and set(student) >= set(want["student"])
        for k, w in want["mu"].items():
            if k.endswith("rope_embed.periods"):
                # the split path trains the periods in JAX; the port's are
                # buffers under a zero gradient (ROADMAP, Queue 3's facts)
                continue
            assert np.abs(mu[k] - w).max() <= 1e-3 * np.abs(w).max(), k
        for k, w in want["student"].items():
            if k in mu:
                _hold_flips(k, student[k], w, mu[k], want["mu"][k], TRAIN["learning_rate"])
            else:
                np.testing.assert_allclose(student[k], w, atol=1e-3, rtol=5e-3, err_msg=k)


def test_arms_take_their_collectives(runs):
    """The ring arms shift K/V (``ppermute``), Ulysses all-to-alls, every CP
    arm splits and gathers its crops' tokens, the PP arms shift
    activations; none of the others' collectives."""
    calls = runs["got"][0]
    for arm in ("cp_ring_2x2", "cp_tp_1x2x2"):
        got = calls[arm]["calls"]
        assert got.get("ppermute", 0) > 0 and "all_to_all" not in got
    assert calls["cp_ulysses_2x2"]["calls"].get("all_to_all", 0) > 0
    assert "ppermute" not in calls["cp_ulysses_2x2"]["calls"]
    for arm in ("cp_ring_2x2", "cp_ulysses_2x2", "cp_tp_1x2x2"):
        assert calls[arm]["calls"]["split_seq"] > 0 and calls[arm]["calls"]["unsplit_seq"] > 0
    for arm in ("pp_2x2", "pp_2x2_remat"):
        assert calls[arm]["calls"].get("ppermute", 0) > 0 and "split_seq" not in calls[arm]["calls"]


def test_encode_under_a_cp_model(runs):
    """The encode (features, latents) and the exact decode of a model whose
    trunk and decoder split their tokens over a (1, 4) seq axis (N = 17
    padded to 20; the decoder's 16), against the one-process port and JAX's
    features; no fused attention runs in a context-parallel stack."""
    for rank in runs["got"]:
        got = rank["encode"]
        assert got["fused_calls"] == 0
        for k, want in runs["enc_want"].items():
            np.testing.assert_allclose(got[k], want, atol=2e-5, rtol=0, err_msg=k)
        for k, want in runs["enc_jax"].items():
            np.testing.assert_allclose(got[k], want, atol=5e-4, rtol=0, err_msg=k)
