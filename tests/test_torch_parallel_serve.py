"""The port's mesh entry points on four CPU gloo ranks against one process:
``VTPServer(mesh=(2, 2), tp_head_major=True)`` (JAX counterpart:
``tests/test_tp_head_major.py``'s ``test_serve_tp_head_major`` on a (4, 2)
mesh), ``VTPTokenizer(data_sharding=)``, ``evaluate_reconstruction`` and
``evaluate_zero_shot`` with ``sharding=`` (batches of 3 rows, which the
data axis of 2 pads), ``tools/extract_latents.py`` as under torchrun (each
rank's ``latents_rank{r}_shard{s}`` file) and ``tools/train_vtp.py --mesh
2,2 --tp_head_major --sequence_parallel`` (two steps at depth 2; its rank-0
checkpoint, resumed, gives the uninterrupted run's state and metrics).

One spawn of four ranks runs them all. Tolerances: the served results
within 1e-4 abs of direct calls (fp32, as the JAX test), the tokenizer and
the reconstruction within 1e-5 rel (the same rows, split), the hit counts
and the resumed run exactly. A second spawn of two ranks breaks one rank's
encode: the batch fails on rank 0, the server stops there, and the broken
rank's ``shutdown()`` raises its error; before it, in the same spawn,
``VTPServer`` over a (1, 2) mesh serves a model with every tower in int8
(bit-equal to one process) and one with fused ``w12`` FFNs (fp32 within
1e-5), the counterparts of JAX's replicated ``{q, scale}`` and ``w12``."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_dist import run_ranks
from tests.torch_parallel_workers import (
    run_both,
    serve_and_data,
    serve_whole_weights,
    serve_worker_failure,
    whole_weight_model,
)
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.convert import save_hf_checkpoint
from vtp_tpu_torch.convert.safetensors_io import load_safetensors
from vtp_tpu_torch.data import ShardedSampler
from vtp_tpu_torch.eval.reconstruction import evaluate_reconstruction
from vtp_tpu_torch.eval.zero_shot import evaluate_zero_shot
from vtp_tpu_torch.generation import VTPTokenizer
from vtp_tpu_torch.generation.latents import compute_latent_stats, load_latent_stats, shard_name
from vtp_tpu_torch.tools import extract_latents

torch.set_num_threads(1)
CFG = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
           vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
           text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=2,
           decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    model = VTPModel.init(VTPConfig(**CFG), torch.Generator().manual_seed(0), device="cpu",
                          encode_dtype=None)
    from vtp_tpu_torch.convert.to_torch import export_state_dict

    sd = export_state_dict(model)
    ckpt = str(root / "ckpt")
    save_hf_checkpoint(ckpt, model)
    images_dir = root / "imgs"
    rng = np.random.default_rng(0)
    for cls in ("cat", "dog"):
        (images_dir / cls).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
                images_dir / cls / f"{i}.png")
    cli_config = root / "config.json"
    cli_config.write_text(json.dumps(CFG))
    images = rng.standard_normal((6, 3, 32, 32)).astype(np.float32)
    text = rng.integers(1, 127, (6, 8)).astype(np.int64)
    latents = rng.standard_normal((6, 16, 2, 2)).astype(np.float32)
    classifier = rng.standard_normal((64, 10)).astype(np.float32)
    targets = rng.integers(0, 10, (6,)).astype(np.int64)
    ranks = run_ranks(serve_and_data, 4, root, CFG, sd, images, text, latents, classifier,
                      targets, ckpt, str(images_dir), str(root / "extract4"), str(cli_config),
                      str(root / "cli"), timeout=400)

    # one process
    x = torch.tensor(images)
    with torch.no_grad():
        direct = {"encode": model.get_reconstruction_latents(x),
                  "decode": model.get_latents_decoded_images(torch.tensor(latents)),
                  "clip_image": model.get_clip_image_feature(x, True, None),
                  "clip_text": model.get_clip_text_feature(torch.tensor(text), True, None)}
    tok = VTPTokenizer(model, img_size=32)
    one = {"serve": {k: v.numpy() for k, v in direct.items()},
           "tok_encode": tok.encode_images(images).numpy(),
           "tok_decode": tok.decode_to_images(latents).numpy(),
           "recon": evaluate_reconstruction(model, [(x[:3], None), (x[3:], None)]),
           "zero_shot": evaluate_zero_shot(model, torch.tensor(classifier),
                                           [(x[:3], torch.tensor(targets[:3])),
                                            (x[3:], torch.tensor(targets[3:]))],
                                           compute_dtype=None)}
    extract_latents.main(["--model_path", ckpt, "--data_path", str(images_dir), "--output_dir",
                          str(root / "extract1"), "--image_size", "32", "--batch_size", "2",
                          "--num_workers", "0", "--device", "cpu"])
    return ranks, one, root


def _shard_dir(root, name):
    return os.path.join(root, name, "latents", "ckpt", "imgnet32_normimagenet")


@pytest.mark.parametrize("kind", ["encode", "decode", "clip_image", "clip_text"])
def test_head_major_server_matches_direct_calls(runs, kind):
    ranks, one, _ = runs
    assert all(r["serve_hm"] == 2 for r in ranks)
    got = ranks[0]["serve"][kind]
    assert got.shape == one["serve"][kind].shape
    np.testing.assert_allclose(got, one["serve"][kind], atol=1e-4, rtol=0)
    # 6 rows in batches of 4: two model calls a kind
    assert ranks[0]["serve_calls"][kind] == 2


@pytest.mark.parametrize("what", ["tok_encode", "tok_decode"])
def test_sharded_tokenizer_matches_one_process(runs, what):
    ranks, one, _ = runs
    for r in ranks:
        got = r[what].astype(np.float32)
        want = one[what].astype(np.float32)
        if what == "tok_decode":  # uint8: a rounding step apart at most
            assert np.abs(got - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sharded_evals_match_one_process(runs):
    ranks, one, _ = runs
    for r in ranks:
        assert r["recon"]["num_samples"] == one["recon"]["num_samples"] == 6
        for k in ("psnr", "ssim"):
            assert abs(r["recon"][k] - one["recon"][k]) <= 1e-5 * abs(one["recon"][k]), k
        assert r["zero_shot"] == one["zero_shot"]


def test_extract_latents_writes_each_ranks_shards(runs):
    _, _, root = runs
    single = load_safetensors(os.path.join(_shard_dir(root, "extract1"), shard_name(0, 0)))
    names = sorted(f for f in os.listdir(_shard_dir(root, "extract4"))
                   if f.startswith("latents_rank"))
    assert names == [shard_name(r, 0) for r in range(4)]
    for r in range(4):
        got = load_safetensors(os.path.join(_shard_dir(root, "extract4"), names[r]))
        idx = ShardedSampler(6, r, 4).indices()
        for key in ("latents", "latents_flip", "labels"):
            np.testing.assert_allclose(got[key], single[key][idx], rtol=1e-5, atol=1e-6)
    # rank 0 wrote the statistics after every rank's shards were on disk
    saved = load_latent_stats(_shard_dir(root, "extract4"))
    mean, std = compute_latent_stats(_shard_dir(root, "extract4"), save=False)
    np.testing.assert_array_equal(saved[0], mean)
    np.testing.assert_array_equal(saved[1], std)


def test_train_vtp_mesh_tp_head_major_sp_resumes(runs):
    ranks, _, root = runs
    cli = ranks[0]["cli"]
    assert cli["hm"] == 2 and cli["start"] == 1
    assert len(cli["straight"]) == 2 and all(np.isfinite(v) for m in cli["straight"]
                                            for v in m.values())
    assert cli["first"] == cli["straight"][:1]
    assert cli["resumed"] == cli["straight"][1:]
    # every rank logged the same global metrics
    assert all(r["cli"]["straight"] == cli["straight"] for r in ranks)
    step = "step_00000002"
    a = load_safetensors(os.path.join(root, "cli", "straight", step, "train_state.safetensors"))
    b = load_safetensors(os.path.join(root, "cli", "resumed", step, "train_state.safetensors"))
    assert set(a) == set(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    with open(os.path.join(root, "cli", "straight", "train_meta.json")) as f:
        assert json.load(f) == {"qkv_head_major": 2}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks: the int8 and fused-``w12`` servers over a (1,
    2) mesh (``serve_whole_weights``), then the broken worker
    (``serve_worker_failure``); and the same whole-weight models' direct
    calls in one process."""
    model = VTPModel.init(VTPConfig(**CFG), torch.Generator().manual_seed(0), device="cpu",
                          encode_dtype=None)
    from vtp_tpu_torch.convert.to_torch import export_state_dict

    sd = export_state_dict(model)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    text = rng.integers(1, 127, (4, 8)).astype(np.int64)
    latents = rng.standard_normal((4, 16, 2, 2)).astype(np.float32)
    ranks = run_ranks(run_both, 2, tmp_path_factory.mktemp("two"),
                      (serve_whole_weights, (CFG, sd, images, text, latents)),
                      (serve_worker_failure, (CFG, sd, images)), timeout=300)
    one = {}
    for kind in ("int8", "fused"):
        m = whole_weight_model(CFG, sd, kind)
        x = torch.tensor(images)
        with torch.no_grad():
            one[kind] = {"encode": m.get_reconstruction_latents(x),
                         "decode": m.get_latents_decoded_images(torch.tensor(latents)),
                         "clip_image": m.get_clip_image_feature(x, True, None),
                         "clip_text": m.get_clip_text_feature(torch.tensor(text), True, None)}
        one[kind] = {k: v.float().numpy() for k, v in one[kind].items()}
        one[f"{kind}_shapes"] = {n: tuple(t.shape) for n, t in m.state_dict().items()
                                 if n.endswith((".q", ".scale"))}
    return [r[0] for r in ranks], [r[1] for r in ranks], one


@pytest.mark.parametrize("kind", ["encode", "decode", "clip_image", "clip_text"])
def test_int8_server_over_model_axis_is_bit_equal(two_ranks, kind):
    """Every tower in int8 over a (1, 2) mesh: each int8 unit keeps its
    codes, scales and heads whole on both ranks and runs with no model
    collective (only the float token embedding is cut, and its sum adds
    zeros), so the server equals the one-process model bit for bit; the
    same model with ``tp_head_major`` stores its trunk qkv head-major and
    runs it whole on the split path, within 1e-4."""
    whole, _, one = two_ranks
    for r in whole:
        assert r["int8"]["tp_units"] == 0 and r["int8"]["units"] > 0
        assert r["int8"]["int8_shapes"] == one["int8_shapes"]
        assert r["int8"]["hm"] == 1 and r["int8_head_major"]["hm"] == 2
    assert "reduce_from_model" in whole[0]["int8"]["collectives"]  # the embedding
    got = whole[0]["int8"]["serve"][kind]
    np.testing.assert_array_equal(got, one["int8"][kind])
    np.testing.assert_allclose(whole[0]["int8_head_major"]["serve"][kind], one["int8"][kind],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["encode", "decode", "clip_image", "clip_text"])
def test_fused_w12_server_over_model_axis(two_ranks, kind):
    """The SwiGLU FFNs fused over a (1, 2) mesh: ``w12`` whole on both ranks
    (each takes its columns of the hidden), ``w3`` and the attention cut;
    fp32 within 1e-5 of the one-process model."""
    whole, _, one = two_ranks
    for r in whole:
        assert r["fused"]["tp_units"] == r["fused"]["units"] > 0
    got = whole[0]["fused"]["serve"][kind]
    assert got.shape == one["fused"][kind].shape
    np.testing.assert_allclose(got, one["fused"][kind], atol=1e-5, rtol=1e-5)
    assert whole[0]["fused"]["calls"][kind] == 1


def test_server_worker_failure_stops_every_rank(two_ranks):
    """A worker rank whose model raises ends its loop and re-raises from its
    ``shutdown()``; rank 0's futures for that batch fail (its all-gather
    loses the peer), it serves no more requests, and nothing hangs."""
    _, ranks, _ = two_ranks
    assert ranks[1]["raised"] == "rank 1 encode failed"
    assert ranks[0]["first"] is not None
    assert ranks[0]["later"] is not None and "shut down" in ranks[0]["later"]
