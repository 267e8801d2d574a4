"""The port's VTP training CLI (``vtp_tpu_torch.tools.train_vtp``) on the
CPU at a tiny config: on a seeded ImageFolder it trains (CLIP + SSL + rec,
2 microbatches a step), checkpoints, resumes, and exports an HF-layout
directory that the port's and the JAX package's loaders both read; a
resumed synthetic run equals an uninterrupted one bit for bit; the
synthetic stream and the pseudo-captions are the JAX CLI's
(``tools/train_vtp.py``)."""

import argparse
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vtp_tpu.convert.from_torch import load_vtp_checkpoint
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu_torch import VTPModel
from vtp_tpu_torch.checkpoint import (
    latest_train_state_step,
    restore_train_state,
    train_state_tensors,
)
from tests.torch_dist import run_ranks
from tests.torch_parallel_workers import train_vtp_ranks
from vtp_tpu_torch.tools import train_vtp
from vtp_tpu_torch.train.step import TrainConfig, init_state

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
            text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
CUT = ["--local_crops", "2", "--local_size", "16", "--dino_out_dim", "256",
       "--dino_hidden_dim", "32", "--dino_bottleneck_dim", "16", "--device", "cpu",
       "--log_every", "1", "--warmup_steps", "2"]


@pytest.fixture(scope="module")
def config_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "config.json"
    path.write_text(json.dumps(TINY))
    return str(path)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("vtp_imgs")
    rng = np.random.default_rng(0)
    for cls in ("cat", "dog"):
        (root / cls).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
                root / cls / f"{i}.png")
    return str(root)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_train_vtp_cli",
                                                  os.path.join(REPO, "tools", "train_vtp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_folder_run_trains_resumes_and_exports(config_json, image_dir, tmp_path):
    out = str(tmp_path / "run")
    argv = ["--data_dir", image_dir, "--config", config_json, "--batch_size", "4",
            "--accum_steps", "2", "--num_workers", "2", "--ckpt_every", "2", "--export_hf",
            "--compute_dtype", "fp32", "--out", out] + CUT
    first = train_vtp.main(argv + ["--steps", "2"])
    assert latest_train_state_step(out) == 2 and first["start_step"] == 0
    assert len(first["metrics"]) == 2
    assert all(np.isfinite(v) for m in first["metrics"] for v in m.values())
    assert json.load(open(os.path.join(out, "train_meta.json"))) == {"qkv_head_major": 1}

    # the export: the student without the DINO head, read by both packages
    export = os.path.join(out, "hf_export")
    model = first["state"].model
    loaded = VTPModel.from_checkpoint(export, device="cpu")
    images = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = model.get_reconstruction_latents(torch.tensor(images))
        got = loaded.get_reconstruction_latents(torch.tensor(images))
    assert torch.equal(got, want)
    assert not any(k.startswith("dino_head") for k in loaded.state_dict())
    jcfg, jparams = load_vtp_checkpoint(export)
    jlat = np.asarray(JaxModel(jcfg, jparams).get_reconstruction_latents(jnp.asarray(images)),
                      np.float32)
    assert np.abs(jlat - want.float().numpy()).max() <= 5e-2 * np.abs(jlat).max()

    resumed = train_vtp.main(argv + ["--steps", "3", "--resume"])
    assert resumed["start_step"] == 2 and len(resumed["metrics"]) == 1
    assert latest_train_state_step(out) == 3


def test_resumed_synthetic_run_equals_an_uninterrupted_one(config_json, tmp_path):
    argv = ["--synthetic", "--config", config_json, "--batch_size", "4", "--accum_steps", "2",
            "--moment_dtype", "bf16", "--remat", "attn"] + CUT
    ckpt, whole = str(tmp_path / "ckpt"), str(tmp_path / "whole")
    # the first run stops at step 4 of a 6-step schedule
    first = train_vtp.main(argv + ["--steps", "4", "--total_steps", "6", "--ckpt_every", "2",
                                   "--out", ckpt])
    assert latest_train_state_step(ckpt) == 4

    cfg = train_vtp.load_config(train_vtp.parse_args(argv))
    template = init_state(cfg, TrainConfig(dino_out_dim=256, dino_hidden_dim=32,
                                           dino_bottleneck_dim=16, moment_dtype="bf16"),
                          device="cpu")
    restore_train_state(ckpt, template, step=4)
    a, b = train_state_tensors(first["state"]), train_state_tensors(template)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert template.step == 4 and template.optimizer.count == 4

    resumed = train_vtp.main(argv + ["--steps", "6", "--resume", "--out", ckpt])
    straight = train_vtp.main(argv + ["--steps", "6", "--ckpt_every", "6", "--out", whole])
    assert resumed["start_step"] == 4
    assert resumed["metrics"] == straight["metrics"][4:]
    assert straight["metrics"][:4] == first["metrics"]
    a, b = train_state_tensors(resumed["state"]), train_state_tensors(straight["state"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_resume_refuses_another_layout(config_json, tmp_path):
    out = str(tmp_path / "hm")
    argv = ["--synthetic", "--config", config_json, "--batch_size", "2", "--out", out] + CUT
    train_vtp.main(argv + ["--steps", "1"])
    with open(os.path.join(out, "train_meta.json"), "w") as f:
        json.dump({"qkv_head_major": 2}, f)
    with pytest.raises(SystemExit, match="layout mismatch"):
        train_vtp.main(argv + ["--steps", "2", "--resume"])


PARALLEL_REFUSALS = [
    (["--mesh", "2,2"], r"mesh 2x2 != 1 ranks"),
    (["--context_parallel", "2"], r"--context_parallel 2 x data 0 x model 1 != 1 ranks"),
    (["--pipeline_parallel", "2"], r"--pipeline_parallel 2 x data 0 != 1 ranks"),
    (["--context_parallel", "2", "--mesh", "1,3"],
     r"needs vision_num_heads \(2\) % model \(3\) == 0"),
    (["--pipeline_parallel", "2", "--mesh", "1,2"], "composes with the data axis only"),
    (["--sequence_parallel"], "needs a model axis > 1"),
    (["--tp_head_major"], "needs a model axis > 1")]


@pytest.mark.parametrize("flag,match", PARALLEL_REFUSALS)
def test_parallel_flags_exit_not_ported(config_json, flag, match):
    """In one process each parallel layout is refused with the JAX CLI's
    message (``tools/train_vtp.py`` :272-315): ``--mesh 2,2``,
    ``--context_parallel 2`` and ``--pipeline_parallel 2`` are not the world
    size, CP x TP needs the trunk's heads to divide the model axis, the pipe
    axis composes with the data axis only, and ``--sequence_parallel`` and
    ``--tp_head_major`` alone need a model axis. The layouts run under
    torchrun (``test_cp_and_pp_runs_match_one_process`` here,
    tests/test_torch_parallel_serve.py)."""
    with pytest.raises(SystemExit, match=match):
        train_vtp.main(["--synthetic", "--steps", "1", "--config", config_json] + flag)


def test_cp_and_pp_runs_match_one_process(config_json, tmp_path):
    """``--context_parallel 2 --cp_mode ring`` and ``--pipeline_parallel 2``
    (a decoder 3 deep, which the note names and which runs its sequential
    loop) on two gloo ranks as under torchrun: each step's metrics within
    1e-5 rel (the grad norm 1e-4) of the one-process run's, in fp32."""
    cfg = dict(TINY, decoder_depth=3)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    argv = ["--synthetic", "--config", str(path), "--batch_size", "4", "--steps", "2",
            "--compute_dtype", "fp32", "--remat", "off"] + CUT
    want = train_vtp.main(argv + ["--out", str(tmp_path / "one")])["metrics"]
    ranks = run_ranks(train_vtp_ranks, 2, tmp_path, argv, str(tmp_path))
    for rank in ranks:
        assert rank["pp_stdout"].count("decoder depth 3 % pipe 2 != 0") == (rank["rank"] == 0)
        for arm in ("cp", "pp"):
            for got, ref in zip(rank[arm], want, strict=True):
                for k, w in ref.items():
                    limit = 1e-4 if k == "grad_norm" else 1e-5
                    assert abs(got[k] - w) <= limit * abs(w), (arm, k, got[k], w)


def test_synthetic_stream_and_captions_are_the_jax_clis(config_json):
    """Step s's synthetic batch is the JAX CLI's first batch when it starts
    at s; the pseudo-captions (no BPE vocab here) are the JAX CLI's."""
    jax_cli = _jax_cli()
    args = train_vtp.parse_args(["--synthetic", "--config", config_json, "--batch_size", "3",
                                 "--seed", "5", "--steps", "10"] + CUT)
    cfg = train_vtp.load_config(args)
    jargs = argparse.Namespace(**vars(args))
    for start in (0, 3):
        (got,) = next(train_vtp.synthetic_batches(args, cfg, 4, start_step=start))
        want = next(jax_cli.synthetic_batches(jargs, cfg, 4, start_step=start))
        for k in ("image", "text", "rec_image"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in want["ssl"]:
            np.testing.assert_array_equal(got["ssl"][k], want["ssl"][k])
    classes = ["tench", "goldfish", "great_white_shark"]
    np.testing.assert_array_equal(train_vtp.class_captions(classes, 8, 128),
                                  jax_cli._class_captions(classes, 8, 128))
