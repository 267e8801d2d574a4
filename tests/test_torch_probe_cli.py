"""The port's linear-probing CLI and release validation on the CPU:
``python -m vtp_tpu_torch.tools.eval_linear_probing`` (``--device cpu``,
one epoch of two steps) writes ``linear_probing_results.json`` in the JAX
CLI's layout, and ``python -m vtp_tpu_torch.tools.validate_release`` runs
the port's three eval CLIs as subprocesses on a tiny checkpoint and a
small ImageNet-like folder, with ``$VTP_BPE_PATH`` on a synthetic merges
file and seeded Inception and LPIPS weight files: every sub-tool runs,
``validate_release.json`` has the JAX tool's layout, and the random
weights fail the published numbers, so it exits 1."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.convert import save_hf_checkpoint
from vtp_tpu_torch.eval import linear_probe as lp
from vtp_tpu_torch.eval import zero_shot as zs
from vtp_tpu_torch.metrics import inception, lpips
from vtp_tpu_torch.tokenizers import bpe

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The probe reads the last four layers: depth 4
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=4,
            vision_num_heads=1, vision_feature_bottleneck=16, decoder_embed_dim=64,
            decoder_depth=1, decoder_num_heads=1, text_embed_dim=64, text_depth=1,
            text_num_heads=1, text_vocab_size=4096, text_context_length=16)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A tiny HF checkpoint, train/ and val/ folders of two classes, a
    synthetic merges file and seeded Inception and LPIPS weight files."""
    root = tmp_path_factory.mktemp("release")
    model = VTPModel.init(VTPConfig(**TINY), torch.Generator().manual_seed(0), device="cpu")
    save_hf_checkpoint(str(root / "ckpt"), model)
    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("val", 3)):
        for cls in ("n01440764", "n01443537"):
            d = root / "imagenet" / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(d / f"{i}.png")
    texts = [t.format(c) for c in zs.load_imagenet_classnames()[:40]
             for t in zs.load_openai_templates()[:3]]
    bpe.write_merges_file(str(root / "merges.txt.gz"), texts)
    torch.save({k: torch.from_numpy(v) for k, v in inception.random_state_dict(1).items()},
               root / "inception.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lpips.random_state_dict(2).items()},
               root / "lpips.pth")
    return root


def test_eval_linear_probing_cli_writes_the_results(release, capsys):
    from vtp_tpu_torch.tools import eval_linear_probing

    out = release / "probe"
    res = eval_linear_probing.main([
        "--model_path", str(release / "ckpt"), "--imagenet_root", str(release / "imagenet"),
        "--output_dir", str(out), "--batch_size", "2", "--epochs", "1", "--epoch_length", "2",
        "--num_workers", "2", "--crop_size", "32", "--device", "cpu"])
    with open(out / "linear_probing_results.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(res))
    assert sorted(saved) == ["all_accuracies", "best_accuracy", "best_classifier"]
    # 26 heads; at batch 2 the names' five decimals merge the smallest rates'
    names = lp.head_names(lp.ProbeConfig(batch_size=2), 2)
    assert sorted(saved["all_accuracies"]) == sorted(names)
    assert all(0.0 <= a <= 100.0 for a in saved["all_accuracies"].values())
    assert saved["best_accuracy"] == max([0.0, *saved["all_accuracies"].values()])
    assert '"best_accuracy"' in capsys.readouterr().out


def test_validate_release_runs_the_three_tools_and_fails_random_weights(release, tmp_path):
    work = tmp_path / "work"
    env = dict(os.environ, VTP_BPE_PATH=str(release / "merges.txt.gz"),
               VTP_CACHE_DIR=str(tmp_path / "cache"),
               VTP_INCEPTION_WEIGHTS=str(release / "inception.pth"),
               VTP_LPIPS_WEIGHTS=str(release / "lpips.pth"), OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH")))))
    proc = subprocess.run(
        [sys.executable, "-m", "vtp_tpu_torch.tools.validate_release",
         "--model_path", str(release / "ckpt"), "--imagenet_root", str(release / "imagenet"),
         "--work_dir", str(work), "--expected", "vtp-small", "--max_samples", "4",
         "--batch_size", "2", "--probe_epochs", "1", "--probe_epoch_length", "2",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env, timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    for tool in ("eval_reconstruction", "eval_zero_shot", "eval_linear_probing"):
        assert f"-m vtp_tpu_torch.tools.{tool}" in proc.stdout, out
    with open(work / "validate_release.json") as f:
        results = json.load(f)
    assert results["model"] == "vtp-small" and results["passed"] is False
    for metric, raw in (("rfid", "reconstruction_raw"), ("zero_shot_top1", "zero_shot_raw"),
                        ("linear_probe_top1", "linear_probe_raw")):
        assert sorted(results[metric]) == ["got", "ok", "published", "tol"], results
        assert results[metric]["ok"] is False and raw in results
    assert results["reconstruction_raw"]["num_samples"] == 4
    assert "lpips" in results["reconstruction_raw"]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["passed"] is False
    assert sorted(summary["failures"]) == ["linear_probe_top1", "rfid", "zero_shot_top1"]
