"""``vtp_tpu_torch.tools.bench_serve`` on the CPU: the CLI on a tiny preset
(``--seconds 1 --device cpu``, every request kind) prints one JSON line
whose keys, per-kind keys and transfer-floor keys are the JAX CLI's
(``tools/bench_serve.py``, read from its source: running it would bring up
the JAX server)."""

import ast
import json
import os

import pytest
import torch

from vtp_tpu_torch.config import PRESETS, VTPConfig
from vtp_tpu_torch.tools import bench_serve

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
            text_vocab_size=64, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)


def _jax_cli_dict_keys():
    """The string-keyed dict literals of the JAX CLI, by their first key."""
    with open(os.path.join(REPO, "tools", "bench_serve.py")) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str) for k in node.keys):
            keys = [k.value for k in node.keys]
            found[keys[0]] = keys
    return found


def test_bench_serve_cli_prints_the_jax_line(monkeypatch, capsys):
    monkeypatch.setitem(PRESETS, "tiny", lambda: VTPConfig(**TINY))
    result = bench_serve.main(["--preset", "tiny", "--seconds", "1", "--rows", "2",
                               "--batch_size", "4", "--device", "cpu",
                               "--clients", "encode,decode,clip_image,clip_text"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    want = _jax_cli_dict_keys()
    assert list(result) == want["metric"]
    assert list(result["host_device_transfer_floor"]) == want["mb_each_way"]
    assert set(result["kinds"]) == {"encode", "decode", "clip_image", "clip_text"}
    for stats in result["kinds"].values():
        assert list(stats) == want["requests"]
        assert stats["requests"] >= 1 and stats["p99_ms"] >= stats["p50_ms"] > 0
    assert result["value"] > 0 and result["unit"] == "rows/sec/chip"
    assert result["metric"].startswith("tiny VTPServer mixed-load")


def test_bench_serve_refuses_an_unknown_kind(monkeypatch):
    monkeypatch.setitem(PRESETS, "tiny", lambda: VTPConfig(**TINY))
    with pytest.raises(SystemExit):
        bench_serve.main(["--preset", "tiny", "--device", "cpu", "--clients", "encode,nope"])
