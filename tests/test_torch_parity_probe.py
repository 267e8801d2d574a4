"""``vtp_tpu_torch.tools.parity_probe`` on the CPU at a tiny size (depth 2,
width 64): its report has the JAX tool's keys, key for key (read from
``tools/parity_probe.py``'s ``probe_preset`` without running it); both arms
run the plain versions here, so every delta is 0 and ``main`` exits 0; an
arm perturbed past a gate makes it print ``PARITY PROBE FAILED`` and exit
1; and ``plain_kernels()`` restores every kernel entry point, also when its
body raises."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from vtp_tpu_torch import VTPConfig
from vtp_tpu_torch.ops import dispatch
from vtp_tpu_torch.ops import flash_attention as fa
from vtp_tpu_torch.ops import fused_ce
from vtp_tpu_torch.tools import parity_probe

torch.set_num_threads(1)
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
            text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
TINY_TRAIN = dict(parity_probe.TRAIN_KW, dino_out_dim=256, dino_hidden_dim=32,
                  dino_bottleneck_dim=16)
JAX_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "parity_probe.py")


def _jax_report_keys():
    """The top-level keys of the JAX tool's report and of its deltas, read
    from the source of its ``probe_preset``."""
    tree = ast.parse(open(JAX_TOOL).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "probe_preset")
    keys, names, deltas = set(), set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "report" and isinstance(node.value, ast.Dict):
            keys.update(k.value for k in node.value.keys)
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) \
                and node.value.id == "report" and isinstance(node.slice, ast.Constant) \
                and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and isinstance(node.value, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "max_abs" for k in node.value.keys):
            deltas.update(k.value for k in node.value.keys)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple) and any(
                isinstance(e, ast.Constant) and e.value == "decode" for e in node.iter.elts):
            names = {e.value for e in node.iter.elts}
    return keys, names, deltas


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``main`` on the tiny preset, as is and with its kernel arm perturbed."""
    mp = pytest.MonkeyPatch()
    mp.setitem(parity_probe.PRESETS, "tiny", lambda: VTPConfig(**TINY))
    mp.setattr(parity_probe, "TRAIN_KW", TINY_TRAIN)
    root = tmp_path_factory.mktemp("probe")
    try:
        ok_json = str(root / "ok.json")
        rc_ok = parity_probe.main(["--preset", "tiny", "--device", "cpu", "--small",
                                   "--json", ok_json])
        real = parity_probe.run_arm

        def perturbed(plain, **kw):
            out = real(plain, **kw)
            if not plain:  # a kernel arm whose latents and grad norm drifted
                out["latents"] = out["latents"] + 0.5 * np.abs(out["latents"]).max()
                out["grad_norm"] *= 1.1
            return out

        mp.setattr(parity_probe, "run_arm", perturbed)
        bad_json = str(root / "bad.json")
        rc_bad = parity_probe.main(["--preset", "tiny", "--device", "cpu", "--small",
                                    "--json", bad_json])
    finally:
        mp.undo()
    with open(ok_json) as f, open(bad_json) as g:
        return rc_ok, json.load(f), rc_bad, json.load(g)


def test_report_has_the_jax_keys_and_zero_deltas_on_cpu(tiny, capsys):
    rc, report, _, _ = tiny
    keys, names, deltas = _jax_report_keys()
    assert set(report) == keys
    assert set(report["deltas"]) == names == set(parity_probe.DELTAS)
    for name, d in report["deltas"].items():
        assert set(d) == deltas
        assert d == {"max_abs": 0.0, "max_rel": 0.0}, name
    assert report["backend"] == "cpu" and report["batch"] == 2 and report["preset"] == "tiny"
    assert set(report["losses_kernel"]) == {"loss/clip", "loss/rec", "loss/dino", "loss/ibot",
                                            "loss/koleo", "loss/total"}
    assert report["losses_kernel"] == report["losses_fallback"]
    assert all(v == 0.0 for v in report["loss_rel"].values())
    assert report["grad_norm_rel"] == 0.0 and np.isfinite(report["grad_norm_kernel"])
    assert report["fails"] == [] and rc == 0


def test_perturbed_arm_fails_the_gates(tiny, capsys):
    _, _, rc, report = tiny
    assert rc == 1
    assert report["fails"] == ["tiny: latents bf16 rel > 5e-2",
                               "tiny: grad_norm rel 1.00e-01 > 2e-2"]
    assert abs(report["deltas"]["latents"]["max_rel"] - 0.5) < 1e-6


def test_failed_gate_prints_the_jax_marker(capsys):
    report = {"fails": ["x: decode rel > 1.5e-2"]}
    assert parity_probe.finish([report], "cpu") == 1
    assert "PARITY PROBE FAILED: x: decode rel > 1.5e-2" in capsys.readouterr().out


def test_plain_kernels_restores_every_entry_point_on_error():
    names = [(fa, "_forward"), (fa, "fused_qkv_rope_attention_bwd"),
             (fa, "fused_qkv_rope_attention_qk_norm_bwd"), (fa, "_flash_bnhd_forward"),
             (fa, "_flash_forward"), (fused_ce, "fused_ce_fwd"), (fused_ce, "fused_ce_bwd")]
    before = [getattr(m, n) for m, n in names]
    with pytest.raises(RuntimeError, match="inside"):
        with dispatch.plain_kernels():
            inside = [getattr(m, n) for m, n in names]
            raise RuntimeError("inside")
    assert all(a is not b for a, b in zip(before, inside))
    assert inside[0] is fa.fused_qkv_rope_attention_reference
    assert inside[-1] is fused_ce.fused_ce_bwd_reference
    assert [getattr(m, n) for m, n in names] == before
