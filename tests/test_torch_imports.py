"""The PyTorch port imports nothing the GPU machine lacks, and carries
the same VTPConfig as the JAX package."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

import vtp_tpu.config as jax_config
import vtp_tpu_torch.config as torch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("jax", "jaxlib", "vtp_tpu", "PIL", "safetensors", "regex", "ftfy", "omegaconf")


def test_port_and_chip_smoke_import_with_jax_and_extras_refused():
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        REFUSED = {REFUSED!r}

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSED:
                    raise ImportError("refused import: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import vtp_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(vtp_tpu_torch.__path__, "vtp_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
        assert not leaked, leaked
        print(" ".join(sorted(names)))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    imported = set(res.stdout.split())
    for mod in ("vtp_tpu_torch.ops.flash_attention", "vtp_tpu_torch.models.vtp_model",
                "vtp_tpu_torch._build", "vtp_tpu_torch.config", "vtp_tpu_torch.ops.fused_ce",
                "vtp_tpu_torch.models.dino_head", "vtp_tpu_torch.models.text_encoder",
                "vtp_tpu_torch.train.losses", "vtp_tpu_torch.train.optim",
                "vtp_tpu_torch.train.state", "vtp_tpu_torch.train.step",
                "vtp_tpu_torch.dit", "vtp_tpu_torch.dit.model", "vtp_tpu_torch.dit.transport",
                "vtp_tpu_torch.dit.train", "vtp_tpu_torch.dit.sample",
                "vtp_tpu_torch.generation", "vtp_tpu_torch.generation.vtp_tokenizer",
                "vtp_tpu_torch.ops.precision", "vtp_tpu_torch.serve", "vtp_tpu_torch.convert",
                "vtp_tpu_torch.convert.from_torch", "vtp_tpu_torch.convert.to_torch",
                "vtp_tpu_torch.convert.safetensors_io", "vtp_tpu_torch.checkpoint",
                "vtp_tpu_torch.parallel", "vtp_tpu_torch.parallel.sharding",
                "vtp_tpu_torch.parallel.mesh", "vtp_tpu_torch.parallel.multihost",
                "vtp_tpu_torch.parallel.fsdp", "vtp_tpu_torch.tools.fsdp_plan",
                "vtp_tpu_torch.tools.parity_probe", "vtp_tpu_torch.ops.dispatch",
                "vtp_tpu_torch.ops.attention", "vtp_tpu_torch.utils.image",
                "vtp_tpu_torch.data", "vtp_tpu_torch.data.imagefolder", "vtp_tpu_torch.data.loader",
                "vtp_tpu_torch.metrics", "vtp_tpu_torch.metrics.psnr", "vtp_tpu_torch.metrics.ssim",
                "vtp_tpu_torch.metrics.fid", "vtp_tpu_torch.metrics.inception",
                "vtp_tpu_torch.metrics.lpips", "vtp_tpu_torch.eval",
                "vtp_tpu_torch.eval.reconstruction", "vtp_tpu_torch.eval.zero_shot",
                "vtp_tpu_torch.tokenizers", "vtp_tpu_torch.tokenizers.bpe",
                "vtp_tpu_torch.tools.compute_fid", "vtp_tpu_torch.tools.eval_reconstruction",
                "vtp_tpu_torch.tools.eval_zero_shot", "vtp_tpu_torch.eval.linear_probe",
                "vtp_tpu_torch.tools.eval_linear_probing", "vtp_tpu_torch.tools.validate_release",
                "vtp_tpu_torch.ops.pos_embed", "vtp_tpu_torch.models.extras",
                "vtp_tpu_torch.native", "vtp_tpu_torch.data.native_loader",
                "vtp_tpu_torch.generation.latents", "vtp_tpu_torch.tools.extract_latents",
                "vtp_tpu_torch.tools.train_dit", "vtp_tpu_torch.tools.sample_dit",
                "vtp_tpu_torch.data.ssl_crops", "vtp_tpu_torch.train.schedules",
                "vtp_tpu_torch.models.vtp_train_arch", "vtp_tpu_torch.tools.train_vtp",
                "vtp_tpu_torch.utils", "vtp_tpu_torch.utils.quantization",
                "vtp_tpu_torch.utils.params", "vtp_tpu_torch.utils.buckets",
                "vtp_tpu_torch.utils.misc", "vtp_tpu_torch.tools.bench_serve",
                "vtp_tpu_torch.ops.ring_attention", "vtp_tpu_torch.parallel.pipeline"):
        assert mod in imported


def test_chip_smoke_without_a_card_exits_nonzero_with_no_result():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _fields(mod):
    return [(f.name, str(f.type), f.default) for f in dataclasses.fields(mod.VTPConfig)]


def test_config_fields_identical():
    assert _fields(torch_config) == _fields(jax_config)


@pytest.mark.parametrize("preset", sorted(jax_config.PRESETS))
def test_config_presets_identical(preset):
    j = jax_config.PRESETS[preset]()
    t = torch_config.PRESETS[preset]()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("vision_head_dim", "decoder_head_dim", "latent_grid"):
        assert getattr(t, prop) == getattr(j, prop)
    assert sorted(torch_config.PRESETS) == sorted(jax_config.PRESETS)
