"""The attention route: the fused function where the JAX gate takes it, the
split path elsewhere.

``fused_attention_supported`` (``ops/flash_attention.py``) is the JAX
package's ``fused_attention_supported`` without its TPU-only VMEM budget,
sequence cap and mesh checks: bf16 or fp32, head dim 32, 64 or 128, the
packed width 3*H*d, 2 <= N and canonical columns. A VTP model at head dim
72 (the trunk, the decoder and a causal text tower) must never reach the
fused function, whose CUDA kernel takes 64 alone: here its entry is
patched to raise, the split path is counted, and the outputs are held to
the JAX package's model with the same weights (latents within 5e-2 of
max|ref|, images within 1e-3 abs, the roundtrip's gates; fp32 text
features within 5e-4 abs). At head dim 64 the same model takes the fused
function at every block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.ops.flash_attention import fused_attention_supported as jax_supported
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.models import blocks, text_encoder
from vtp_tpu_torch.ops.flash_attention import fused_attention_supported

torch.set_num_threads(1)

# head dim 72: two heads of 72 in the trunk, the decoder and the text tower
OFF_GATE = dict(image_size=64, vision_embed_dim=144, vision_depth=2, vision_num_heads=2,
                decoder_embed_dim=144, decoder_depth=2, decoder_num_heads=2,
                text_embed_dim=144, text_depth=1, text_num_heads=2, text_vocab_size=512,
                text_context_length=16)
# the same at head dim 64
ON_GATE = dict(OFF_GATE, vision_embed_dim=128, decoder_embed_dim=128, text_embed_dim=128)


# qkv shape, dtype, heads, head_major, expected
GATE_CASES = {
    "d64_bf16": ((2, 17, 3 * 2 * 64), "bfloat16", 2, 1, True),
    "d64_fp32": ((2, 17, 3 * 2 * 64), "float32", 2, 1, True),
    "d32": ((2, 17, 3 * 4 * 32), "bfloat16", 4, 1, True),
    "d128": ((2, 17, 3 * 2 * 128), "float32", 2, 1, True),
    "d72": ((2, 17, 3 * 2 * 72), "bfloat16", 2, 1, False),
    "d80": ((2, 17, 3 * 2 * 80), "float32", 2, 1, False),
    "n1": ((2, 1, 3 * 2 * 64), "bfloat16", 2, 1, False),
    "n2": ((2, 2, 3 * 2 * 64), "bfloat16", 2, 1, True),
    "head_major": ((2, 17, 3 * 2 * 64), "bfloat16", 2, 2, False),
    "width_not_3hd": ((2, 17, 3 * 2 * 64 + 3), "float32", 2, 1, False),
    "fp16": ((2, 17, 3 * 2 * 64), "float16", 2, 1, False),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_matches_the_jax_gate(case):
    shape, dtype, heads, head_major, expected = GATE_CASES[case]
    assert fused_attention_supported(shape, getattr(torch, dtype), heads, head_major) is expected
    assert jax_supported(shape, getattr(jnp, dtype), heads, head_major=head_major) is expected


def _pair(overrides):
    jc = JaxConfig(**overrides)
    jm = JaxModel.init(jax.random.key(0), jc)
    tm = VTPModel(VTPConfig(**overrides), device="cpu")
    tm.load_numpy_state_dict(export_state_dict(jm.params, jc))
    return jc, jm, tm


@pytest.fixture(scope="module")
def off_gate():
    return _pair(OFF_GATE)


@pytest.fixture
def routes(monkeypatch):
    """Counts the split path and the fused function by module; with
    ``fused_raises``, the fused function raises instead."""
    seen = {"split": 0, "fused": 0}
    fused_raises = []
    split = blocks.Attention.split_attention

    def count_split(self, *args, **kwargs):
        seen["split"] += 1
        return split(self, *args, **kwargs)

    def fused_for(module):
        real = module.fused_qkv_rope_attention

        def fused(*args, **kwargs):
            if fused_raises:
                raise AssertionError("the fused attention was called off its gate")
            seen["fused"] += 1
            return real(*args, **kwargs)
        return fused

    monkeypatch.setattr(blocks.Attention, "split_attention", count_split)
    for module in (blocks, text_encoder):
        monkeypatch.setattr(module, "fused_qkv_rope_attention", fused_for(module))
    return seen, fused_raises


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)


def test_head_dim_72_roundtrip_takes_the_split_path_and_matches_jax(off_gate, images, routes):
    jc, jm, tm = off_gate
    seen, fused_raises = routes
    fused_raises.append(True)
    j_lat = jm.get_reconstruction_latents(jnp.asarray(images))
    t_lat = tm.get_reconstruction_latents(torch.tensor(images))
    assert seen == {"split": jc.vision_depth, "fused": 0}
    lat = np.asarray(jnp.asarray(j_lat).astype(jnp.float32))
    assert t_lat.shape == lat.shape
    assert np.abs(t_lat.float().numpy() - lat).max() <= 5e-2 * np.abs(lat).max()
    # the exact decode of the same latents in both
    want = np.asarray(jm.get_latents_decoded_images(jnp.asarray(lat)))
    rec = tm.get_latents_decoded_images(torch.tensor(lat))
    assert seen == {"split": jc.vision_depth + jc.decoder_depth, "fused": 0}
    assert rec.dtype == torch.float32 and rec.shape == want.shape
    assert np.abs(rec.numpy() - want).max() <= 1e-3


def test_head_dim_72_causal_text_takes_the_plain_path_and_matches_jax(off_gate, routes):
    jc, jm, tm = off_gate
    seen, fused_raises = routes
    fused_raises.append(True)
    text = np.random.default_rng(1).integers(1, 500, (2, 16))
    want = JaxModel(jc, jm.params, encode_dtype=None).get_clip_text_feature(jnp.asarray(text))
    got = tm.get_clip_text_feature(torch.tensor(text), compute_dtype=None)
    assert seen["fused"] == 0
    assert got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 5e-4


def test_head_dim_64_takes_the_fused_function_at_every_block(images, routes):
    jc, _, tm = _pair(ON_GATE)
    seen, _ = routes
    lat = tm.get_reconstruction_latents(torch.tensor(images))
    tm.get_latents_decoded_images(lat.float())
    tm.get_clip_text_feature(torch.tensor(np.random.default_rng(1).integers(1, 500, (2, 16))))
    assert seen == {"split": 0, "fused": jc.vision_depth + jc.decoder_depth + jc.text_depth}
