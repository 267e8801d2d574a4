"""Tensor and sequence parallelism of the port's towers on four CPU gloo
ranks, against the one-process port and the JAX package on the same
weights (carried across by ``vtp_tpu.convert.to_torch.export_state_dict``).

One spawn of four ranks runs every case: meshes (2, 2) (tp = 2) and (1, 4)
(tp = 4), sequence parallelism off and on, fp32 and bf16. Checked: the
encode (trunk + bottleneck), the exact decode (pixel decoder) and the text
features against the one-process port and JAX, fp32 within 5e-4 abs and
bf16 within 5e-2 of max |ref|; and the collectives one block's attention
issues, counted at the process-group calls: the fused attention call
issues none, the module one all-reduce (the out-projection's) under TP,
and under SP the all-gather of its rows and the out-projection's
reduce-scatter (the JAX counterpart: ``tests/test_tp_head_major.py``'s
``test_no_collectives_in_fused_tp_forward``).
"""

import jax
import numpy as np
import pytest
import torch

from tests.torch_dist import run_ranks
from tests.torch_parallel_workers import tp_forwards
from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu_torch import VTPConfig, VTPModel

torch.set_num_threads(1)
CFG = dict(image_size=32, vision_patch_size=16, vision_embed_dim=128, vision_depth=2,
           vision_num_heads=4, vision_feature_bottleneck=16, text_context_length=8,
           text_vocab_size=128, text_embed_dim=128, text_num_heads=4, text_depth=2,
           decoder_embed_dim=128, decoder_num_heads=4, decoder_depth=2)
MESHES = [(2, 2), (1, 4)]
CASES = [(shape, sp, dt) for shape in MESHES for sp in (False, True) for dt in ("fp32", "bf16")]


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            rng.integers(1, 127, (4, 8)).astype(np.int64),
            rng.standard_normal((4, 16, 2, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = JaxConfig(**CFG)
    jmodel = JaxModel.init(jax.random.key(0), jcfg, encode_dtype=None)
    sd = {k: np.asarray(v) for k, v in export_state_dict(jmodel.params, jcfg).items()}
    images, text, latents = _inputs()
    ranks = run_ranks(tp_forwards, 4, tmp_path_factory.mktemp("tp"), CFG, sd, images, text,
                      latents, MESHES)
    # the one-process port and JAX on the same weights
    model = VTPModel(VTPConfig(**CFG), device="cpu")
    model.load_numpy_state_dict(sd)
    ref = {}
    for dt, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        model.encode_dtype = dtype
        with torch.no_grad():
            ref[dt] = {"latents": model.get_reconstruction_latents(torch.tensor(images)).float(),
                       "decoded": model.get_latents_decoded_images(torch.tensor(latents)),
                       "text": model.get_clip_text_feature(torch.tensor(text), normalize=False,
                                                           compute_dtype=dtype).float()}
    jax_ref = {"latents": np.asarray(jmodel.get_reconstruction_latents(images), np.float32),
               "decoded": np.asarray(jmodel.get_latents_decoded_images(latents), np.float32),
               "text": np.asarray(jmodel.get_clip_text_feature(text, normalize=False),
                                  np.float32)}
    return ranks, {k: {n: v.numpy() for n, v in d.items()} for k, d in ref.items()}, jax_ref


def _close(got, want, dt):
    if dt == "fp32":
        return np.abs(got - want).max() <= 5e-4
    return np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("case", CASES, ids=[f"{s[0]}x{s[1]}-{'sp' if sp else 'tp'}-{dt}"
                                             for s, sp, dt in CASES])
@pytest.mark.parametrize("output", ["latents", "decoded", "text"])
def test_tp_forward_matches_one_process_and_jax(runs, case, output):
    ranks, ref, jax_ref = runs
    got = ranks[0][case][output]
    dt = case[2]
    assert got.shape == ref[dt][output].shape
    assert _close(got, ref[dt][output], dt)
    if dt == "fp32":
        assert _close(got, jax_ref[output], dt)
    # every rank holds the same replicated result
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks[r][case][output], got)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_attention_collectives(runs, shape, sp):
    ranks, _, _ = runs
    for r in range(4):
        fused = ranks[r][(shape, sp, "fused_collectives")]
        assert fused.pop("launches") == 1 and not fused
        calls = ranks[r][(shape, sp, "attn_collectives")]
        if sp:
            assert calls == {"all_gather_single": 1, "reduce_scatter_single": 1}
            # copy_to_model: the out-projection's bias on this rank's rows,
            # whose gradient sums over the group (no forward communication)
            assert ranks[r][(shape, sp, "attn_calls")] == {"gather_seq": 1,
                                                          "reduce_scatter_seq": 1,
                                                          "copy_to_model": 1}
        else:
            assert calls == {"all_reduce": 1}
            assert ranks[r][(shape, sp, "attn_calls")] == {"copy_to_model": 1,
                                                          "reduce_from_model": 1}
