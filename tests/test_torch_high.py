"""The port's bf16x3 ("high") fp32 precision on the CPU.

- The split linear (``ops/precision.py``) against a float64 emulation of
  hi·hi + hi·lo + lo·hi, and against exact fp32 beside one bf16 pass, so
  that neither TF32 nor a single bf16 pass can pose as "high"; the route of
  its CUDA path (one bf16 GEMM with fp32 output over the split operands
  concatenated along K), with ``torch.mm`` stood in for.
- The plain version of the fused attention's bf16x3 arm against the JAX
  Pallas kernel ``_fused_kernel_call(..., fp32_precision="high")`` in
  interpret mode, held to the gates of the exact fp32 arm; and that the
  wrapper launches the arm's own entry point.
- The "high" decode against the JAX package's decode at
  ``precision="high"``. On the CPU XLA computes every fp32 GEMM exactly
  whatever the precision asked, so the JAX side is the exact fp32 decode
  and the gate is the fp32 one (5e-4 abs); the port's split GEMMs and
  attention sit ~1e-5 from it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.models.vtp_model import get_latents_decoded_images
from vtp_tpu.ops.flash_attention import _fused_kernel_call
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.ops import dispatch, precision
from vtp_tpu_torch.ops import flash_attention as fa
from vtp_tpu_torch.ops.ffn import linear
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
# fp32 sum-order noise of a K = 256 product: ~sqrt(K) * 2^-24 of the largest
# partial sums, about 1e-6 of max|ref|
SPLIT_REL = 1e-6


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round to bf16 (ml_dtypes, independent of torch), back in float64."""
    return np.asarray(x, dtype=jnp.bfloat16).astype(np.float64)


def _operands(seed=0, m=64, k=256, n=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32))


def _split64(x):
    hi = _bf16(x)
    return hi, _bf16(x.astype(np.float64) - hi)


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


# ------------------------------------------------------------- split linear


def test_split_linear_matches_a_float64_emulation_of_the_split():
    x, w = _operands()
    got = linear(torch.tensor(x), torch.tensor(w), precision="high")
    assert got.dtype == torch.float32
    (xh, xl), (wh, wl) = _split64(x), _split64(w)
    want = xh @ wh.T + xh @ wl.T + xl @ wh.T
    assert _rel(got.numpy(), want) <= SPLIT_REL


def test_split_linear_is_far_closer_to_exact_than_one_bf16_pass():
    """On a (64, 256)·(256, 64) product "high" is ~4e-6 of max|ref| from the
    exact product, one bf16 pass ~2e-3: at least 10x apart, so a TF32 or
    bf16 GEMM standing in for "high" fails here."""
    x, w = _operands(seed=1)
    exact = x.astype(np.float64) @ w.astype(np.float64).T
    high = _rel(linear(torch.tensor(x), torch.tensor(w), precision="high").numpy(), exact)
    one_pass = _rel(_bf16(x) @ _bf16(w).T, exact)
    assert high <= 2e-5 and 10 * high <= one_pass, (high, one_pass)


def test_split_linear_takes_batch_dims_and_a_bias():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((2, 5, 96)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((48, 96)).astype(np.float32))
    b = torch.tensor(rng.standard_normal(48).astype(np.float32))
    got = linear(x, w, b, precision="high")
    want = precision.matmul_high_reference(x, w.t()) + b
    assert got.shape == (2, 5, 48)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_split_linear_refuses_what_it_does_not_compute():
    x, w = (torch.tensor(a) for a in _operands())
    with pytest.raises(ValueError, match="compute_dtype"):
        linear(x, w, precision="high", compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        linear(x.bfloat16(), w.bfloat16(), precision="high")
    with pytest.raises(ValueError, match="precision"):
        linear(x, w, precision="tensorfloat32")


def test_cuda_path_is_one_bf16_gemm_with_fp32_output_over_the_concatenated_split(monkeypatch):
    calls = []

    def fake_mm(a, b, out_dtype=None):
        calls.append((a.dtype, b.dtype, tuple(a.shape), tuple(b.shape), out_dtype))
        return torch.tensor(a.double().numpy() @ b.double().numpy()).to(out_dtype)

    monkeypatch.setattr(precision, "on_kernel_device", lambda t: True)
    monkeypatch.setattr(torch, "mm", fake_mm)
    x, w = _operands(seed=3, m=10, k=64, n=32)
    got = precision.linear_high(torch.tensor(x).reshape(2, 5, 64), torch.tensor(w))
    monkeypatch.undo()
    assert calls == [(torch.bfloat16, torch.bfloat16, (10, 192), (192, 32), torch.float32)]
    assert got.shape == (2, 5, 32) and got.dtype == torch.float32
    (xh, xl), (wh, wl) = _split64(x), _split64(w)
    want = xh @ wh.T + xh @ wl.T + xl @ wh.T
    assert _rel(got.reshape(10, 32).numpy(), want) <= SPLIT_REL


# ------------------------------------------------ fused attention, bf16x3 arm

H, D_HEAD = 2, 64
# case: (rope grid with a 1-token prefix (0 = none), n_valid offset from N, causal, qk-norm)
CASES = {
    "plain": (0, 0, False, False),
    "n_valid": (0, 4, False, False),
    "causal": (0, 0, True, False),
    "qk_norm": (0, 0, False, True),
    "rope_prefix": (4, 0, False, False),
    "qk_norm_rope_n_valid": (4, 3, False, True),
}


def _attention_inputs(case, seed):
    rng = np.random.default_rng(seed)
    grid, nv_off, causal, qk = CASES[case]
    N = 17
    x = rng.standard_normal((2, N, 3 * H * D_HEAD)).astype(np.float32)
    t = {"qkv": torch.tensor(x), "sin": None, "cos": None, "q_scale": None, "k_scale": None,
         "n_valid": N - nv_off if nv_off else 0, "is_causal": causal}
    j = dict(t, qkv=jnp.asarray(x))
    if grid:
        sin, cos = pad_rope_prefix(*rope_sincos(rope_periods_init(D_HEAD), grid, grid), 1)
        t["sin"], t["cos"] = sin, cos
        j["sin"], j["cos"] = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (sin, cos))
    if qk:
        qs, ks = (rng.standard_normal(D_HEAD).astype(np.float32) * 0.1 + 1 for _ in range(2))
        t["q_scale"], t["k_scale"] = torch.tensor(qs), torch.tensor(ks)
        j["q_scale"], j["k_scale"] = jnp.asarray(qs), jnp.asarray(ks)
    return t, j


def _port(t, fp32_precision="high"):
    return fa.fused_qkv_rope_attention(t["qkv"], t["sin"], t["cos"], H, t["q_scale"], t["k_scale"],
                                       n_valid=t["n_valid"], is_causal=t["is_causal"],
                                       fp32_precision=fp32_precision)


@pytest.mark.parametrize("case", list(CASES))
def test_high_arm_plain_matches_pallas_kernel_interpret(case, kernels):
    """The exact arm's gates: 5e-4 abs, and 5e-2 of max|ref| with RoPE,
    which the Pallas kernel takes in fp32 rounded once
    (flash_attention.py:535-548) where the port rounds each product and the
    sum to bf16."""
    kernels(interpret=True)
    t, j = _attention_inputs(case, seed=4)
    got = _port(t)
    assert got.dtype == torch.float32 and got.shape == (2, 17, H * D_HEAD)
    want = np.asarray(_fused_kernel_call(j["qkv"], j["sin"], j["cos"], H, j["q_scale"],
                                         j["k_scale"], n_valid=j["n_valid"],
                                         is_causal=j["is_causal"], fp32_precision="high"))
    err, scale = np.abs(got.numpy() - want).max(), np.abs(want).max()
    if CASES[case][0]:
        assert err <= BF16_REL * scale, (err, scale)
    else:
        assert err <= F32_ABS, err


def test_high_arm_differs_from_the_exact_arm_by_the_split_only():
    t, _ = _attention_inputs("qk_norm", seed=5)
    high, exact = _port(t), _port(t, "float32")
    err = (high - exact).abs().max().item()
    assert 0 < err <= 1e-4 * exact.abs().max().item(), err


def test_bf16_calls_ignore_fp32_precision():
    t, _ = _attention_inputs("rope_prefix", seed=6)
    t["qkv"] = t["qkv"].bfloat16()
    assert torch.equal(_port(t), _port(t, "float32"))
    with pytest.raises(ValueError, match="precision"):
        _port(t, "tensorfloat32")


@pytest.mark.parametrize("dtype,fp32_precision,entry,name", [
    (torch.float32, "high", fa.HIGH_ENTRY, fa.HIGH_NAME),
    (torch.float32, "float32", "vtp_fused_qkv_rope_attention_f32", fa.ARM_NAME[torch.float32]),
    (torch.bfloat16, "high", "vtp_fused_qkv_rope_attention_bf16", fa.ARM_NAME[torch.bfloat16]),
])
def test_a_card_tensor_launches_its_arms_entry_or_raises(dtype, fp32_precision, entry, name,
                                                          monkeypatch):
    """The route a CUDA tensor takes, with the device and the library stood
    in for: the arm's own C entry point and launch count, and an error from
    the launch raised, never a fallback."""
    launched, rc = [], [0]

    def fake_kernel_fn(e, n_pointers=6):
        def fn(*args):
            launched.append(e)
            return rc[0]
        return fn

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fa, "on_kernel_device", lambda t: True)
    monkeypatch.setattr(fa, "_kernel_fn", fake_kernel_fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    t, _ = _attention_inputs("rope_prefix", seed=7)
    t["qkv"] = t["qkv"].to(dtype)
    dispatch.reset_launch_counts()
    _port(t, fp32_precision)
    assert launched == [entry] and dispatch.launch_counts() == {name: 1}
    rc[0] = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _port(t, fp32_precision)
    dispatch.reset_launch_counts()


# ---------------------------------------------------------------- the decode

TINY = dict(image_size=64, vision_embed_dim=128, vision_depth=1, vision_num_heads=2,
            decoder_embed_dim=128, decoder_depth=2, decoder_num_heads=2, train_clip=False)


@pytest.fixture(scope="module")
def decode_pair():
    jc = JaxConfig(**TINY)
    jm = JaxModel.init(jax.random.key(8), jc)
    sd = export_state_dict(jm.params, jc)
    lat = np.random.default_rng(9).standard_normal((2, 64, 4, 4)).astype(np.float32)
    return jc, jm, sd, lat


def _port_model(sd, **kw):
    model = VTPModel(VTPConfig(**TINY), device="cpu", **kw)
    model.load_numpy_state_dict(sd)
    return model


def test_high_decode_matches_jax(decode_pair):
    jc, jm, sd, lat = decode_pair
    fn = jax.jit(functools.partial(get_latents_decoded_images, cfg=jc, precision="high"))
    want = np.asarray(fn(jm.params, latents=jnp.asarray(lat)))
    model = _port_model(sd, decode_precision="high")
    got = model.get_latents_decoded_images(torch.tensor(lat))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 64, 64)
    assert np.abs(got.numpy() - want).max() <= F32_ABS
    # the split ran: the exact decode of the same model differs, by ~1e-5
    exact = model.get_latents_decoded_images(torch.tensor(lat), precision="float32")
    err = (got - exact).abs().max().item()
    assert 0 < err <= 1e-4 * exact.abs().max().item(), err


def test_bf16_decode_dtype_matches_jax(decode_pair):
    jc, jm, sd, lat = decode_pair
    want = JaxModel(jc, jm.params, decode_dtype=jnp.bfloat16).get_latents_decoded_images(
        jnp.asarray(lat))
    got = _port_model(sd, decode_dtype=torch.bfloat16).get_latents_decoded_images(
        torch.tensor(lat))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= BF16_REL * np.abs(want).max()


def test_model_refuses_an_unknown_decode_precision():
    with pytest.raises(ValueError, match="precision"):
        VTPModel(VTPConfig(**TINY), device="cpu", decode_precision="medium")
