"""What the tensor-core attention kernels rest on, on the CPU.

The bf16 fused attention forward and its backward (both arms) run their
products as bf16 ``mma`` with fp32 accumulators (``csrc/fused_attention.cu``,
``csrc/fused_attention_bwd.cu``). That computes the plain versions' products
exactly, only summed in another order, because in the plain versions every
operand of every product is already a bf16 value: q and k after the
qk-RMSNorm and RoPE prologue, v and g, p before p·v and pᵀ·g, and ds. The
products below are caught as the plain versions call ``torch.matmul`` and
each operand is held to its own bf16 rounding, bit for bit. The JAX package
is not needed here: the invariant is the port's.

Also: a bf16 call with qk-norm scales counts its launch under the forward's
qk-norm name (``NORM_NAME``), and reaches the bf16 entry point.
"""

import numpy as np
import pytest
import torch

from vtp_tpu_torch.ops import dispatch
from vtp_tpu_torch.ops import flash_attention as fa
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

B, N, H, D_HEAD = 2, 17, 2, 64
# case: (rope grid with a 1-token prefix (0 = none), qk-norm, causal, n_valid)
CASES = {
    "plain": (0, False, False, 0),
    "rope": (4, False, False, 0),
    "qk_norm": (0, True, False, 0),
    "qk_norm_rope": (4, True, False, 0),
    "rope_causal_n_valid": (4, False, True, 13),
    "qk_norm_rope_causal_n_valid": (4, True, True, 13),
}
# operand names of the plain versions' products, in call order
FWD_OPERANDS = [("q", "k"), ("p", "v")]
BWD_OPERANDS = [("q", "k"), ("p", "g"), ("g", "v"), ("ds", "k"), ("ds", "q")]


def _inputs(case, seed):
    grid, qk_norm, causal, n_valid = CASES[case]
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.standard_normal((B, N, 3 * H * D_HEAD)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((B, N, H * D_HEAD)), dtype=torch.float32)
    t = {"qkv": qkv.bfloat16(), "g": g.bfloat16(), "sin": None, "cos": None,
         "q_scale": None, "k_scale": None, "n_valid": n_valid, "is_causal": causal}
    if grid:
        t["sin"], t["cos"] = pad_rope_prefix(*rope_sincos(rope_periods_init(D_HEAD), grid, grid), 1)
    if qk_norm:
        t["q_scale"], t["k_scale"] = (
            torch.tensor(1 + 0.1 * rng.standard_normal(D_HEAD), dtype=torch.float32)
            for _ in range(2))
    return t


def _products(monkeypatch, fn):
    """Runs ``fn`` and returns the operand pairs of every ``torch.matmul``
    it made."""
    seen, matmul = [], torch.matmul

    def spy(a, b, *args, **kwargs):
        seen.append((a, b))
        return matmul(a, b, *args, **kwargs)

    monkeypatch.setattr(torch, "matmul", spy)
    fn()
    monkeypatch.undo()
    return seen


def _assert_bf16_valued(products, names):
    assert len(products) == len(names), [tuple(a.shape) for a, _ in products]
    for (a, b), (na, nb) in zip(products, names):
        for name, x in ((na, a), (nb, b)):
            x = x.float()
            assert torch.equal(x, x.bfloat16().float()), f"{name} is not bf16-valued"


@pytest.mark.parametrize("case", list(CASES))
def test_forward_plain_products_take_bf16_operands(case, monkeypatch):
    t = _inputs(case, seed=1)
    products = _products(monkeypatch, lambda: fa.fused_qkv_rope_attention_reference(
        t["qkv"], t["sin"], t["cos"], H, t["q_scale"], t["k_scale"], n_valid=t["n_valid"],
        is_causal=t["is_causal"]))
    _assert_bf16_valued(products, FWD_OPERANDS)
    # the scores' operands are the prologue's output, not the raw input
    q, k = products[0]
    raw_q = t["qkv"].float().reshape(B, N, 3, H, D_HEAD)[:, :, 0].transpose(1, 2)
    assert torch.equal(q.float(), raw_q) == (CASES[case][:2] == (0, False))
    assert q.shape == k.transpose(-1, -2).shape == (B, H, N, D_HEAD)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_plain_products_take_bf16_operands(case, monkeypatch):
    t = _inputs(case, seed=2)
    if t["q_scale"] is None:
        run = lambda: fa.fused_qkv_rope_attention_bwd_reference(
            t["qkv"], t["g"], t["sin"], t["cos"], H, t["n_valid"], t["is_causal"])
    else:
        run = lambda: fa.fused_qkv_rope_attention_qk_norm_bwd_reference(
            t["qkv"], t["g"], t["sin"], t["cos"], t["q_scale"], t["k_scale"], H,
            t["n_valid"], t["is_causal"])
    products = _products(monkeypatch, run)
    _assert_bf16_valued(products, BWD_OPERANDS)
    # p, ds: (B, H, N, N), the rounded probabilities and score gradients
    (p, _), (ds, _) = products[1], products[3]
    assert p.shape[-2:] == (N, N) and ds.shape[-2:] == (N, N)
    assert p.abs().sum() > 0 and ds.abs().sum() > 0


@pytest.mark.parametrize("dtype,fp32_precision,qk_norm,name", [
    (torch.bfloat16, "float32", True, fa.NORM_NAME),
    (torch.bfloat16, "float32", False, fa.ARM_NAME[torch.bfloat16]),
    (torch.float32, "float32", True, fa.ARM_NAME[torch.float32]),
    (torch.float32, "high", True, fa.HIGH_NAME),
])
def test_arm_names(dtype, fp32_precision, qk_norm, name):
    assert fa.arm_name(dtype, fp32_precision, qk_norm) == name


def test_a_card_tensor_with_qk_norm_counts_under_the_norm_name(monkeypatch):
    """The bf16 forward with qk-norm scales, with the device and the library
    stood in for: the bf16 entry point, one launch counted under
    ``NORM_NAME``, and a launch error raised."""
    launched, rc = [], [0]

    def fake_kernel_fn(entry, n_pointers=6):
        def fn(*args):
            launched.append(entry)
            return rc[0]
        return fn

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fa, "on_kernel_device", lambda t: True)
    monkeypatch.setattr(fa, "_kernel_fn", fake_kernel_fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    t = _inputs("qk_norm_rope", seed=3)
    call = lambda: fa.fused_qkv_rope_attention(t["qkv"], t["sin"], t["cos"], H, t["q_scale"],
                                               t["k_scale"])
    dispatch.reset_launch_counts()
    call()
    assert launched == ["vtp_fused_qkv_rope_attention_bf16"]
    assert dispatch.launch_counts() == {fa.NORM_NAME: 1}
    rc[0] = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    dispatch.reset_launch_counts()
