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

The same holds for the strided attention (``csrc/flash_attention.cu``):
its plain versions multiply bf16 q, k, v and the bf16 p, at every head dim
it takes. The forward's bf16x3 ("high") arm runs its products as bf16
``mma`` too: in its plain version every product is one of hi·hi, hi·lo,
lo·hi of bf16-valued halves, and after RoPE q and k are bf16-valued, so
the scores' lo halves are 0 (the kernel then takes the scores as one
product). The kernel splits the unnormalised p = exp(s - m_running) of
each 64-key tile and divides by the row's sum at the end, where the plain
version splits the normalised p: a torch emulation of that sweep is held
within 1e-5 of max|ref| to the plain arm.

Also: a bf16 call with qk-norm scales counts its launch under the forward's
qk-norm name (``NORM_NAME``), and reaches the bf16 entry point.
"""

import numpy as np
import pytest
import torch

from vtp_tpu_torch.ops import dispatch
from vtp_tpu_torch.ops import flash_attention as fa
from vtp_tpu_torch.ops.precision import matmul_high_reference
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

torch.set_num_threads(1)

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


def _inputs(case, seed, n=N, dtype=torch.bfloat16):
    grid, qk_norm, causal, n_valid = CASES[case]
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.standard_normal((B, n, 3 * H * D_HEAD)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((B, n, H * D_HEAD)), dtype=torch.float32)
    t = {"qkv": qkv.to(dtype), "g": g.bfloat16(), "sin": None, "cos": None,
         "q_scale": None, "k_scale": None, "n_valid": n_valid, "is_causal": causal}
    if grid:
        grid = int(np.ceil(np.sqrt(n - 1)))  # n - 1 tokens of a square grid, cut to fit
        sin, cos = pad_rope_prefix(*rope_sincos(rope_periods_init(D_HEAD), grid, grid), 1)
        t["sin"], t["cos"] = sin[:n], cos[:n]
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


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("bnhd", [True, False], ids=["bnhd", "bhnd"])
def test_strided_plain_products_take_bf16_operands(bnhd, d, monkeypatch):
    """The strided kernel's plain versions: q·kᵀ and p·v, every operand a
    bf16 value, p being the rounded probabilities."""
    rng = np.random.default_rng(d)
    shape = (B, N, H, d) if bnhd else (B, H, N, d)
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32).bfloat16()
               for _ in range(3))
    plain = fa.flash_attention_bnhd_reference if bnhd else fa.flash_attention_reference
    products = _products(monkeypatch, lambda: plain(q, k, v))
    _assert_bf16_valued(products, FWD_OPERANDS)
    (s_q, s_k), (p, pv) = products
    assert s_q.shape == s_k.transpose(-1, -2).shape == (B, H, N, d)
    assert p.shape == (B, H, N, N) and pv.shape == (B, H, N, d)
    torch.testing.assert_close(p.sum(-1), torch.ones(B, H, N), atol=2e-2, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_high_plain_products_take_bf16_halves(case, monkeypatch):
    """The bf16x3 arm's plain version: six products, hi·hi, hi·lo, lo·hi for
    the scores and then for p·v, every operand bf16-valued; with RoPE the
    scores' lo halves are 0."""
    t = _inputs(case, seed=4, dtype=torch.float32)
    products = _products(monkeypatch, lambda: fa.fused_qkv_rope_attention_reference(
        t["qkv"], t["sin"], t["cos"], H, t["q_scale"], t["k_scale"], n_valid=t["n_valid"],
        is_causal=t["is_causal"], fp32_precision="high"))
    names = [("q_hi", "k_hi"), ("q_hi", "k_lo"), ("q_lo", "k_hi"),
             ("p_hi", "v_hi"), ("p_hi", "v_lo"), ("p_lo", "v_hi")]
    _assert_bf16_valued(products, names)
    for first in (0, 3):  # hi·hi, hi·lo, lo·hi: shared halves are the same tensors
        (a_hh, b_hh), (a_hl, b_hl), (a_lh, b_lh) = products[first:first + 3]
        assert torch.equal(a_hh, a_hl) and torch.equal(b_hh, b_lh)
        assert b_hl.abs().max() <= 2 ** -8 * b_hh.abs().max()
    (_, k_hi), (_, k_lo), (q_lo, _) = products[:3]
    roped = CASES[case][0] > 0
    assert (k_lo.abs().max() == 0 and q_lo.abs().max() == 0) == roped


def _split_sweep(q, k, v, is_causal, n_valid, precision):
    """The bf16x3 kernel's softmax in torch on (B, H, N, d) fp32: the plain
    arm's scores, then one sweep over 64-key tiles, p = exp(s - m_running)
    split into bf16 halves as the left operand of p·v, o and l rescaled when
    the row max moves, o divided by l at the end."""
    assert precision == "high"
    scale = q.shape[-1] ** -0.5
    s = matmul_high_reference(q, k.transpose(-1, -2)) * scale
    n = s.shape[-1]
    col = torch.arange(n)
    if n_valid:
        s = s.masked_fill(col >= n_valid, float("-inf"))
    if is_causal:
        s = s.masked_fill(col[None, :] > col[:, None], float("-inf"))
    m = torch.full(s.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, n, 64):
        st = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        rescale = torch.exp(m - base)
        p = torch.exp(st - base)
        l = l * rescale + p.sum(-1, keepdim=True)
        o = o * rescale + matmul_high_reference(p, v[..., k0:k0 + 64, :])
        m = m_new
    return o / l


@pytest.mark.parametrize("n", [17, 77, 130])
@pytest.mark.parametrize("case", ["plain", "rope", "qk_norm", "qk_norm_rope_causal_n_valid"])
def test_high_single_sweep_matches_the_plain_arm(case, n, monkeypatch):
    """Splitting the unnormalised p and dividing by l afterwards stays within
    1e-5 of max|ref| of the plain bf16x3 arm: the two differ in where p is
    split and in the fp32 rescales, at about 2^-16 of p."""
    t = _inputs(case, seed=n, n=n, dtype=torch.float32)
    if t["n_valid"]:
        t["n_valid"] = n - 4
    call = lambda: fa.fused_qkv_rope_attention_reference(
        t["qkv"], t["sin"], t["cos"], H, t["q_scale"], t["k_scale"], n_valid=t["n_valid"],
        is_causal=t["is_causal"], fp32_precision="high")
    want = call()
    monkeypatch.setattr(fa, "sdpa_reference", _split_sweep)
    got = call()
    monkeypatch.undo()
    assert got.shape == want.shape == (B, n, H * D_HEAD)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), (err, want.abs().max().item())
    assert err > 0  # the sweep is not the plain arm


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
