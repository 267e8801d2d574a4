"""The exact fp32 arm's single sweep, on the CPU.

The exact fp32 kernel (``csrc/fused_attention.cu``) computes the plain
version's function with plain fp32 FMAs in one sweep over 64-key tiles:
the scores of a tile scaled by d^-1/2 and masked, an online row max m,
p = exp(s - m) kept in fp32, o and the row sum l rescaled by
exp(m_old - m_new) when the max moves, and o multiplied by 1 / l at the
end. No rounding point moves: it differs from
``fused_qkv_rope_attention_reference`` only in the order of its fp32 sums
and in where 1 / l is applied. A torch emulation of that sweep, put in
place of the plain version's ``sdpa_reference``, is held within 1e-5 of
max|ref| to the plain arm (the prologue, qk-norm and RoPE, is the plain
version's own). The plain arm is held to the JAX package elsewhere
(``tests/test_torch_attention.py``).
"""

import numpy as np
import pytest
import torch

from vtp_tpu_torch.ops import flash_attention as fa
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

torch.set_num_threads(1)

B, H, D_HEAD, TILE = 2, 2, 64, 64
# case: (rope grid with a 1-token prefix (0 = none), qk-norm, causal, n_valid)
CASES = {
    "plain": (0, False, False, False),
    "n_valid": (0, False, False, True),
    "causal": (0, False, True, False),
    "causal_n_valid_rope": (4, False, True, True),
    "qk_norm": (0, True, False, False),
    "qk_norm_rope": (4, True, False, False),
}


def _inputs(case, n, seed):
    grid, qk_norm, causal, masked = CASES[case]
    rng = np.random.default_rng(seed)
    t = {"qkv": torch.tensor(rng.standard_normal((B, n, 3 * H * D_HEAD)), dtype=torch.float32),
         "sin": None, "cos": None, "q_scale": None, "k_scale": None,
         "n_valid": max(1, n - 13) if masked else 0, "is_causal": causal}
    if grid:
        grid = max(1, int(np.ceil(np.sqrt(max(n - 1, 1)))))  # n - 1 grid tokens, cut to fit
        sin, cos = pad_rope_prefix(*rope_sincos(rope_periods_init(D_HEAD), grid, grid), 1)
        t["sin"], t["cos"] = sin[:n], cos[:n]
    if qk_norm:
        t["q_scale"], t["k_scale"] = (
            torch.tensor(1 + 0.1 * rng.standard_normal(D_HEAD), dtype=torch.float32)
            for _ in range(2))
    return t


def _exact_sweep(q, k, v, is_causal=False, n_valid=0, precision="float32"):
    """The exact kernel's softmax in torch on (B, H, N, d) fp32: per 64-key
    tile the scores, scaled and masked, the row max moved, o and l rescaled
    by exp(m_old - m_new), p = exp(s - m) in fp32 added into l and o; o
    times 1 / l at the end."""
    assert precision == "float32"
    n = q.shape[-2]
    scale = q.shape[-1] ** -0.5
    rows = torch.arange(n)
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, n, TILE):
        s = torch.matmul(q, k[..., k0:k0 + TILE, :].transpose(-1, -2)) * scale
        cols = rows[k0:k0 + TILE]
        masked = (cols >= (n_valid or n))[None, :].expand(n, -1)
        if is_causal:
            masked = masked | (cols[None, :] > rows[:, None])
        s = s.masked_fill(masked, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        rescale = torch.exp(m - base)
        p = torch.exp(s - base)
        l = l * rescale + p.sum(-1, keepdim=True)
        o = o * rescale + torch.matmul(p, v[..., k0:k0 + TILE, :])
        m = m_new
    return o * (1.0 / l)


@pytest.mark.parametrize("n", [1, 77, 130])
@pytest.mark.parametrize("case", list(CASES))
def test_exact_single_sweep_matches_the_plain_arm(case, n, monkeypatch):
    """One sweep with the online rescale and the final 1 / l stays within
    1e-5 of max|ref| of the plain exact arm, at one key, one ragged tile
    and three tiles, with n_valid, causal, RoPE and qk-norm."""
    t = _inputs(case, n, seed=n)
    call = lambda: fa.fused_qkv_rope_attention_reference(
        t["qkv"], t["sin"], t["cos"], H, t["q_scale"], t["k_scale"], n_valid=t["n_valid"],
        is_causal=t["is_causal"])
    want = call()
    swept = []

    def sweep(*args, **kwargs):
        swept.append(True)
        return _exact_sweep(*args, **kwargs)

    monkeypatch.setattr(fa, "sdpa_reference", sweep)
    got = call()
    monkeypatch.undo()
    assert swept and got.shape == want.shape == (B, n, H * D_HEAD)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), (err, want.abs().max().item())
