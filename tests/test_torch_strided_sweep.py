"""The rounding of the strided attention kernel (``csrc/flash_attention.cu``)
against the JAX package, on the CPU.

The kernel runs one sweep over 64-key tiles with the online softmax: per
tile the row max m moves, o and the fp32 sum l are rescaled by
exp(m_old - m_new), p = exp(s - m) is rounded to bf16 as the left operand
of p·v, and o is divided by l at the end; the JAX functions round the
normalised p. ``_sweep`` spells that arithmetic out in torch (keys past N
simply absent from the last tile, as the kernel masks them by bounds), and
is held to 1e-2 of max|ref|, the bf16 forward gate, against the JAX
reference of each entry: ``_sdpa_bnhd_xla`` for ``flash_attention_bnhd``
(B, N, H, d), and ``flash_attention`` (``_attn_kernel`` in interpret mode)
for the (B, H, N, d) entry, at d 32, 64, 128 and N in (1, 17, 77, 130):
one row, a ragged tile, the text length, two tiles and a ragged third.
Inputs come from numpy with a seed. This tests the stated rounding, not the
kernel, which runs only on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.ops import flash_attention as jfa

torch.set_num_threads(1)
BF16_REL = 1e-2
B, H = 2, 2


def _sweep(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The strided kernel's arithmetic on bf16 (B, H, N, d) -> bf16."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, q.shape[-2], 64):
        s = torch.matmul(qf, kf[..., k0:k0 + 64, :].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        rescale = torch.exp(m - m_new)  # 0 at the first tile
        p = torch.exp(s - m_new)
        l = l * rescale + p.sum(-1, keepdim=True)
        o = o * rescale + torch.matmul(p.bfloat16().float(), vf[..., k0:k0 + 64, :])
        m = m_new
    return (o / l).bfloat16()


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    return [torch.tensor(x).bfloat16() for x in xs], [jnp.asarray(x, jnp.bfloat16) for x in xs]


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 17, 77, 130])
def test_bnhd_sweep_matches_jax(n, d):
    (q, k, v), (jq, jk, jv) = _inputs((B, n, H, d), seed=3 * n + d)
    got = _sweep(*(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
    _close(got, jfa._sdpa_bnhd_xla(jq, jk, jv))
    if n == 1:
        assert torch.equal(got, v)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 17, 77, 130])
def test_bhnd_sweep_matches_pallas_kernel_interpret(n, d, kernels):
    kernels(interpret=True)
    (q, k, v), (jq, jk, jv) = _inputs((B, H, n, d), seed=5 * n + d)
    got = _sweep(q, k, v)
    _close(got, jfa.flash_attention(jq, jk, jv))
    if n == 1:
        assert torch.equal(got, v)
