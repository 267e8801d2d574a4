"""The fused CE backward kernel's arithmetic, on the CPU.

The backward kernel (``csrc/fused_ce.cu``) computes the plain version's
ds = (g / T_s) (exp(s/T_s - m_s) / l_s - exp((t - c)/T_t - m_t) / z_t)
with the reciprocals of the temperatures hoisted (1 / T_t, 1 / T_s, each
rounded to fp32 once), the row constants (g / T_s) / z_t and (g / T_s) /
l_s divided once a row, each exponent's argument one fused multiply-add
(x * (1/T) - m), each exponential an ``exp2f`` of that argument times
log2(e), and ds one fused multiply-add. A torch emulation of it (a fused
multiply-add taken in float64 and rounded to fp32 once) is held to
``fused_ce_bwd_reference`` at the kernel checks' gates: 1e-5 of max|ref|
in fp32, 1e-2 in bf16.
"""

import numpy as np
import pytest
import torch

from vtp_tpu_torch.ops.fused_ce import fused_ce_bwd_reference, fused_ce_fwd_reference

torch.set_num_threads(1)

T_TEMP, S_TEMP = 0.07, 0.1
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _fma(a, b, c):
    """fp32 a * b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_bwd(t, s, center, g, stats, t_temp, s_temp):
    f32 = torch.float32
    m_t, z_t, m_s, l_s = stats
    one = torch.tensor(1.0, dtype=f32)
    inv_tt = one / torch.tensor(t_temp, dtype=f32)
    inv_ts = one / torch.tensor(s_temp, dtype=f32)
    gs = g.float() * inv_ts
    a_t, a_s = (gs / z_t)[:, None], (gs / l_s)[:, None]
    e_t = torch.exp2(_fma(t.float() - center.float(), inv_tt, -m_t[:, None]) * LOG2E)
    e_s = torch.exp2(_fma(s.float(), inv_ts, -m_s[:, None]) * LOG2E)
    return _fma(e_s, a_s, -(e_t * a_t)).to(s.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols", [(5, 2051), (37, 1000)])
def test_kernel_arithmetic_matches_the_plain_backward(rows, cols, dtype):
    rng = np.random.default_rng(rows * cols)
    t = torch.tensor(rng.standard_normal((rows, cols)), dtype=torch.float32).to(dtype)
    s = torch.tensor(rng.standard_normal((rows, cols)), dtype=torch.float32).to(dtype)
    center = torch.tensor(0.1 * rng.standard_normal(cols), dtype=torch.float32)
    g = torch.tensor(rng.random(rows), dtype=torch.float32)
    _, stats = fused_ce_fwd_reference(t, s, center, T_TEMP, S_TEMP)
    want = fused_ce_bwd_reference(t, s, center, g, stats, T_TEMP, S_TEMP)
    got = _kernel_bwd(t, s, center, g, stats, T_TEMP, S_TEMP)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= (1e-5 if dtype is torch.float32 else 1e-2) * scale, (err, scale)
    if dtype is torch.float32:
        assert err > 0  # the emulation is not the plain version
