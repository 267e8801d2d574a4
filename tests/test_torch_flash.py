"""The port's plain attention without a prologue on the CPU, against the
JAX package's two Pallas kernels in interpret mode.

- ``flash_attention_bnhd_reference`` against ``flash_attention_bnhd``
  (``_flash_bnhd_impl``) and ``flash_attention_reference`` against
  ``flash_attention`` (``_attn_kernel``, which pads N to a multiple of 128:
  N = 77 runs its pad and mask) at N in {5, 77, 128} and every head dim the
  kernels take; bf16 within 5e-2 of max|ref|, the bf16 forward gate.
- The gradient of ``flash_attention_bnhd`` against ``jax.vjp`` of the JAX
  function (its custom VJP, ``_flash_bnhd_bwd``).
- ``sdpa``'s route against ``flash_supported`` (bias, causal, fp32,
  unequal shapes), and the predicates against the JAX gates; the route a
  CUDA tensor takes, with the device and the library stood in for: each
  entry's own C function and launch count, the strided text-path views
  passed in place, a launch error raised.
- ``flash_attention`` raising under grad, as it has no backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.ops import flash_attention as jfa
from vtp_tpu_torch.ops import dispatch
from vtp_tpu_torch.ops import flash_attention as fa
from vtp_tpu_torch.ops.attention import sdpa, sdpa_reference

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
B, H = 2, 2


def _qkv(shape, seed, dtype="fp32"):
    """Three inputs from numpy, as (torch, jax) lists in bf16 or fp32."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    if dtype == "bf16":
        return ([torch.tensor(x).bfloat16() for x in xs],
                [jnp.asarray(x, jnp.bfloat16) for x in xs])
    return [torch.tensor(x) for x in xs], [jnp.asarray(x) for x in xs]


def _close(got, want, gate="bf16"):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    if gate == "bf16":
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())
    else:
        assert err <= F32_ABS, err


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [5, 77, 128])
def test_bnhd_plain_matches_pallas_kernel_interpret(n, d, kernels):
    kernels(interpret=True)
    (q, k, v), (jq, jk, jv) = _qkv((B, n, H, d), seed=n + d, dtype="bf16")
    got = fa.flash_attention_bnhd(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == (B, n, H, d)
    _close(got, jfa.flash_attention_bnhd(jq, jk, jv))


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [5, 77, 128])
def test_bhnd_plain_matches_pallas_kernel_interpret(n, d, kernels):
    kernels(interpret=True)
    (q, k, v), (jq, jk, jv) = _qkv((B, H, n, d), seed=2 * n + d, dtype="bf16")
    got = fa.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, n, d)
    _close(got, jfa.flash_attention(jq, jk, jv))


@pytest.mark.parametrize("dtype,gate", [("bf16", "bf16"), ("fp32", "fp32")])
def test_bnhd_gradient_matches_jax_vjp(dtype, gate, kernels):
    kernels(interpret=True)
    (q, k, v), (jq, jk, jv) = _qkv((B, 77, H, 64), seed=3, dtype=dtype)
    g = np.random.default_rng(4).standard_normal((B, 77, H, 64)).astype(np.float32)
    jg = jnp.asarray(g, jq.dtype)
    want_o, vjp = jax.vjp(jfa.flash_attention_bnhd, jq, jk, jv)
    want = vjp(jg)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_bnhd(*leaves)
    out.backward(torch.tensor(g).to(out.dtype))
    _close(out.detach(), want_o, gate)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, w, gate)


def test_bnhd_gradient_is_the_adjoint_of_the_plain_forward():
    (q, k, v), _ = _qkv((B, 9, H, 32), seed=5)
    g = torch.tensor(np.random.default_rng(6).standard_normal((B, 9, H, 32)).astype(np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_bnhd(*a).backward(g)
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_bnhd_reference(*b).backward(g)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-6)


def test_flash_attention_raises_under_grad():
    (q, k, v), _ = _qkv((B, H, 8, 32), seed=7)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).shape == (B, H, 8, 32)
    with pytest.raises(ValueError, match="non-causal"):
        fa.flash_attention(q.detach(), k, v, is_causal=True)


# ------------------------------------------------------------------ routing

def _route_cases():
    """(name, q/k/v shapes, dtype, bias, is_causal) for sdpa's routes."""
    s = (B, H, 16, 32)
    return [
        ("supported", (s, s, s), torch.bfloat16, False, False),
        ("bias", (s, s, s), torch.bfloat16, True, False),
        ("causal", (s, s, s), torch.bfloat16, False, True),
        ("fp32", (s, s, s), torch.float32, False, False),
        ("unequal_q_k", ((B, H, 8, 32), s, s), torch.bfloat16, False, False),
        ("head_dim_48", ((B, H, 16, 48),) * 3, torch.bfloat16, False, False),
        ("one_token", ((B, H, 1, 32),) * 3, torch.bfloat16, False, False),
    ]


class _Stream:
    cuda_stream = 0


@pytest.fixture
def stand_in_card(monkeypatch):
    """A CUDA device and kernel library stood in for: every tensor counts as
    on the card, and each launch records its entry point and arguments."""
    launched, rc = [], [0]

    def fake_kernel_fn(entry):
        def fn(*args):
            launched.append((entry, args))
            return rc[0]
        return fn

    monkeypatch.setattr(fa, "on_kernel_device", lambda t: True)
    monkeypatch.setattr(fa, "_flash_kernel_fn", fake_kernel_fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    dispatch.reset_launch_counts()
    yield launched, rc
    dispatch.reset_launch_counts()


@pytest.mark.parametrize("name,shapes,dtype,bias,causal", _route_cases())
def test_sdpa_routes_by_flash_supported(name, shapes, dtype, bias, causal, stand_in_card):
    launched, _ = stand_in_card
    rng = np.random.default_rng(8)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32)).to(dtype) for s in shapes)
    b = torch.zeros((B, 1, shapes[0][2], shapes[1][2])) if bias else None
    supported = fa.flash_supported(q, k, v, is_causal=causal)
    assert supported == (name in ("supported", "bias"))
    out = sdpa(q, k, v, bias=b, is_causal=causal)
    if supported and b is None:
        assert [e for e, _ in launched] == [fa.FLASH_ENTRY]
        assert dispatch.launch_counts() == {fa.FLASH_NAME: 1}
    else:
        assert launched == [] and dispatch.launch_counts() == {}
        torch.testing.assert_close(out, sdpa_reference(q, k, v, bias=b, is_causal=causal))


def test_text_path_views_reach_the_kernel_in_place(stand_in_card):
    """The permuted q, k, v views of a (B, L, 3*H*d) qkv GEMM output go to
    the (B, H, N, d) entry with their own pointers and strides, no copy."""
    launched, rc = stand_in_card
    L, d = 77, 64
    qkv = torch.randn(B, L, 3 * H * d).bfloat16()
    q, k, v = qkv.reshape(B, L, 3, H, d).permute(2, 0, 3, 1, 4)
    out = fa.flash_attention(q, k, v)
    assert out.shape == (B, H, L, d) and out.is_contiguous()
    (entry, args), = launched
    assert entry == fa.FLASH_ENTRY
    assert args[:3] == tuple(t.data_ptr() for t in (q, k, v))
    assert args[4:8] == (B, L, H, d)
    # (batch, token, head) strides of each input
    assert args[8:17] == (L * 3 * H * d, 3 * H * d, d) * 3
    assert args[17] == pytest.approx(d ** -0.5)
    rc[0] = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fa.flash_attention(q, k, v)
    assert dispatch.launch_counts() == {fa.FLASH_NAME: 1}


def test_bnhd_entry_writes_heads_flattened(stand_in_card):
    launched, _ = stand_in_card
    q, k, v = (torch.randn(B, 9, H, 32).bfloat16() for _ in range(3))
    out = fa.flash_attention_bnhd(q, k, v)
    assert out.shape == (B, 9, H, 32)
    (entry, args), = launched
    assert entry == fa.FLASH_BNHD_ENTRY and args[4:8] == (B, 9, H, 32)
    assert args[8:17] == (9 * H * 32, H * 32, 32) * 3
    assert dispatch.launch_counts() == {fa.FLASH_BNHD_NAME: 1}


def test_card_tensors_the_kernel_cannot_take_raise(stand_in_card):
    launched, _ = stand_in_card
    q = torch.randn(B, 9, H, 32)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_bnhd(q, q, q)
    assert launched == []


@pytest.mark.parametrize("shape,dtype", [
    ((B, H, 16, 32), jnp.bfloat16), ((B, H, 16, 64), jnp.bfloat16), ((B, H, 77, 128), jnp.bfloat16),
    ((B, H, 16, 48), jnp.bfloat16), ((B, H, 16, 32), jnp.float32), ((B, H, 1, 32), jnp.bfloat16),
    ((B, 16, 32), jnp.bfloat16),
])
def test_predicates_mirror_the_jax_gates(shape, dtype):
    """On shapes below the JAX gates' TPU-only limits (sequence cap, VMEM
    budget) and with no mesh, the port's predicates agree with them."""
    x = jnp.zeros(shape, dtype)
    t = torch.zeros(shape, dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    assert fa.flash_supported(t, t, t) == jfa.flash_supported(x, x, x)
    assert fa.flash_supported_bnhd(t, t, t) == jfa.flash_supported_bnhd(x, x, x)
    assert not fa.flash_supported(t, t, t, is_causal=True)
