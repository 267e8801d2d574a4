"""The port's plain fused qkv+RoPE attention against the JAX function on
the CPU: against ``_fused_reference_impl`` and against the Pallas kernel
``_fused_kernel_call`` run in interpret mode. The CUDA kernel itself runs
only on the card, where ``chip_smoke.py`` holds it against this plain
version."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.ops.flash_attention import _fused_kernel_call, _fused_reference_impl
from vtp_tpu_torch import _build
from vtp_tpu_torch.ops import dispatch
from vtp_tpu_torch.ops.flash_attention import (
    fused_qkv_rope_attention,
    fused_qkv_rope_attention_reference,
)
from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
H, D_HEAD = 2, 64
GRID = {17: 4, 257: 16}
# case: (rope with a 1-token prefix, n_valid offset from N, causal, qk-norm)
CASES = {
    "rope_prefix": (True, 0, False, False),
    "n_valid": (True, 4, False, False),
    "causal": (False, 0, True, False),
    "qk_norm": (True, 0, False, True),
}


def _inputs(dtype, case, N, seed=0):
    rng = np.random.default_rng(seed)
    rope, nv_off, causal, qk = CASES[case]
    x = rng.standard_normal((2, N, 3 * H * D_HEAD)).astype(np.float32)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}[dtype]
    t = {"qkv": torch.tensor(x).to(tdt), "n_valid": N - nv_off if nv_off else 0, "is_causal": causal}
    j = {"qkv": jnp.asarray(x, jdt), "n_valid": t["n_valid"], "is_causal": causal}
    t["sin"] = t["cos"] = j["sin"] = j["cos"] = None
    t["q_scale"] = t["k_scale"] = j["q_scale"] = j["k_scale"] = None
    if rope:
        g = GRID[N]
        sin, cos = pad_rope_prefix(*rope_sincos(rope_periods_init(D_HEAD), g, g), 1)
        t["sin"], t["cos"] = sin, cos
        j["sin"], j["cos"] = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (sin, cos))
    if qk:
        qs, ks = (rng.standard_normal(D_HEAD).astype(np.float32) * 0.1 + 1 for _ in range(2))
        t["q_scale"], t["k_scale"] = torch.tensor(qs), torch.tensor(ks)
        j["q_scale"], j["k_scale"] = jnp.asarray(qs), jnp.asarray(ks)
    return t, j


def _port(t):
    return fused_qkv_rope_attention(t["qkv"], t["sin"], t["cos"], H, t["q_scale"], t["k_scale"],
                                    n_valid=t["n_valid"], is_causal=t["is_causal"])


def _assert_within_gate(err, scale, dtype, bf16_rope):
    """fp32 within 5e-4 abs, bf16 within 5e-2 rel of max |want|. RoPE is
    bf16 arithmetic in every arm; where an fp32 input to it may differ by
    an ulp (``bf16_rope``), a bf16 rounding of the rotated q/k can flip,
    and the fp32 arm is held to the bf16 gate."""
    if dtype == "bf16" or bf16_rope:
        assert err <= BF16_REL * scale, (err, scale)
    else:
        assert err <= F32_ABS, err


def _err(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    return np.abs(got - want).max(), np.abs(want).max()


@pytest.mark.parametrize("N", [17, 257])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_plain_matches_jax_reference(dtype, case, N):
    t, j = _inputs(dtype, case, N)
    got = _port(t)
    assert got.dtype == t["qkv"].dtype and got.shape == (2, N, H * D_HEAD)
    want = _fused_reference_impl(j["qkv"], j["sin"], j["cos"], j["q_scale"], j["k_scale"], H,
                                 n_valid=j["n_valid"], is_causal=j["is_causal"])
    err, scale = _err(got, want)
    # qk-norm feeds RoPE an fp32 value whose mean-of-squares is summed in
    # another order than JAX's
    rope, _, _, qk = CASES[case]
    _assert_within_gate(err, scale, dtype, bf16_rope=rope and qk)


@pytest.mark.parametrize("N", [17, 257])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_plain_matches_pallas_kernel_interpret(dtype, case, N, kernels):
    kernels(interpret=True)
    t, j = _inputs(dtype, case, N, seed=1)
    got = _port(t)
    want = _fused_kernel_call(j["qkv"], j["sin"], j["cos"], H, j["q_scale"], j["k_scale"],
                              n_valid=j["n_valid"], is_causal=j["is_causal"])
    err, scale = _err(got, want)
    # the Pallas kernel rotates in fp32 and rounds once
    # (flash_attention.py:535-548) where the reference and the port round
    # each product and the sum
    _assert_within_gate(err, scale, dtype, bf16_rope=CASES[case][0])


def test_cpu_wrapper_never_touches_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    dispatch.reset_launch_counts()
    t, _ = _inputs("bf16", "qk_norm", 17)
    got = _port(t)
    want = fused_qkv_rope_attention_reference(t["qkv"], t["sin"], t["cos"], H, t["q_scale"],
                                              t["k_scale"])
    assert torch.equal(got, want)
    assert dispatch.launch_counts() == {}


@pytest.mark.parametrize("bad", ["rank", "heads", "dtype", "table_shape", "unpaired", "scale_shape",
                                 "n_valid"])
def test_wrapper_rejects_bad_inputs(bad):
    t, _ = _inputs("fp32", "qk_norm", 17)
    args = dict(qkv=t["qkv"], sin=t["sin"], cos=t["cos"], num_heads=H, q_scale=t["q_scale"],
                k_scale=t["k_scale"], n_valid=0)
    if bad == "rank":
        args["qkv"] = t["qkv"][0]
    elif bad == "heads":
        args["num_heads"] = 5
    elif bad == "dtype":
        args["qkv"] = t["qkv"].half()
    elif bad == "table_shape":
        args["sin"], args["cos"] = t["sin"][1:], t["cos"][1:]
    elif bad == "unpaired":
        args["cos"] = None
    elif bad == "scale_shape":
        args["q_scale"] = args["k_scale"] = torch.ones(32)
    else:
        args["n_valid"] = 18
    with pytest.raises((ValueError, TypeError)):
        fused_qkv_rope_attention(**args)


def test_dispatch_is_by_device():
    assert dispatch.on_kernel_device(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        dispatch.on_kernel_device(torch.zeros(1, device="meta"))


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def build_dirs(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    return csrc, out


def test_build_command_targets_sm90a(build_dirs, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command(tmp_path / "lib.so", _build.sources())
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in cmd and "-fPIC" in cmd and cmd[-1].endswith("k.cu")


def test_library_name_follows_the_sources(build_dirs):
    csrc, _ = build_dirs
    first = _build.library_path()
    assert first == _build.library_path()
    (csrc / "k.cu").write_text("// kernel, edited\n")
    assert _build.library_path() != first


def test_nvcc_lookup_order(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    monkeypatch.setenv("CUDA_HOME", str(home))
    if not os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        with pytest.raises(RuntimeError):
            _build.nvcc_path()
    _fake_nvcc(home / "bin", "exit 0\n")
    assert _build.nvcc_path() == str(home / "bin" / "nvcc")
    monkeypatch.setenv("PATH", str(tmp_path / "cuda" / "bin"))
    assert _build.nvcc_path() == str(home / "bin" / "nvcc")


def test_failed_build_raises_with_nvcc_output_and_leaves_nothing(build_dirs, tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: no such intrinsic" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build()
    _, out = build_dirs
    assert list(out.iterdir()) == []


def test_build_moves_the_library_into_place_once(build_dirs, tmp_path, monkeypatch):
    # writes the file named after -o, and counts its calls
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n'
                      f'echo x >> "{tmp_path}/calls"\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    lib = _build.build()
    assert lib == _build.library_path() and lib.read_text() == "lib\n"
    assert _build.build() == lib
    assert (tmp_path / "calls").read_text() == "x\n"
    _, out = build_dirs
    assert sorted(p.name for p in out.iterdir()) == sorted([lib.name,
                                                           _build.report_path(lib).name])


def test_ptxas_report_is_kept_beside_the_library(build_dirs, tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "ptxas info    : Used 7 registers" >&2\n'
                      'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="no ptxas report"):
        _build.ptxas_report()
    _build.build()
    assert "Used 7 registers" in _build.ptxas_report()
    # a later process loads the built library and reads the same report
    assert _build.build() == _build.library_path()
    assert "Used 7 registers" in _build.ptxas_report()
