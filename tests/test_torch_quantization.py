"""The port's int8 W8A8 quantization (``vtp_tpu_torch.utils.quantization``
and the ``ops.ffn.linear`` dispatch) against ``vtp_tpu.utils.quantization``
on the CPU, on the same fp32 weights made from a seed with numpy:

- ``quantize_kernel``: codes bit-equal to JAX's (transposed: the port keeps
  torch's ``(out, in)``), scales equal, stacked depth axes per layer;
- ``int8_linear`` within 1e-6 of max|ref| of JAX's; the JAX tests' own
  bounds (error <= scale / 2, rel < 0.02 against the float linear);
- ``linear`` on an ``Int8Weight`` (dtype, no "high" mode), the K-masked qkv
  bias reaching the int8 output, head-major equivariance of the codes, the
  padded small-row product equal to the unpadded one and to the float64
  product;
- a JAX int8 tree carried across by ``export_params_state_dict`` /
  ``load_numpy_dit_params`` equal to the port's own quantization of the
  same float weights, tensor for tensor."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.dit import model as jdit
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.ops.ffn import linear as jax_linear
from vtp_tpu.parallel.sharding import qkv_head_major
from vtp_tpu.utils import quantization as jq
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.convert.to_torch import export_params_state_dict
from vtp_tpu_torch.convert.to_torch import export_state_dict as export_canonical
from vtp_tpu_torch.dit.model import DiT, DiTConfig, load_numpy_dit_params
from vtp_tpu_torch.models.blocks import Attention, BlockConfig
from vtp_tpu_torch.ops.ffn import linear
from vtp_tpu_torch.tools.sample_dit import quantize_dit_for_serving
from vtp_tpu_torch.utils.quantization import (
    INT_MM_MIN_ROWS,
    Int8Weight,
    int8_linear,
    int8_matmul,
    quantize_kernel,
    quantize_matmul_params,
)

torch.set_num_threads(1)
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=12,
            text_vocab_size=128, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
PARTS = ("trunk", "text", "pixel_decoder")


def _weights(seed, shape, scale=0.05):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 96), (3, 24, 40)])
def test_quantize_kernel_bit_equal_to_jax(shape):
    """(..., out, in) here, (..., in, out) in JAX; one outlier row, one zero row."""
    w = _weights(0, shape)
    w[..., 0, :] *= 40.0
    w[..., 1, :] = 0.0
    q, scale = quantize_kernel(torch.tensor(w))
    want = jq.quantize_kernel(jnp.asarray(np.swapaxes(w, -1, -2)))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.swapaxes(np.asarray(want["q"]), -1, -2))
    assert np.array_equal(scale.numpy(), np.asarray(want["scale"]))
    if len(shape) == 3:  # a stacked depth axis quantizes per layer
        for i in range(shape[0]):
            qi, si = quantize_kernel(torch.tensor(w[i]))
            assert torch.equal(qi, q[i]) and torch.equal(si, scale[i])


def test_quantize_kernel_error_bound():
    """JAX's bound: symmetric round to nearest, error <= scale / 2."""
    w = torch.tensor(_weights(1, (64, 96), 0.07))
    qw = Int8Weight.quantize(w)
    err = (qw.dequantize() - w).abs()
    assert (err - qw.scale[:, None] / 2).max().item() <= 1e-7


@pytest.mark.parametrize("rows", [5, 17, 40])
def test_int8_linear_matches_jax(rows):
    x = np.random.default_rng(2).standard_normal((rows, 96)).astype(np.float32)
    w, b = _weights(3, (64, 96)), _weights(4, (64,), 0.01)
    want = np.asarray(jq.int8_linear(jnp.asarray(x), jq.quantize_kernel(jnp.asarray(w.T)),
                                     jnp.asarray(b)))
    got = int8_linear(torch.tensor(x), Int8Weight.quantize(torch.tensor(w)), torch.tensor(b))
    assert got.dtype == torch.float32 and got.shape == (rows, 64)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    ref = x @ w.T + b
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel < 0.02, rel


def test_linear_dispatches_on_int8_weights():
    """``ops.ffn.linear`` runs the W8A8 product on an ``Int8Weight``, as JAX's
    ``linear`` does on ``{q, scale, bias}``: fp32 without a compute dtype,
    the product cast to one; "high" raises."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 7, 32)).astype(np.float32)
    w, b = _weights(6, (24, 32), 0.1), _weights(7, (24,), 0.01)
    qw = Int8Weight.quantize(torch.tensor(w))
    jp = jq.quantize_matmul_params({"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)})
    for tdt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        got = linear(torch.tensor(x), qw, torch.tensor(b), tdt)
        want = np.asarray(jax_linear(jnp.asarray(x), jp, jdt).astype(jnp.float32))
        assert got.dtype == (tdt or torch.float32) and got.shape == want.shape
        assert np.abs(got.float().numpy() - want).max() <= 1e-6 * np.abs(want).max()
    with pytest.raises(ValueError, match="high"):
        linear(torch.tensor(x), qw, None, precision="high")


def test_k_masked_qkv_bias_reaches_the_int8_output():
    """With ``mask_k_bias`` the K columns of the qkv bias are zeroed before
    the product, as JAX masks the bias before ``linear``: the int8 qkv's K
    columns carry no bias, its Q and V columns all of it."""
    cfg = BlockConfig(dim=64, num_heads=2, mask_k_bias=True)
    attn = Attention(cfg)
    with torch.no_grad():
        attn.qkv.weight.copy_(torch.tensor(_weights(8, (192, 64))))
        attn.qkv.bias.copy_(torch.tensor(_weights(9, (192,), 0.5)))
        attn.proj.weight.copy_(torch.tensor(_weights(10, (64, 64))))
        attn.proj.bias.zero_()
    qattn = quantize_matmul_params(attn)
    assert isinstance(qattn.qkv.weight, Int8Weight) and qattn.qkv.bias is attn.qkv.bias
    x = torch.tensor(np.random.default_rng(11).standard_normal((6, 64)).astype(np.float32))
    got = linear(x, qattn.qkv.weight, qattn.qkv_bias())
    bare = int8_linear(x, qattn.qkv.weight)
    assert torch.equal(got[:, 64:128], bare[:, 64:128])
    for cols in (slice(0, 64), slice(128, 192)):
        assert torch.equal(got[:, cols], bare[:, cols] + attn.qkv.bias[cols])


def test_head_major_quantization_commutes_with_the_permutation():
    """Per-output-channel codes and scales follow a column permutation: the
    head-major qkv quantized as it stands is the canonical one's, permuted."""
    w = _weights(12, (3 * 64, 48))
    perm = lambda a: np.ascontiguousarray(qkv_head_major(a.T, 4, 2).T)
    canon = Int8Weight.quantize(torch.tensor(w))
    hm = Int8Weight.quantize(torch.tensor(perm(w)))
    assert np.array_equal(hm.q.numpy(), perm(canon.q.numpy()))
    assert np.array_equal(hm.scale.numpy(), qkv_head_major(canon.scale.numpy(), 4, 2))


def test_head_major_int8_trunk_encodes_as_the_canonical_one():
    """A ``vision_qkv_head_major = 2`` trunk (its split path), quantized as it
    stands, gives the canonical int8 trunk's latents (fp32 encode)."""
    cfg = VTPConfig(**dict(TINY, vision_embed_dim=128, train_clip=False))
    canon = VTPModel.init(cfg, torch.Generator().manual_seed(0), device="cpu", encode_dtype=None)
    hm = VTPModel(dataclasses.replace(cfg, vision_qkv_head_major=2), device="cpu",
                  encode_dtype=None)
    hm.load_numpy_state_dict(export_canonical(canon))
    x = torch.tensor(np.random.default_rng(13).standard_normal((2, 3, 32, 32)),
                     dtype=torch.float32)
    want = canon.quantize_for_serving().get_reconstruction_latents(x)
    got = hm.quantize_for_serving().get_reconstruction_latents(x)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("rows", [1, 8, 16])
def test_padded_small_row_product_equals_the_unpadded(rows):
    """Fewer than 17 rows (the DiT's ada and t_embed projections at B = 8 or
    16, text pooling) are padded with zero rows for ``torch._int_mm`` on the
    card; the sliced result equals the unpadded product (the CPU takes any
    row count) and the float64 product, exactly."""
    assert rows < INT_MM_MIN_ROWS
    rng = np.random.default_rng(rows)
    xq = torch.tensor(rng.integers(-127, 128, (rows, 1152)), dtype=torch.int8)
    q = torch.tensor(rng.integers(-127, 128, (6 * 64, 1152)), dtype=torch.int8)
    got = int8_matmul(xq, q)
    assert got.dtype == torch.int32 and got.shape == (rows, 6 * 64)
    assert torch.equal(got, torch._int_mm(xq, q.t()))
    assert torch.equal(got.double(), xq.double() @ q.double().t())


@pytest.mark.parametrize("head_major", [1, 2])
def test_jax_int8_vtp_tree_loads_into_the_port(head_major):
    """A JAX model quantized by ``quantize_for_serving`` (trunk, text, pixel
    decoder; a K-masked-bias trunk, canonical or head-major) goes across by
    ``export_params_state_dict`` into a quantized port model, tensor for
    tensor the port's own quantization of the same float weights."""
    overrides = dict(TINY, vision_mask_k_bias=True, vision_qkv_head_major=head_major)
    jc = JaxConfig(**overrides)
    jm = JaxModel.init(jax.random.key(0), jc)
    tm = VTPModel(VTPConfig(**overrides), device="cpu")
    tm.load_numpy_state_dict(export_state_dict(jm.params, jc))
    want = tm.quantize_for_serving(PARTS).state_dict()
    jparams = jax.tree.map(np.asarray, jm.quantize_for_serving(PARTS).params)
    sd = export_params_state_dict(jparams, VTPConfig(**overrides))
    loaded = VTPModel.init(VTPConfig(**overrides), device="cpu").quantize_for_serving(PARTS)
    loaded.load_numpy_state_dict(sd)
    got = loaded.state_dict()
    assert sorted(got) == sorted(want)
    n_int8 = 0
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        n_int8 += v.dtype == torch.int8
    # qkv, proj, w1, w2, w3 a block (trunk, decoder), 4 a text block + the
    # projection, the decoder's proj_in and proj_out
    assert n_int8 == 5 * 2 + 5 * 2 + 4 * 2 + 1 + 2


def test_jax_int8_dit_tree_loads_into_the_port():
    """The JAX ``sample_dit --int8`` tree (every linear but ``x_embed`` and
    ``final``) through ``load_numpy_dit_params`` equals the port's
    ``quantize_dit_for_serving`` of the same float weights."""
    cfg = dict(input_size=4, in_channels=8, dim=128, depth=2, num_heads=2, num_classes=10)
    params = jdit.init_dit_params(jax.random.key(0), jdit.DiTConfig(**cfg))
    model = DiT(DiTConfig(**cfg), device="cpu")
    load_numpy_dit_params(model, jax.tree.map(np.asarray, params))
    want = quantize_dit_for_serving(model).state_dict()
    jtree = jq.quantize_matmul_params(params, exclude=lambda k: k in ("x_embed", "final"))
    loaded = quantize_dit_for_serving(DiT.init(DiTConfig(**cfg), device="cpu"))
    load_numpy_dit_params(loaded, jax.tree.map(np.asarray, jtree))
    got = loaded.state_dict()
    assert sorted(got) == sorted(want)
    assert "final.proj.weight" in got and "y_embed.weight" in got
    assert got["t_embed.fc1.weight.q"].dtype == torch.int8
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
