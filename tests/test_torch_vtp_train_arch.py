"""The VTP training facade (``models/vtp_train_arch.py``) against the JAX
package's ``VTP`` on the same weights (drop-path off), and the DINO head
without weight norm against the JAX head.

Gates (ROADMAP): fp32 outputs within 5e-4 abs, bf16 within 5e-2 of
max|ref|; the EMA teacher within 5e-4 abs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models.dino_head import DinoHeadConfig as JaxHeadConfig
from vtp_tpu.models.dino_head import dino_head_forward, init_dino_head_params
from vtp_tpu.models.vtp_train_arch import VTP as JaxVTP
from vtp_tpu.train.step import TrainConfig as JaxTrainConfig
from vtp_tpu.train.step import init_train_params
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.models.dino_head import DinoHead, DinoHeadConfig, head_state_dict
from vtp_tpu_torch.models.vtp_train_arch import VTP
from vtp_tpu_torch.train.step import TrainConfig

torch.set_num_threads(1)
F32_ABS, BF16_REL = 5e-4, 5e-2
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
            text_vocab_size=64, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
TRAIN = dict(dino_out_dim=32, dino_hidden_dim=16, dino_bottleneck_dim=8, total_steps=10)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= (F32_ABS if dtype == "fp32" else BF16_REL * np.abs(want).max()), err


def _load(model, head, params, jcfg):
    model.load_numpy_state_dict(
        export_state_dict({k: v for k, v in params.items() if k != "dino_head"}, jcfg))
    head.load_state_dict(head_state_dict(jax.tree.map(np.asarray, params["dino_head"])))


@pytest.fixture(scope="module")
def jax_params():
    jcfg = JaxConfig(**TINY)
    return jax.jit(lambda k: init_train_params(k, jcfg, JaxTrainConfig(**TRAIN)))(
        jax.random.key(0))


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def pair(request, jax_params):
    dtype = request.param
    jcfg = JaxConfig(**TINY)
    jvtp = JaxVTP(jcfg, JaxTrainConfig(**TRAIN), params=jax_params,
                  compute_dtype=None if dtype == "fp32" else jnp.bfloat16)
    cfg, tcfg = VTPConfig(**TINY), TrainConfig(**TRAIN)
    from vtp_tpu_torch.train.step import dino_head_config

    model, head = VTPModel(cfg, device="cpu"), DinoHead(dino_head_config(cfg, tcfg))
    _load(model, head, jvtp.params, jcfg)
    vtp = VTP(cfg, tcfg, model=model, dino_head=head,
              compute_dtype=None if dtype == "fp32" else torch.bfloat16)
    return dtype, jcfg, jvtp, vtp


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    n_tok, upper, n_masked = 4 * 4, 8, 4
    perm = rng.permutation(n_tok)
    idx = np.zeros(upper, np.int64)
    idx[:n_masked] = perm[:n_masked]
    masks = np.zeros(n_tok, bool)
    masks[perm[:n_masked]] = True
    return dict(image=rng.standard_normal((2, 3, 32, 32)).astype(np.float32),
                text=rng.integers(1, 60, (3, 8)),
                ssl=dict(global_crops=rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
                         local_crops=rng.standard_normal((4, 3, 16, 16)).astype(np.float32),
                         masks=masks.reshape(4, 4), mask_indices=idx,
                         mask_weight=(np.arange(upper) < n_masked).astype(np.float32),
                         n_global_crops=2))


def _jax_ssl(ssl):
    return {k: (jnp.asarray(v, jnp.int32) if k == "mask_indices" else
                v if k == "n_global_crops" else jnp.asarray(v)) for k, v in ssl.items()}


def _port_ssl(ssl):
    return {k: (torch.tensor(v).long() if k == "mask_indices" else
                v if k == "n_global_crops" else torch.tensor(v)) for k, v in ssl.items()}


def test_clip_outputs_match_jax(pair, data):
    dtype, _, jvtp, vtp = pair
    img, txt = data["image"], data["text"]
    with torch.no_grad():
        out = vtp(image=torch.tensor(img), text=torch.tensor(txt).long(), forward_type="clip")
        raw = vtp.encode_image(torch.tensor(img))
        logits = vtp.get_logits(torch.tensor(img), torch.tensor(txt).long())
    jout = jvtp(image=jnp.asarray(img), text=jnp.asarray(txt, jnp.int32), forward_type="clip")
    for k in ("image_features", "text_features", "logit_scale"):
        _check(out[k], jout[k], dtype)
    _check(raw, jvtp.encode_image(jnp.asarray(img)), dtype)
    jlogits = jvtp.get_logits(jnp.asarray(img), jnp.asarray(txt, jnp.int32))
    for g, w in zip(logits, jlogits):
        assert g.shape == (2, 3) or g.shape == (3, 2)
        err = np.abs(_np(g) - _np(w)).max()
        assert err <= (F32_ABS if dtype == "fp32" else BF16_REL) * max(1.0, np.abs(_np(w)).max())


def test_rec_outputs_match_jax(pair, data):
    dtype, _, jvtp, vtp = pair
    with torch.no_grad():
        out = vtp(reconstruction_image=torch.tensor(data["image"]), forward_type="rec")
    jout = jvtp(reconstruction_image=jnp.asarray(data["image"]), forward_type="rec")
    _check(out["reconstructed_image"], jout["reconstructed_image"], dtype)
    assert torch.equal(out["target_image"], torch.tensor(data["image"]))


def test_ssl_outputs_match_jax(pair, data):
    dtype, _, jvtp, vtp = pair
    with torch.no_grad():
        teacher, student = vtp(ssl_dict=_port_ssl(data["ssl"]), forward_type="ssl")
    jteacher, jstudent = jvtp(ssl_dict=_jax_ssl(data["ssl"]), forward_type="ssl")
    assert set(teacher) == set(jteacher) and set(student) == set(jstudent)
    for got, want in ((teacher, jteacher), (student, jstudent)):
        for k in want:
            _check(got[k], want[k], dtype)


def test_update_teacher_matches_jax(pair):
    """The student nudged, then one EMA step at momentum 0.9; run last on
    each pair, since it moves the student."""
    dtype, jcfg, jvtp, vtp = pair
    jvtp.params = jax.tree.map(lambda a: a + 0.01 if a.dtype == jnp.float32 else a, jvtp.params)
    _load(vtp.model, vtp.dino_head, jvtp.params, jcfg)
    jvtp.update_teacher(0.9)
    vtp.update_teacher(0.9)
    want = export_state_dict({k: v for k, v in jvtp.teacher.items() if k != "dino_head"}, jcfg)
    for name, t in vtp.teacher["trunk"].state_dict().items():
        assert np.abs(_np(t) - want[f"trunk.{name}"]).max() <= F32_ABS, name
    whead = head_state_dict(jax.tree.map(np.asarray, jvtp.teacher["dino_head"]))
    for name, t in vtp.teacher["dino_head"].state_dict().items():
        assert np.abs(_np(t) - whead[name].numpy()).max() <= F32_ABS, name


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nlayers", [1, 3])
def test_dino_head_without_weight_norm_matches_jax(dtype, nlayers):
    kw = dict(in_dim=24, out_dim=96, nlayers=nlayers, hidden_dim=32, bottleneck_dim=16,
              use_weight_norm=False)
    params = init_dino_head_params(jax.random.key(3), JaxHeadConfig(**kw))
    assert "kernel" in params["last_layer"]
    head = DinoHead(DinoHeadConfig(**kw))
    head.load_state_dict(head_state_dict(jax.tree.map(np.asarray, params)))
    assert isinstance(head.last_layer, torch.nn.Linear) and head.last_layer.bias is None
    x = np.random.default_rng(4).standard_normal((5, 24)).astype(np.float32)
    x[2] = 0.0  # a zero row: the zero-safe normalize's case
    jdt, tdt = (None, None) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    for zero_safe in (False, True):
        with torch.no_grad():
            got = head(torch.tensor(x), compute_dtype=tdt, zero_safe_normalize=zero_safe)
        want = dino_head_forward(params, JaxHeadConfig(**kw), jnp.asarray(x), compute_dtype=jdt,
                                 zero_safe_normalize=zero_safe)
        _check(got, want, dtype)
    fresh = DinoHead(DinoHeadConfig(**kw))
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    assert float(fresh.last_layer.weight.detach().std()) == pytest.approx(0.02, rel=0.3)
