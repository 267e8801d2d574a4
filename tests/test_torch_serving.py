"""The port's serving path on the CPU: the feature API and ``forward``
against the JAX ``VTPModel``, HF-layout checkpoints in both directions
between the two packages (the port reads and writes the ``.safetensors``
bytes itself), and ``VTPServer`` (coalesced results equal direct calls,
mixed kinds, kind contention, shutdown failing pending futures, every
model call on the dispatcher thread). Weights go across with
``export_state_dict``; fp32 within 5e-4 abs, bf16 within 5e-2 of
max|ref| (the JAX package's gates)."""

import functools
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.from_torch import load_vtp_checkpoint as jax_load_checkpoint
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.convert.to_torch import save_hf_checkpoint as jax_save_checkpoint
from vtp_tpu.models.vit import vit_get_intermediate_layers
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.models.vtp_model import vit_config_from
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.convert import (
    load_safetensors,
    load_vtp_checkpoint,
    save_hf_checkpoint,
    save_safetensors,
)
from vtp_tpu_torch.models.vtp_model import checkpoint_name, model_name
from vtp_tpu_torch.serve import VTPServer, _Request

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=2, vision_feature_bottleneck=16, text_context_length=8,
            text_vocab_size=64, text_embed_dim=64, text_num_heads=2, text_depth=2,
            decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
# storage tokens and untied cls/patch norms, for the intermediate layers' norms
VARIANT = dict(TINY, train_clip=False, vision_n_storage_tokens=2,
               vision_untie_cls_and_patch_norms=True, vision_depth=3)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, gate="fp32"):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    if gate == "bf16":
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())
    else:
        assert err <= F32_ABS, err


def _pair(overrides, seed=0, **kw):
    jc = JaxConfig(**overrides)
    jm = JaxModel.init(jax.random.key(seed), jc, **kw)
    tm = VTPModel(VTPConfig(**overrides), device="cpu", **kw)
    tm.load_numpy_state_dict(export_state_dict(jm.params, jc))
    return jm, tm


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair(TINY, encode_dtype=None)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)


# -------------------------------------------------------------- feature API


@pytest.mark.parametrize("use_bottleneck", [False, True])
def test_last_layer_feature_matches_jax(fp32_pair, images, use_bottleneck):
    jm, tm = fp32_pair
    want = jm.get_last_layer_feature(jnp.asarray(images), use_bottleneck=use_bottleneck)
    got = tm.get_last_layer_feature(torch.tensor(images), use_bottleneck=use_bottleneck)
    assert set(got) == set(want) == {"cls_token", "patch_tokens"}
    for key in got:
        _check(got[key], want[key])


def test_last_layer_feature_in_bf16_matches_jax(images):
    jm, tm = _pair(TINY, seed=1)
    want = jm.get_last_layer_feature(jnp.asarray(images))
    got = tm.get_last_layer_feature(torch.tensor(images))
    for key in got:
        _check(got[key], want[key], "bf16")


@pytest.mark.parametrize("n,reshape,cls,norm", [(1, False, False, True), (2, True, True, True),
                                                ((0, 1), False, True, False)])
def test_intermediate_layers_feature_matches_jax(fp32_pair, images, n, reshape, cls, norm):
    jm, tm = fp32_pair
    want = jm.get_intermediate_layers_feature(jnp.asarray(images), n=n, reshape=reshape,
                                              return_class_token=cls, norm=norm)
    got = tm.get_intermediate_layers_feature(torch.tensor(images), n=n, reshape=reshape,
                                             return_class_token=cls, norm=norm)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w) if cls else [(g, w)]:
            _check(a, b)


def test_intermediate_layers_with_storage_tokens_and_untied_norms_match_jax(images):
    jm, tm = _pair(VARIANT, seed=2)
    for n in (2, (1,)):
        fn = jax.jit(functools.partial(vit_get_intermediate_layers, cfg=vit_config_from(jm.config),
                                       n=n, return_class_token=True, return_extra_tokens=True))
        want = fn(jm.params["trunk"], images=jnp.asarray(images))
        got = tm.trunk.get_intermediate_layers(torch.tensor(images), n, return_class_token=True,
                                               return_extra_tokens=True)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert len(g) == 3
            for a, b in zip(g, w):
                _check(a, b)


@pytest.mark.parametrize("forward_type", ["clip", "rec", "feature"])
def test_forward_matches_jax(fp32_pair, images, forward_type):
    jm, tm = fp32_pair
    text = np.random.default_rng(3).integers(1, 60, (2, 8))
    kw = dict(image=images, forward_type=forward_type)
    if forward_type == "clip":
        kw["text"] = text
    want = jm(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    got = tm(**{k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    assert set(got) == set(want)
    for key in got:
        _check(got[key], want[key])


def test_forward_refuses_an_unknown_type(fp32_pair, images):
    with pytest.raises(ValueError, match="forward_type"):
        fp32_pair[1](torch.tensor(images), forward_type="pixels")


# -------------------------------------------------------------- checkpoints


def test_jax_checkpoint_loads_into_the_port(tmp_path, images):
    jc = JaxConfig(**TINY)
    jm = JaxModel.init(jax.random.key(4), jc, encode_dtype=None)
    jax_save_checkpoint(str(tmp_path), jm.params, jc)
    tm = VTPModel.from_checkpoint(str(tmp_path), device="cpu", encode_dtype=None,
                                  decode_precision="high")
    assert tm.config == VTPConfig(**TINY) and tm.decode_precision == "high"
    sd = export_state_dict(jm.params, jc)
    own = tm.state_dict()
    for key, value in sd.items():
        np.testing.assert_array_equal(own[model_name(key)].float().numpy(), value, err_msg=key)
    _check(tm.get_reconstruction_latents(torch.tensor(images)),
           jm.get_reconstruction_latents(jnp.asarray(images)))


def test_port_checkpoint_loads_into_jax(tmp_path):
    cfg = VTPConfig(**VARIANT)
    tm = VTPModel.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    save_hf_checkpoint(str(tmp_path), tm)
    with open(tmp_path / "config.json") as f:
        written = json.load(f)
    assert written["model_type"] == "vtp" and written["vision_qkv_head_major"] == 1
    jc, params = jax_load_checkpoint(str(tmp_path))
    assert jc == JaxConfig(**VARIANT)
    back = export_state_dict(params, jc)
    own = {checkpoint_name(k): v.float().numpy() for k, v in tm.state_dict().items()}
    assert sorted(back) == sorted(own)
    for key in own:
        np.testing.assert_array_equal(back[key], own[key], err_msg=key)


def test_port_checkpoint_roundtrips_bit_for_bit(tmp_path):
    cfg = VTPConfig(**TINY)
    tm = VTPModel.init(cfg, torch.Generator().manual_seed(6), device="cpu")
    save_hf_checkpoint(str(tmp_path), tm)
    back = VTPModel.from_checkpoint(str(tmp_path), device="cpu")
    for (name, a), b in zip(tm.state_dict().items(), back.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_prefixed_keys_and_several_files_load(tmp_path):
    from safetensors.numpy import save_file

    jc = JaxConfig(**TINY)
    sd = export_state_dict(JaxModel.init(jax.random.key(7), jc).params, jc)
    keys = sorted(sd)
    save_file({f"vtp.{k}": sd[k] for k in keys[::2]}, str(tmp_path / "a.safetensors"))
    save_file({f"vtp.{k}": sd[k] for k in keys[1::2]}, str(tmp_path / "b.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "vtp", **jc.to_dict()}, f)
    cfg, loaded = load_vtp_checkpoint(str(tmp_path))
    assert cfg == VTPConfig(**TINY) and sorted(loaded) == keys
    for k in keys:
        np.testing.assert_array_equal(loaded[k], sd[k])


def test_safetensors_reader_takes_bf16_f16_and_f32_from_the_package(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(8)
    tensors = {"bf16": torch.randn(3, 5, generator=g).bfloat16(),
               "f16": torch.randn(7, generator=g).half(),
               "f32": torch.randn(2, 2, 2, generator=g), "scalar": torch.tensor(1.5)}
    save_file(tensors, str(tmp_path / "m.safetensors"), metadata={"format": "pt"})
    got = load_safetensors(str(tmp_path / "m.safetensors"))
    assert got["bf16"].dtype == np.float32 and got["f16"].dtype == np.float16
    for name, t in tensors.items():
        assert got[name].shape == tuple(t.shape)
        np.testing.assert_array_equal(got[name], t.float().numpy().astype(got[name].dtype))


def test_safetensors_writer_is_read_by_the_package(tmp_path):
    from safetensors.numpy import load_file

    rng = np.random.default_rng(9)
    tensors = {"w": rng.standard_normal((4, 3)).astype(np.float32),
               "h": rng.standard_normal(5).astype(np.float16),
               "scale": np.array(2.5, np.float32),
               "strided": rng.standard_normal((6, 4)).astype(np.float32)[:, ::2]}
    save_safetensors(str(tmp_path / "m.safetensors"), tensors, metadata={"format": "np"})
    got = load_file(str(tmp_path / "m.safetensors"))
    assert sorted(got) == sorted(tensors)
    for name, value in tensors.items():
        assert got[name].dtype == value.dtype and got[name].shape == value.shape
        np.testing.assert_array_equal(got[name], value)
    with pytest.raises(TypeError):
        save_safetensors(str(tmp_path / "bad.safetensors"), {"f64": np.arange(3.0)})


# -------------------------------------------------------------------- server


@pytest.fixture(scope="module")
def server():
    model = VTPModel.init(VTPConfig(**TINY), torch.Generator().manual_seed(0), device="cpu",
                          encode_dtype=None)
    srv = VTPServer(model, batch_size=4, max_wait_ms=20)
    yield srv
    srv.shutdown()


def test_batched_encode_roundtrip(server):
    rng = np.random.default_rng(10)
    imgs = [rng.standard_normal((n, 3, 32, 32)).astype(np.float32) for n in (1, 3, 2, 6)]
    futs = [server.submit_encode(x) for x in imgs]
    outs = [f.result(timeout=120) for f in futs]
    for x, z in zip(imgs, outs):
        assert z.shape == (x.shape[0], 16, 2, 2) and z.device.type == "cpu"
    # coalesced (and, for 6 rows, chunked) results equal direct calls
    for x, z in zip(imgs, outs):
        direct = server.model.get_reconstruction_latents(torch.tensor(x))
        torch.testing.assert_close(z, direct, atol=1e-5, rtol=0)
    dec = server.submit_decode(outs[0]).result(timeout=120)
    assert dec.shape == (1, 3, 32, 32) and dec.dtype == torch.float32


def test_mixed_kinds(server):
    rng = np.random.default_rng(11)
    img = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    tok = rng.integers(1, 60, (2, 8))
    f1 = server.submit_clip_image(img)
    f2 = server.submit_clip_text(torch.tensor(tok))
    assert f1.result(timeout=120).shape == (2, 64)
    assert f2.result(timeout=120).shape == (2, 64)
    with pytest.raises(ValueError, match="unknown request kind"):
        server.submit("pixels", img)


def test_served_encode_matches_jax():
    jm, tm = _pair(TINY, seed=12, encode_dtype=None)
    srv = VTPServer(tm, batch_size=4, max_wait_ms=5, warmup=False)
    try:
        img = np.random.default_rng(13).standard_normal((3, 3, 32, 32)).astype(np.float32)
        got = srv.submit_encode(img).result(timeout=120)
    finally:
        srv.shutdown()
    _check(got, jm.get_reconstruction_latents(jnp.asarray(img)))


def test_mixed_kind_contention():
    """Under sustained mixed load every kind completes (no starvation), per
    kind in order, and results match direct calls."""
    model = VTPModel.init(VTPConfig(**TINY), torch.Generator().manual_seed(1), device="cpu",
                          encode_dtype=None, decode_precision="high")
    srv = VTPServer(model, batch_size=4, max_wait_ms=5, warmup=False)
    rng = np.random.default_rng(14)
    try:
        imgs = [rng.standard_normal((1, 3, 32, 32)).astype(np.float32) for _ in range(6)]
        lats = [rng.standard_normal((1, 16, 2, 2)).astype(np.float32) for _ in range(6)]
        futs = []
        for i in range(6):  # interleave kinds
            futs.append(("encode", i, srv.submit_encode(imgs[i])))
            futs.append(("decode", i, srv.submit_decode(lats[i])))
        outs = [(kind, i, f.result(timeout=120)) for kind, i, f in futs]
    finally:
        srv.shutdown()
    for kind, i, out in outs:
        if kind == "encode":
            want = model.get_reconstruction_latents(torch.tensor(imgs[i]))
        else:
            want = model.get_latents_decoded_images(torch.tensor(lats[i]))
        torch.testing.assert_close(out, want, atol=1e-5, rtol=0, msg=f"{kind} {i}")


def test_a_failing_batch_fails_its_futures_and_the_server_goes_on():
    model = VTPModel.init(VTPConfig(**TINY), torch.Generator().manual_seed(2), device="cpu")
    srv = VTPServer(model, batch_size=4, max_wait_ms=5, warmup=False)
    try:
        bad = srv.submit_encode(np.zeros((1, 3, 32), np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=120)
        ok = srv.submit_encode(np.zeros((1, 3, 32, 32), np.float32)).result(timeout=120)
        assert ok.shape == (1, 16, 2, 2)
    finally:
        srv.shutdown()


def test_every_model_call_runs_on_the_dispatcher_thread():
    """The exact-fp32 decode flips the process-wide TF32 flags, so the
    server makes every model call, the warm-up's too, on its own thread."""
    model = VTPModel.init(VTPConfig(**TINY), torch.Generator().manual_seed(3), device="cpu")
    threads = []
    for name in ("get_reconstruction_latents", "get_latents_decoded_images",
                 "get_clip_image_feature", "get_clip_text_feature"):
        fn = getattr(model, name)

        def recorded(*a, _fn=fn, **k):
            threads.append(threading.current_thread())
            return _fn(*a, **k)

        setattr(model, name, recorded)
    srv = VTPServer(model, batch_size=4, max_wait_ms=5)
    try:
        rng = np.random.default_rng(15)
        srv.submit_clip_image(rng.standard_normal((1, 3, 32, 32)).astype(np.float32)).result(120)
        srv.submit_clip_text(rng.integers(1, 60, (2, 8))).result(120)
        srv.submit_decode(rng.standard_normal((5, 16, 2, 2)).astype(np.float32)).result(120)
    finally:
        srv.shutdown()
    assert len(threads) == 2 + 4  # the warm-up's encode and decode, then 1 + 1 + 2 chunks
    assert set(threads) == {srv._thread}
    assert srv.calls == {"encode": 0, "decode": 2, "clip_image": 1, "clip_text": 1}


def test_shutdown_fails_pending_futures():
    """shutdown() fails queued-but-unprocessed futures instead of leaving
    them pending; later submits fail at once."""
    model = VTPModel.init(VTPConfig(**TINY), torch.Generator().manual_seed(4), device="cpu")
    srv = VTPServer(model, batch_size=4, max_wait_ms=5, warmup=False)
    # park the dispatcher, then queue a request by hand so that it is
    # pending when shutdown() runs
    srv._stop.set()
    srv._thread.join(timeout=30)
    req = _Request("encode", torch.zeros(1, 3, 32, 32))
    with srv._cv:
        srv._queues["encode"].append(req)
    srv.shutdown()
    with pytest.raises(RuntimeError):
        req.future.result(timeout=5)
    with pytest.raises(RuntimeError):
        srv.submit_encode(np.zeros((1, 3, 32, 32), np.float32)).result(timeout=5)


def test_parallel_serving_and_int8_raise():
    """A ``mesh=`` that is not a DeviceMesh raises (a mesh serves: over four
    ranks in tests/test_torch_parallel_serve.py); ``tp_head_major`` without a
    mesh is ignored, as the JAX server ignores it. The int8 serving tier
    (tests/test_torch_quantized_models.py) does not raise, and a server takes
    its model."""
    model = VTPModel.init(VTPConfig(**TINY), torch.Generator().manual_seed(5), device="cpu")
    with pytest.raises(TypeError):
        VTPServer(model, warmup=False, mesh=object())
    srv = VTPServer(model, batch_size=2, warmup=False, tp_head_major=True)
    try:
        got = srv.submit_encode(np.zeros((1, 3, 32, 32), np.float32)).result(timeout=120)
    finally:
        srv.shutdown()
    assert model.config.vision_qkv_head_major == 1
    with torch.no_grad():
        want = model.get_reconstruction_latents(torch.zeros((1, 3, 32, 32)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    srv = VTPServer(model.quantize_for_serving(), batch_size=2, warmup=False)
    try:
        z = srv.submit_encode(np.zeros((1, 3, 32, 32), np.float32)).result(timeout=120)
        assert tuple(z.shape) == (1, 16, 2, 2)
    finally:
        srv.shutdown()


def test_warmup_errors_reach_the_caller():
    model = VTPModel.init(VTPConfig(**TINY), torch.Generator().manual_seed(6), device="cpu")

    def broken(x):
        raise RuntimeError("no encode today")

    model.get_reconstruction_latents = broken
    with pytest.raises(RuntimeError, match="no encode today"):
        VTPServer(model, batch_size=2)


def test_checkpoint_files_are_plain_safetensors(tmp_path):
    tm = VTPModel.init(VTPConfig(**TINY), torch.Generator().manual_seed(7), device="cpu")
    save_hf_checkpoint(str(tmp_path), tm)
    assert sorted(os.listdir(tmp_path)) == ["config.json", "model.safetensors"]
    with open(tmp_path / "model.safetensors", "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    assert n % 8 == 0 and all(v["dtype"] == "F32" for v in header.values())
