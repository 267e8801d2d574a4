"""The port's text intermediates (``models/text_encoder.py``
``feature_take_indices``, ``text_forward_intermediates``,
``prune_intermediate_layers``) against ``vtp_tpu.models.text_encoder`` on the
CPU, on a tiny tower whose JAX weights (every leaf moved off its init) are
carried across: every option of ``text_forward_intermediates``, with and
without ``embed_cls``, int, negative and list ``indices``, and pruning with
``prune_norm`` and ``prune_head``. Gates: fp32 5e-4 abs, bf16 5e-2 of
max|ref|. The causal tower without ``embed_cls`` takes the fused attention
(``fused_qkv_rope_attention``) at every layer; with ``embed_cls`` (a
masked tower) it takes none, as the JAX ``_text_block`` routes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtp_tpu.models import text_encoder as jte
from vtp_tpu_torch.models import text_encoder as te

torch.set_num_threads(1)
F32_ABS = 5e-4
BF16_REL = 5e-2
TINY = dict(context_length=10, vocab_size=50, width=64, heads=2, layers=3, output_dim=32,
            ls_init_value=0.5)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    limit = BF16_REL * np.abs(want).max() if dtype == "bf16" else F32_ABS
    assert err <= limit, (err, limit)


def _state_dict(p, cfg):
    """The JAX text tree in the port's parameter names."""
    sd = {"token_embedding.weight": p["token_embedding"],
          "positional_embedding": p["positional_embedding"],
          "ln_final.weight": p["ln_final"]["scale"], "ln_final.bias": p["ln_final"]["bias"]}
    if cfg.embed_cls:
        sd["cls_emb"] = p["cls_emb"]
    if "text_projection" in p:
        sd["text_projection"] = p["text_projection"]["kernel"]
    for i in range(cfg.layers):
        b = jax.tree.map(lambda a: a[i], p["blocks"])
        pre = f"text_transformer.resblocks.{i}."
        sd.update({pre + "ln_1.weight": b["ln_1"]["scale"], pre + "ln_1.bias": b["ln_1"]["bias"],
                   pre + "attn.in_proj_weight": b["attn"]["in_proj"]["kernel"].T,
                   pre + "attn.in_proj_bias": b["attn"]["in_proj"]["bias"],
                   pre + "attn.out_proj.weight": b["attn"]["out_proj"]["kernel"].T,
                   pre + "attn.out_proj.bias": b["attn"]["out_proj"]["bias"],
                   pre + "ln_2.weight": b["ln_2"]["scale"], pre + "ln_2.bias": b["ln_2"]["bias"],
                   pre + "mlp.c_fc.weight": b["mlp"]["c_fc"]["kernel"].T,
                   pre + "mlp.c_fc.bias": b["mlp"]["c_fc"]["bias"],
                   pre + "mlp.c_proj.weight": b["mlp"]["c_proj"]["kernel"].T,
                   pre + "mlp.c_proj.bias": b["mlp"]["c_proj"]["bias"],
                   pre + "ls_1.gamma": b["ls_1"]["gamma"], pre + "ls_2.gamma": b["ls_2"]["gamma"]})
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["causal", "embed_cls"])
def towers(request):
    """(JAX cfg, JAX params, port model) for a causal tower, without and
    with the appended cls token; every leaf perturbed so the norms and
    biases show."""
    kw = dict(TINY, embed_cls=request.param)
    jcfg = jte.TextConfig(**kw)
    params = jax.tree.map(np.asarray, jte.init_text_params(jax.random.key(3), jcfg))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                          params)
    model = te.TextTransformer(te.TextConfig(**kw))
    model.load_state_dict(_state_dict(params, jcfg))
    return jcfg, params, model


def _text(n=3, length=8, seed=5):
    """Token ids with a pad tail (0) after each row's largest (EOT) id."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 40, (n, length))
    for i, end in enumerate((length, length - 2, 3)[:n]):
        t[i, end - 1] = 49
        t[i, end:] = 0
    return t


@pytest.mark.parametrize("num_layers,indices,take", [
    (4, None, [0, 1, 2, 3]), (4, 2, [2, 3]), (4, [0, -1], [0, 3]), (4, (-2,), [2]),
    (12, 4, [8, 9, 10, 11])])
def test_feature_take_indices_matches_jax(num_layers, indices, take):
    assert te.feature_take_indices(num_layers, indices) == jte.feature_take_indices(
        num_layers, indices) == (take, max(take))


@pytest.mark.parametrize("indices", [None, 2, [0, -1]])
@pytest.mark.parametrize("normalize,only,extra", [(False, False, False), (True, False, True),
                                                  (False, True, True), (True, True, False)])
def test_text_forward_intermediates_matches_jax(towers, indices, normalize, only, extra):
    jcfg, params, model = towers
    text = _text()
    kw = dict(normalize_intermediates=normalize, intermediates_only=only,
              output_extra_tokens=extra)
    want = jte.text_forward_intermediates(params, jcfg, jnp.asarray(text), indices, **kw)
    got = te.text_forward_intermediates(model, torch.tensor(text), indices, **kw)
    assert sorted(got) == sorted(want)
    assert len(got["text_intermediates"]) == len(want["text_intermediates"])
    for g, w in zip(got["text_intermediates"], want["text_intermediates"]):
        _check(g, w, "fp32")
    for g, w in zip(got.get("text_intermediates_suffix", []),
                    want.get("text_intermediates_suffix", [])):
        _check(g, w, "fp32")
    if not only:
        _check(got["text_features"], want["text_features"], "fp32")


def test_text_forward_intermediates_bf16_matches_jax(towers, monkeypatch):
    jcfg, params, model = towers
    calls = []
    fused = te.fused_qkv_rope_attention
    monkeypatch.setattr(te, "fused_qkv_rope_attention",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    text = _text()
    want = jte.text_forward_intermediates(params, jcfg, jnp.asarray(text), 2,
                                          normalize_intermediates=True,
                                          output_extra_tokens=True, compute_dtype=jnp.bfloat16)
    got = te.text_forward_intermediates(model, torch.tensor(text), 2, normalize_intermediates=True,
                                        output_extra_tokens=True, compute_dtype=torch.bfloat16)
    for key in want:
        items = want[key] if isinstance(want[key], list) else [want[key]]
        gots = got[key] if isinstance(got[key], list) else [got[key]]
        for g, w in zip(gots, items):
            _check(g, w, "bf16")
    assert len(calls) == (0 if jcfg.embed_cls else jcfg.layers)


@pytest.mark.parametrize("indices", [1, [0], [-2]])
@pytest.mark.parametrize("prune_norm", [False, True])
@pytest.mark.parametrize("prune_head", [False, True])
def test_prune_intermediate_layers_matches_jax(towers, indices, prune_norm, prune_head):
    jcfg, params, model = towers
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jp, jc, jtake = jte.prune_intermediate_layers(params, jcfg, indices, prune_norm=prune_norm,
                                                  prune_head=prune_head)
    pruned, cfg, take = te.prune_intermediate_layers(model, indices, prune_norm=prune_norm,
                                                     prune_head=prune_head)
    assert take == jtake and cfg.layers == jc.layers == len(pruned.text_transformer.resblocks)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc) and pruned.cfg is cfg
    assert (pruned.text_projection is None) == ("text_projection" not in jp)
    text = _text()
    _check(pruned(torch.tensor(text)), jte.text_encode(jp, jc, jnp.asarray(text)), "fp32")
    want = jte.text_forward_intermediates(jp, jc, jnp.asarray(text), indices,
                                          normalize_intermediates=True)
    got = te.text_forward_intermediates(pruned, torch.tensor(text), indices,
                                        normalize_intermediates=True)
    for g, w in zip(got["text_intermediates"], want["text_intermediates"]):
        _check(g, w, "fp32")
    # the model it was pruned from is as it was
    assert model.cfg.layers == jcfg.layers and model.text_projection is not None
    after = model.state_dict()
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
