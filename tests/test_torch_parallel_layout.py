"""The port's parallel layouts against the JAX package's: the Megatron
partition rules (``param_partition_specs``), the FSDP shape rules
(``fsdp_partition_specs``, ``fsdp_state_specs``) and ``sharded_bytes`` on
the JAX train state itself, exactly; and each rank's ``shard_state_dict``
slabs on a (2, 2) mesh of four CPU gloo ranks bit for bit equal to the
shards ``vtp_tpu.parallel.sharding.shard_params`` puts on the four devices
of a JAX (2, 2) mesh (read per device through ``addressable_shards``). A
head-major trunk's qkv slab is its contiguous shard; a canonical qkv's
(the trunk's, the decoder's, the text ``in_proj``) equals JAX's shard of
the same weights after the head-major permutation. The JAX weights reach
the port through ``vtp_tpu.convert.to_torch.export_state_dict``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.torch_dist import run_ranks
from tests.torch_parallel_workers import shard_slabs
from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.models.vtp_model import init_vtp_params
from vtp_tpu.parallel import fsdp as jfsdp
from vtp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vtp_tpu.parallel.sharding import param_partition_specs as jax_param_specs
from vtp_tpu.parallel.sharding import qkv_head_major as jax_qkv_head_major
from vtp_tpu.parallel.sharding import shard_params
from vtp_tpu.train.step import TrainConfig as JaxTrainConfig
from vtp_tpu.train.step import init_state as jax_init_state
from vtp_tpu_torch.models.vtp_model import model_name
from vtp_tpu_torch.parallel import fsdp
from vtp_tpu_torch.parallel.sharding import leaf_spec

CFG = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
           vision_num_heads=4, vision_feature_bottleneck=16, text_context_length=8,
           text_vocab_size=128, text_embed_dim=64, text_num_heads=4, text_depth=2,
           decoder_embed_dim=64, decoder_num_heads=4, decoder_depth=2)
TRAIN = dict(dino_out_dim=256, dino_hidden_dim=32, dino_bottleneck_dim=16)
IS_SPEC = lambda x: isinstance(x, jax.sharding.PartitionSpec)


def _port_sd(params, cfg):
    return {model_name(k): np.asarray(v) for k, v in export_state_dict(params, cfg).items()}


def _label_tree(params):
    """Each leaf replaced by its index along the dim JAX puts on ``model``
    (zeros where none), so that the export shows where that dim lands."""
    specs = jax_param_specs(params)

    def label(leaf, spec):
        shape = np.shape(leaf)
        dims = [i for i, s in enumerate(spec) if s == "model"]
        if not dims:
            return np.zeros(shape, np.float32)
        d = dims[0]
        idx = np.arange(shape[d], dtype=np.float32).reshape([-1 if i == d else 1
                                                             for i in range(len(shape))])
        return np.broadcast_to(idx, shape).astype(np.float32)

    return jax.tree.map(label, params, specs, is_leaf=lambda x: IS_SPEC(x))


@pytest.mark.parametrize("head_major", [1, 2], ids=["canonical", "head_major"])
def test_param_partition_specs_match_jax(head_major):
    jcfg = JaxConfig(**dict(CFG, vision_qkv_head_major=head_major))
    params = init_vtp_params(jax.random.key(0), jcfg)
    labels = _port_sd(_label_tree(params), dataclasses.replace(jcfg, vision_qkv_head_major=1))
    n_sharded = 0
    for name, lab in labels.items():
        # the dims along which JAX's model-axis index varies, in torch layout
        varying = [d for d in range(lab.ndim) if lab.shape[d] > 1 and
                   np.ptp(lab, axis=d).max() > 0]
        want = tuple("model" if d in varying else None for d in range(lab.ndim))
        assert leaf_spec(name, lab.ndim) == want, name
        n_sharded += bool(varying)
    # qkv, proj, w1, w2, w3 and the qkv/w1/w2 biases of trunk and decoder
    # blocks; in_proj (weight, bias), out_proj, c_fc (weight, bias), c_proj
    # of the text blocks; the token embedding
    assert n_sharded == 2 * 2 * 8 + 2 * 6 + 1


def test_fsdp_specs_and_sharded_bytes_match_jax():
    jcfg, jtcfg = JaxConfig(**CFG), JaxTrainConfig(**TRAIN)
    state = jax_init_state(jax.random.key(0), jcfg, jtcfg)
    for n in (2, 4, 8):
        for min_elems in (256, jfsdp.DEFAULT_MIN_ELEMS):
            want = jfsdp.fsdp_state_specs(state, n, min_elems=min_elems)
            got = fsdp.fsdp_state_specs(state, n, min_elems=min_elems)
            flat_w = jax.tree_util.tree_flatten_with_path(want, is_leaf=IS_SPEC)[0]
            flat_g = dict(jax.tree_util.tree_flatten_with_path(
                got, is_leaf=lambda x: isinstance(x, tuple) and not hasattr(x, "_fields")
                and all(e is None or isinstance(e, str) for e in x))[0])
            assert len(flat_w) == len(flat_g)
            for path, spec in flat_w:
                assert flat_g[path] == tuple(spec) + (None,) * (
                    len(flat_g[path]) - len(tuple(spec))), path
            mesh = jax_make_mesh(n, 1, devices=jax.devices()[:n])
            assert fsdp.sharded_bytes(state, got, {"data": n}) == \
                jfsdp.sharded_bytes(state, want, mesh)
    # the shape rule itself, on the tie and the divisibility cases
    for shape, n in (((64, 64), 2), ((3, 96, 5), 4), ((7, 9), 2), ((4096, 24), 8)):
        assert fsdp._add_data_axis((None,) * len(shape), shape, n, 1) == tuple(
            jfsdp._add_data_axis(jax.sharding.PartitionSpec(*((None,) * len(shape))), shape,
                                 n, 1))


_OWNERS = {"qkv", "w1", "w2", "fc1", "c_fc", "in_proj", "proj", "w3", "fc2", "c_proj",
           "out_proj"}


def _jax_view(flat):
    """A flat port tree (leaves by port name, torch layout) as a nested tree
    under JAX's leaf names, of ``jax.ShapeDtypeStruct``s: a 2-D weight of a
    column or row owner (the text ``in_proj`` included) becomes its owner's
    ``kernel`` in JAX's (in, out) layout, the token embedding JAX's
    ``token_embedding`` leaf, and every other leaf keeps its path and layout.
    Returns the view and each port name's JAX path and whether it was
    transposed."""
    import jax.numpy as jnp

    view, where = {}, {}
    for name, t in flat.items():
        parts = name.split(".")
        shape, flip = tuple(t.shape), False
        if parts[-1] in ("in_proj_weight", "in_proj_bias"):
            parts = parts[:-1] + ["in_proj", parts[-1][len("in_proj_"):]]
        if parts[-2:] == ["token_embedding", "weight"]:
            parts = parts[:-1]
        elif parts[-1] == "weight" and len(shape) == 2 and parts[-2] in _OWNERS:
            parts, shape, flip = parts[:-1] + ["kernel"], shape[::-1], True
        node = view
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        dtype = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
        node[parts[-1]] = jax.ShapeDtypeStruct(shape, dtype)
        where[name] = (tuple(parts), flip)
    return view, where


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tuple(tree)


def _state_view(tree):
    parts = {k: _jax_view(tree[k]) for k in ("params", "teacher")}
    parts["opt_state"] = {m: _jax_view(tree["opt_state"][m]) for m in ("mu", "nu")}
    view = {"params": parts["params"][0], "teacher": parts["teacher"][0],
            "opt_state": {m: v[0] for m, v in parts["opt_state"].items()},
            "centers": {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                        for k, v in tree["centers"].items()}}
    return view, parts


def _meta_tree(cfg, train_kw):
    from vtp_tpu_torch.tools.fsdp_plan import meta_train_state
    from vtp_tpu_torch.train.step import TrainConfig

    return fsdp.train_state_tree(meta_train_state(cfg, TrainConfig(**train_kw)))


def test_fsdp_tensor_parallel_specs_match_jax():
    """``fsdp_state_specs(..., tensor_parallel=True)`` on the port's tree
    (port names, torch layout) against JAX's on the same tree under JAX's
    names: the parameters' and the teacher's specs dim for dim (a kernel's
    transposed), the moments' axes leaf for leaf (a square kernel's tie
    breaks on another dim in the other layout), and ``sharded_bytes`` at
    (2, 2) equal, with the data axis on a dim other than the model's."""
    from vtp_tpu_torch.config import VTPConfig

    tree = _meta_tree(VTPConfig(**CFG), TRAIN)
    view, parts = _state_view(tree)
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    n_both = 0
    for min_elems in (256, jfsdp.DEFAULT_MIN_ELEMS):
        got = fsdp.fsdp_state_specs(tree, 2, tensor_parallel=True, min_elems=min_elems)
        want = jfsdp.fsdp_state_specs(view, 2, tensor_parallel=True, min_elems=min_elems)
        for key in ("params", "teacher"):
            for name, (path, flip) in parts[key][1].items():
                w = _at(want[key], path)
                w = w + (None,) * (len(got[key][name]) - len(w))
                assert got[key][name] == (w[::-1] if flip else w), (key, name)
                n_both += {"data", "model"} <= set(got[key][name])
        for m in ("mu", "nu"):
            for name, (path, _) in parts["opt_state"][m][1].items():
                assert sorted(a for a in got["opt_state"][m][name] if a) == \
                    sorted(a for a in _at(want["opt_state"][m], path) if a), name
        assert fsdp.sharded_bytes(tree, got, {"data": 2, "model": 2}) == \
            jfsdp.sharded_bytes(view, want, mesh)
    assert n_both > 0


def test_fsdp_plan_vtp_large_matches_jax_sharded_bytes():
    """``tools/fsdp_plan.py``'s VTP-L figures at data 2 / 4 / 8 (host
    arithmetic on the meta-device state): both columns equal JAX's
    ``sharded_bytes`` of its own ``fsdp_state_specs`` on the same tree."""
    from vtp_tpu_torch.tools import fsdp_plan

    rows = fsdp_plan.plan("vtp-large", [2, 4, 8], 65536, "fp32")
    from vtp_tpu_torch.config import vtp_large

    view, _ = _state_view(_meta_tree(vtp_large(), {"dino_out_dim": 65536}))
    for n in (2, 4, 8):
        mesh = jax_make_mesh(n, 1, devices=jax.devices()[:n])
        want = jfsdp.sharded_bytes(view, jfsdp.fsdp_state_specs(view, n), mesh)
        assert rows["jax_rule"][f"data={n}"] == rows["port"][f"data={n}"] == want, n
    assert rows["jax_rule"]["data=2"] < rows["replicated_bytes"]


@pytest.fixture(scope="module")
def slabs(tmp_path_factory):
    """Each rank's port slabs and each device's JAX shards, by port name."""
    out = {}
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    for hm in (1, 2):
        jcfg = JaxConfig(**dict(CFG, vision_qkv_head_major=hm))
        params = init_vtp_params(jax.random.key(0), jcfg)
        local_cfg = dataclasses.replace(jcfg, vision_qkv_head_major=1)
        # the port's state dict in the stored layout (head-major for hm = 2)
        port = run_ranks(shard_slabs, 4, tmp_path_factory.mktemp(f"slabs{hm}"),
                         dict(CFG, vision_qkv_head_major=hm), _port_sd(params, local_cfg))
        # JAX: the same weights with every qkv in the head-major order, sharded
        hm_params = jax.tree.map(lambda a: a, params)
        if hm == 1:
            from vtp_tpu.parallel.sharding import permute_trunk_qkv

            hm_params["trunk"] = permute_trunk_qkv(params["trunk"], CFG["vision_num_heads"], 2)
        for tower, key, heads in (("pixel_decoder", "qkv", CFG["decoder_num_heads"]),
                                  ("text", "in_proj", CFG["text_num_heads"])):
            attn = dict(hm_params[tower]["blocks"]["attn"])
            attn[key] = {k: jax_qkv_head_major(v, heads, 2) for k, v in attn[key].items()}
            blocks = dict(hm_params[tower]["blocks"], attn=attn)
            hm_params[tower] = dict(hm_params[tower], blocks=blocks)
        sharded = shard_params(hm_params, mesh)
        for rank, device in enumerate(mesh.devices.reshape(-1)):
            def shard_of(a):
                return np.asarray(next(s.data for s in a.addressable_shards
                                       if s.device == device))

            local = jax.tree.map(shard_of, sharded)
            out[(hm, rank)] = (port[rank], _port_sd(local, local_cfg))
    return out


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("head_major", [1, 2], ids=["canonical", "head_major"])
def test_shard_state_dict_slabs_equal_jax_shards(slabs, head_major, rank):
    got, want = slabs[(head_major, rank)]
    assert set(got) == set(want)
    for name, slab in got.items():
        assert slab.shape == want[name].shape, name
        np.testing.assert_array_equal(slab, want[name], err_msg=name)
