"""Rank functions of the port's parallel tests (``tests/test_torch_parallel_*.py``),
run by ``tests/torch_dist.run_ranks`` on CPU gloo ranks. Imports no JAX:
the JAX references are computed in the test process and come in as numpy
arrays. Each function returns numpy arrays (rank 0's results, or every
rank's where the test compares ranks)."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.parallel import fsdp as fsdp_mod
from vtp_tpu_torch.parallel import sharding
from vtp_tpu_torch.parallel.mesh import make_mesh


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _sd_np(sd) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in sd.items()}


def _tensors(tree):
    """Nested dicts and lists of numpy arrays -> tensors (integers as int64)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(tree)
        return t.long() if tree.dtype.kind in "iu" else t
    return tree


# ------------------------------------------------------------ layouts

def shard_slabs(rank, world, cfg_kw, sd):
    """Every rank's ``shard_state_dict`` slabs on a (2, 2) mesh."""
    mesh = make_mesh(2, 2, device="cpu")
    cfg = VTPConfig(**cfg_kw)
    return _sd_np(sharding.shard_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                            mesh, cfg))


# ------------------------------------------------------- TP forwards

class _CollectiveCounter:
    """Counts the process-group calls made while it is active."""

    NAMES = ("all_reduce", "all_gather_single", "reduce_scatter_single",
             "all_gather_into_tensor", "reduce_scatter_tensor", "all_gather", "broadcast")

    def __init__(self):
        self.calls: Dict[str, int] = {}

    def __enter__(self):
        self.saved = {n: getattr(dist, n) for n in self.NAMES if hasattr(dist, n)}
        for n, fn in self.saved.items():
            def wrapped(*a, _n=n, _fn=fn, **k):
                self.calls[_n] = self.calls.get(_n, 0) + 1
                return _fn(*a, **k)
            setattr(dist, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(dist, n, fn)
        return False


def _forwards(model, images, text, latents, dtype):
    out = {}
    with torch.no_grad():
        model.encode_dtype = dtype
        out["latents"] = _np(model.get_reconstruction_latents(images))
        out["decoded"] = _np(model.get_latents_decoded_images(latents))
        out["text"] = _np(model.get_clip_text_feature(text, normalize=False,
                                                      compute_dtype=dtype))
    return out


def tp_forwards(rank, world, cfg_kw, sd, images, text, latents, meshes):
    """For each (n_data, n_model) of ``meshes``, with sequence parallelism
    off and on, in fp32 and bf16: the encode, the exact decode and the text
    features of the model ``sd`` tensor-parallelized over the mesh; and the
    collectives one block's attention and the fused attention call inside
    it issue."""
    from vtp_tpu_torch.ops import flash_attention as fa

    cfg = VTPConfig(**cfg_kw)
    images, text, latents = (torch.from_numpy(a) for a in (images, text, latents))
    text = text.long()
    results = {}
    for shape in meshes:
        mesh = make_mesh(*shape, device="cpu")
        for sp in (False, True):
            model = VTPModel(cfg, device="cpu")
            model.load_numpy_state_dict(sd)
            sharding.parallelize_model(model, mesh, sequence_parallel=sp)
            for dtype in (None, torch.bfloat16):
                key = (shape, sp, "bf16" if dtype else "fp32")
                results[key] = _forwards(model, images, text, latents, dtype)
            # one block's attention, its collectives counted by name
            blk = model.trunk.blocks[0]
            x = torch.randn(4 * 5, cfg.vision_embed_dim, generator=torch.Generator().manual_seed(0))
            rope = model.trunk.rope_for(2, 2)
            fused_calls = {}
            real = fa.fused_qkv_rope_attention

            def counted(*a, **k):
                with _CollectiveCounter() as c:
                    o = real(*a, **k)
                for n, v in c.calls.items():
                    fused_calls[n] = fused_calls.get(n, 0) + v
                fused_calls["launches"] = fused_calls.get("launches", 0) + 1
                return o

            import vtp_tpu_torch.models.blocks as blocks_mod
            blocks_mod.fused_qkv_rope_attention = counted
            try:
                rows = x if not sp else x.chunk(shape[1])[mesh.get_local_rank("model")]
                sharding.CALLS.clear()
                with torch.no_grad(), _CollectiveCounter() as c:
                    blk.attn(rows, [(4, 5)], [rope], [5], None, "float32", sp)
            finally:
                blocks_mod.fused_qkv_rope_attention = real
            results[(shape, sp, "attn_collectives")] = dict(c.calls)
            results[(shape, sp, "attn_calls")] = dict(sharding.CALLS)
            results[(shape, sp, "fused_collectives")] = fused_calls
    return results


# ------------------------------------------------------------ train steps

def _train_cfgs(cfg_kw, train_kw, arm_kw):
    from vtp_tpu_torch.train.step import TrainConfig

    return VTPConfig(**cfg_kw), TrainConfig(**train_kw), TrainConfig(**dict(train_kw, **arm_kw))


def _gathered_state(state, fsdp_on: bool):
    layout = state.layout
    out = {"student": _sd_np(sharding.gather_state_dict(state.model)),
           "teacher": _sd_np(sharding.gather_state_dict(state.teacher, layout)),
           "mu": {n: _np(layout.gather(n, m) if layout.is_sharded(n, m.ndim) else m)
                  for n, m in state.optimizer.mu.items()},
           "dino_center": _np(state.dino_center), "ibot_center": _np(state.ibot_center)}
    if fsdp_on:  # ZeRO-3: the optimizer's sharded leaves are the modules' own slabs
        own = dict(state.model.named_parameters())
        own.update((f"dino_head.{n}", p) for n, p in state.dino_head.named_parameters())
        out["leaves_are_modules"] = all(state.optimizer.leaves[n] is own[n]
                                        for n in state.fsdp.dims)
    return out


def _held_bytes(state) -> int:
    """Bytes of the distinct storages behind a train state's tensors (the
    optimizer's leaves, which are the modules' trained leaves, its moments,
    the teacher and the centers)."""
    opt = state.optimizer
    tensors = [*opt.leaves.values(), *opt.mu.values(), *opt.nu.values(),
               *state.teacher.state_dict().values(), state.dino_center, state.ibot_center]
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


def _slab_gather_identity(state):
    """For the state's layout with the trunk stored canonical (1) and
    head-major for the model axis: ``gather(slab(t)) == t`` for a seeded
    whole ``t`` of every sharded leaf's shape (the same on every rank)."""
    import dataclasses

    layout, out = state.layout, {}
    tp = layout.model.size if layout.model is not None else 1
    for hm in sorted({1, tp}):
        lay = dataclasses.replace(layout, head_major={"trunk": hm})
        gen = torch.Generator().manual_seed(0)
        ok = True
        for n, t in state.optimizer.leaves.items():
            if lay.is_sharded(n, t.ndim):
                full = torch.randn(lay.full_shape(n, t.shape), generator=gen)
                ok &= torch.equal(lay.gather(n, lay.slab(n, full)), full)
        out[hm] = ok
    return out


def _state_tensors(state):
    from vtp_tpu_torch.checkpoint import train_state_tensors

    return {k: v.detach().clone() for k, v in train_state_tensors(state).items()}


def _zero3_roundtrip(rank, state, cfg, tcfg, mesh, specs, ckpt_dir):
    """The ZeRO-3 ``state`` saved and restored into a replicated state (no
    mesh), which is saved and restored into a fresh ZeRO-3 state: whether
    the replicated state equals the gathered slabs and the second ZeRO-3
    state the first, each bit for bit (counters included)."""
    import os

    from vtp_tpu_torch.checkpoint import restore_train_state, save_train_state
    from vtp_tpu_torch.train.step import init_state

    layout = state.layout
    first = os.path.join(ckpt_dir, "zero3")
    save_train_state(first, state)
    dist.barrier()
    whole = restore_train_state(first, init_state(cfg, tcfg, device="cpu"))
    mine = _state_tensors(state)
    from vtp_tpu_torch.checkpoint import _sharded

    gathered = {k: (layout.gather(leaf, v) if (leaf := _sharded(layout, k, v)) else v)
                for k, v in mine.items()}
    whole_t = _state_tensors(whole)
    to_whole = (set(gathered) == set(whole_t) and whole.step == state.step
                and whole.optimizer.count == state.optimizer.count
                and all(torch.equal(gathered[k], whole_t[k]) for k in gathered))
    second = os.path.join(ckpt_dir, "replicated")
    save_train_state(second, whole)  # rank 0 writes its replicated copy
    dist.barrier()
    fresh = init_state(cfg, tcfg, device="cpu", mesh=mesh)
    from vtp_tpu_torch.parallel import fsdp as fsdp_mod

    fsdp_mod.shard_state(fresh, mesh, specs)
    back = _state_tensors(restore_train_state(second, fresh))
    to_zero3 = (set(back) == set(mine) and fresh.step == state.step
                and all(torch.equal(back[k], mine[k]) for k in mine))
    dist.barrier()
    return {"to_replicated": to_whole, "to_zero3": to_zero3}


def vtp_step_arms(rank, world, cfg_kw, train_kw, arms, params, teacher, batch, draws,
                  ckpt_dir=None):
    """Each arm ``(name, (n_data, n_model), TrainConfig overrides, fsdp)``:
    one VTP train step from the state ``params`` / ``teacher`` (numpy, the
    reference names) on the global ``batch`` with the global ``draws``;
    rank 0 returns the metrics and the gathered state. An FSDP arm shards
    the state ZeRO-3 (``fsdp_state_specs(..., tensor_parallel=n_model > 1)``),
    reports the bytes a rank holds, checks ``slab`` and ``gather`` against
    each other and, with ``ckpt_dir``, saves and restores its state
    (``_zero3_roundtrip``)."""
    from vtp_tpu_torch.train.state import load_numpy_train_state
    from vtp_tpu_torch.train.step import build_train_step, distribute_state, init_state

    out = {}
    batch, draws = _tensors(batch), _tensors(draws)
    for name, shape, arm_kw, fsdp_on in arms:
        cfg, tcfg, tcfg_arm = _train_cfgs(cfg_kw, train_kw, arm_kw)
        mesh = make_mesh(*shape, device="cpu")
        state = init_state(cfg, tcfg, device="cpu")
        load_numpy_train_state(state, params, teacher=teacher)
        distribute_state(state, tcfg_arm, mesh)
        if fsdp_on:
            tree = fsdp_mod.train_state_tree(state)
            specs = fsdp_mod.fsdp_state_specs(tree, shape[0], tensor_parallel=shape[1] > 1,
                                              min_elems=256)
            fsdp_mod.shard_state(state, mesh, specs)
            sizes = {"data": shape[0], "model": shape[1]}
            held = {"jax_rule": fsdp_mod.sharded_bytes(tree, specs, sizes),
                    "held_specs": fsdp_mod.sharded_bytes(tree, fsdp_mod.held_specs(specs), sizes),
                    "replicated": fsdp_mod.sharded_bytes(
                        tree, fsdp_mod.fsdp_state_specs(tree, 1), {"data": 1}),
                    "held": _held_bytes(state)}
            del tree
        sharding.CALLS.clear()
        state, metrics = build_train_step(cfg, tcfg_arm, mesh)(state, batch, draws=draws)
        res = {"metrics": {k: float(v) for k, v in metrics.items()},
               "calls": dict(sharding.CALLS), "config_hm": state.model.config.vision_qkv_head_major}
        res.update(_gathered_state(state, fsdp_on))
        if fsdp_on:
            res["bytes"] = held
            res["slab_gather"] = _slab_gather_identity(state)
            if ckpt_dir is not None:
                res["roundtrip"] = _zero3_roundtrip(rank, state, cfg, tcfg_arm, mesh, specs,
                                                    os.path.join(ckpt_dir, name))
        out[name] = res
    return out


def dit_dp_step(rank, world, cfg_kw, tcfg_kw, params, latents, labels, draws):
    """One DiT train step data-parallel over every rank, from ``params``."""
    from vtp_tpu_torch.dit.model import DiTConfig
    from vtp_tpu_torch.dit.train import DiTTrainConfig, build_dit_train_step, init_dit_state

    cfg, tcfg = DiTConfig(**cfg_kw), DiTTrainConfig(**tcfg_kw)
    mesh = make_mesh(world, 1, device="cpu")
    state = init_dit_state(cfg, tcfg, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    state.ema.load_state_dict(state.model.state_dict())
    step = build_dit_train_step(cfg, tcfg, mesh)
    state, metrics = step(state, torch.from_numpy(latents), torch.from_numpy(labels).long(), None,
                          {k: torch.from_numpy(v) for k, v in draws.items()})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": _sd_np(state.model.state_dict()), "ema": _sd_np(state.ema.state_dict()),
            "mu": {k: _np(v) for k, v in state.optimizer.mu.items()}}


def run_both(rank, world, *jobs):
    """Several rank functions in one spawn: ``jobs`` are (fn, args) pairs."""
    return [fn(rank, world, *args) for fn, args in jobs]



# ------------------------------------------- server, tokenizer, evals, CLIs

def _env_rank(rank, world):
    import os

    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    os.environ["LOCAL_RANK"] = "0"


def serve_and_data(rank, world, cfg_kw, sd, images, text, latents, classifier, targets,
                   ckpt_dir, image_dir, out_dir, cli_config, cli_out):
    """On four ranks: ``VTPServer`` over a (2, 2) mesh with
    ``tp_head_major``; ``VTPTokenizer(data_sharding=)``; both evals with
    ``sharding=``; ``extract_latents`` and ``train_vtp --mesh 2,2
    --tp_head_major --sequence_parallel`` as under torchrun."""
    import os

    from vtp_tpu_torch.eval.reconstruction import evaluate_reconstruction
    from vtp_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from vtp_tpu_torch.generation import VTPTokenizer
    from vtp_tpu_torch.serve import VTPServer
    from vtp_tpu_torch.tools import extract_latents, train_vtp

    cfg = VTPConfig(**cfg_kw)
    images, latents, classifier = (torch.from_numpy(a) for a in (images, latents, classifier))
    text, targets = torch.from_numpy(text).long(), torch.from_numpy(targets).long()
    mesh = make_mesh(2, 2, device="cpu")
    out = {}

    def fresh():
        model = VTPModel(cfg, device="cpu", encode_dtype=None)
        model.load_numpy_state_dict(sd)
        return model

    # the server: rank 0 submits, every rank works
    model = fresh()
    srv = VTPServer(model, batch_size=4, max_wait_ms=20, mesh=mesh, tp_head_major=True)
    out["serve_hm"] = model.config.vision_qkv_head_major
    if rank == 0:
        futs = {"encode": srv.submit_encode(images), "decode": srv.submit_decode(latents),
                "clip_image": srv.submit_clip_image(images),
                "clip_text": srv.submit_clip_text(text)}
        out["serve"] = {k: _np(f.result(timeout=120)) for k, f in futs.items()}
        out["serve_calls"] = dict(srv.calls)
    srv.shutdown()

    # the tokenizer and the evals: every rank passes the global batch
    model = fresh()
    tok = VTPTokenizer(model, img_size=cfg.image_size, data_sharding=mesh)
    out["tok_encode"] = _np(tok.encode_images(images))
    out["tok_decode"] = _np(tok.decode_to_images(latents))
    batches = [(images[:3], None), (images[3:], None)]
    out["recon"] = evaluate_reconstruction(model, batches, sharding=mesh)
    zs_batches = [(images[:3], targets[:3]), (images[3:], targets[3:])]
    out["zero_shot"] = evaluate_zero_shot(model, classifier, zs_batches, compute_dtype=None,
                                          sharding=mesh)

    # the CLIs as under torchrun
    _env_rank(rank, world)
    extract_latents.main(["--model_path", ckpt_dir, "--data_path", image_dir,
                          "--output_dir", out_dir, "--image_size", str(cfg.image_size),
                          "--batch_size", "2", "--num_workers", "0", "--device", "cpu"])
    base = ["--synthetic", "--config", cli_config, "--batch_size", "4", "--mesh", "2,2",
            "--tp_head_major", "--sequence_parallel", "--local_crops", "2", "--local_size", "16",
            "--dino_out_dim", "256", "--dino_hidden_dim", "32", "--dino_bottleneck_dim", "16",
            "--device", "cpu", "--log_every", "1", "--warmup_steps", "1", "--total_steps", "2",
            "--ckpt_every", "1"]
    straight = train_vtp.main(base + ["--out", os.path.join(cli_out, "straight"), "--steps", "2"])
    first = train_vtp.main(base + ["--out", os.path.join(cli_out, "resumed"), "--steps", "1"])
    resumed = train_vtp.main(base + ["--out", os.path.join(cli_out, "resumed"), "--steps", "2",
                                     "--resume"])
    out["cli"] = {"straight": straight["metrics"], "first": first["metrics"],
                  "resumed": resumed["metrics"], "start": resumed["start_step"],
                  "hm": straight["state"].model.config.vision_qkv_head_major}
    return out


def whole_weight_model(cfg_kw, sd, kind):
    """The model ``sd`` with every tower's linears in int8 (``"int8"``,
    ``quantize_for_serving``) or its SwiGLU FFNs fused (``"fused"``,
    ``fuse_ffn_params``)."""
    from vtp_tpu_torch.utils.params import fuse_ffn_params

    model = VTPModel(VTPConfig(**cfg_kw), device="cpu", encode_dtype=None)
    model.load_numpy_state_dict(sd)
    if kind.startswith("int8"):
        return model.quantize_for_serving(("trunk", "text", "pixel_decoder"))
    return fuse_ffn_params(model)


def serve_whole_weights(rank, world, cfg_kw, sd, images, text, latents):
    """``VTPServer`` over a (1, 2) mesh on the int8 model, on the int8 model
    with ``tp_head_major`` and on the fused-``w12`` model: rank 0's results
    of every kind, the model calls and the collectives; every rank's
    declared trunk layout and whether its int8 units stayed whole."""
    from vtp_tpu_torch.models.blocks import Attention, Mlp, SwiGLUFFN
    from vtp_tpu_torch.models.text_encoder import ResidualAttentionBlock
    from vtp_tpu_torch.serve import VTPServer

    UNITS = (Attention, SwiGLUFFN, Mlp, ResidualAttentionBlock)
    mesh = make_mesh(1, 2, device="cpu")
    images, latents = torch.from_numpy(images), torch.from_numpy(latents)
    text = torch.from_numpy(text).long()
    out = {}
    for kind in ("int8", "int8_head_major", "fused"):
        model = whole_weight_model(cfg_kw, sd, kind)
        sharding.CALLS.clear()
        srv = VTPServer(model, batch_size=4, max_wait_ms=20, warmup=False, mesh=mesh,
                        tp_head_major=kind.endswith("head_major"))
        units = [m for m in model.modules() if isinstance(m, UNITS)]
        res = {"hm": model.config.vision_qkv_head_major,
               "tp_units": sum(m.tp is not None for m in units), "units": len(units),
               "int8_shapes": {n: tuple(t.shape) for n, t in model.state_dict().items()
                               if n.endswith((".q", ".scale"))}}
        if rank == 0:
            futs = {"encode": srv.submit_encode(images), "decode": srv.submit_decode(latents),
                    "clip_image": srv.submit_clip_image(images),
                    "clip_text": srv.submit_clip_text(text)}
            res["serve"] = {k: f.result(timeout=120).float().numpy() for k, f in futs.items()}
            res["calls"] = dict(srv.calls)
        srv.shutdown()
        res["collectives"] = dict(sharding.CALLS)
        out[kind] = res
    return out


def serve_worker_failure(rank, world, cfg_kw, sd, images):
    """``VTPServer`` over a (2, 1) mesh whose rank-1 encode raises before its
    collectives: rank 0 returns what its futures and a later submit got,
    rank 1 what its ``shutdown()`` raised."""
    from vtp_tpu_torch.serve import VTPServer

    model = VTPModel(VTPConfig(**cfg_kw), device="cpu", encode_dtype=None)
    model.load_numpy_state_dict(sd)
    if rank == 1:
        def broken(x):
            raise ValueError("rank 1 encode failed")

        model.get_reconstruction_latents = broken
    srv = VTPServer(model, batch_size=4, max_wait_ms=20, warmup=False,
                    mesh=make_mesh(2, 1, device="cpu"))
    if rank == 1:
        try:
            srv.shutdown()
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}
    first = srv.submit_encode(torch.from_numpy(images)).exception(timeout=200)
    later = srv.submit_encode(torch.from_numpy(images)).exception(timeout=10)
    srv.shutdown()
    return {"first": type(first).__name__ if first is not None else None,
            "later": str(later) if later is not None else None}


# ------------------------------------------- context and pipeline parallelism

def _seq_group(mesh):
    from vtp_tpu_torch.parallel.mesh import SEQ_AXIS, axis_group

    return axis_group(mesh, SEQ_AXIS)


def cp_attention_cases(rank, world, cases, cp_tp):
    """The ring and Ulysses arms on this rank's token shards (and, with
    ``cp_tp``, on a (1, 2, 2) mesh's token and head shards): for each case
    (name, arm, q, k, v, cotangent, n_valid, dtype) the rank's output and
    gradients, gathered to whole tensors, and the collectives (``sharding.CALLS``)
    of its forward and of its backward; then ``sdpa_bnhd`` under each mode
    with heads that divide the axis and heads that do not, and the eager
    entry (and its error when N does not divide)."""
    from vtp_tpu_torch.models.blocks import sdpa_bnhd
    from vtp_tpu_torch.ops.ring_attention import (
        ring_attention,
        ring_attention_local,
        ulysses_attention_local,
    )
    from vtp_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group, make_cp_mesh
    from vtp_tpu_torch.parallel.sharding import ContextParallel

    mesh = make_cp_mesh(world, 1, device="cpu")
    seq = _seq_group(mesh)
    arms = {"ring": ring_attention_local, "ulysses": ulysses_attention_local}
    out = {}

    def run(name, fn, q, k, v, w, n_valid, dtype, g, model=None):
        def local(t):
            t = torch.from_numpy(t).to(dtype).chunk(g.size, 1)[g.rank]
            return t if model is None else t.chunk(model.size, 2)[model.rank]

        leaves = [local(x).requires_grad_() for x in (q, k, v)]
        sharding.CALLS.clear()
        o = fn(*leaves, g, n_valid=n_valid)
        fwd = dict(sharding.CALLS)
        (o.float() * local(w).float()).sum().backward()
        bwd = {n: c - fwd.get(n, 0) for n, c in sharding.CALLS.items() if c - fwd.get(n, 0)}
        grads = [t.grad for t in leaves]

        def whole(t):
            t = t.detach().contiguous()
            if model is not None:
                t = sharding._gather_dim(t, model, 2)
            return _np(sharding._gather_dim(t, g, 1))

        out[name] = {"o": whole(o), "grads": [whole(t) for t in grads], "forward_calls": fwd,
                     "backward_calls": bwd}

    for name, arm, q, k, v, w, n_valid, dtype in cases:
        run(name, arms[arm], q, k, v, w, n_valid, getattr(torch, dtype), seq)
    # sdpa_bnhd's arm by mode: the calls name it
    name, _, q, k, v, w, n_valid, _ = cases[0]
    routes = {}
    for mode in ("auto", "ring", "ulysses"):
        def fn(q, k, v, g, n_valid, mode=mode):
            return sdpa_bnhd(q, k, v, n_valid=n_valid, cp=ContextParallel(g, mode))

        for heads in (world, world + 1):  # heads that divide the axis, and heads that do not
            key = f"route_{mode}_{heads}"
            run(key, fn, *(np.ascontiguousarray(t[:, :, :heads]) for t in (q, k, v, w)),
                n_valid, torch.float32, seq)
            routes[key] = out.pop(key)
    out["routes"] = routes
    # the eager entry on whole tensors
    _, _, q, k, v, w, n_valid, _ = cases[1]
    whole = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    o = ring_attention(*whole, group=seq, n_valid=n_valid)
    (o * torch.from_numpy(w)).sum().backward()
    out["eager"] = {"o": _np(o), "grads": [_np(t.grad) for t in whole]}
    try:
        ring_attention(*(t.detach()[:, :-1] for t in whole), group=seq)
        out["eager_error"] = None
    except ValueError as e:
        out["eager_error"] = str(e)
    if cp_tp:
        mesh = make_cp_mesh(2, 1, 2, device="cpu")
        seq, model = _seq_group(mesh), axis_group(mesh, MODEL_AXIS)
        for name, arm, q, k, v, w, n_valid, dtype in cp_tp:
            run(name, arms[arm], q, k, v, w, n_valid, getattr(torch, dtype), seq, model)
    return out


class _Weight(torch.nn.Module):
    """One layer of ``pipeline_apply``'s linear test body."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w).clone())


def _linear_body(layer, x):
    return torch.tanh(x @ layer.w)


def _param_grads(module_list, loss_fn):
    """``loss_fn()`` and the gradients of every parameter of
    ``module_list`` (by ``named_parameters`` name), cleared first."""
    for p in module_list.parameters():
        p.grad = None
    loss_fn().backward()
    return {n: _np(p.grad) for n, p in module_list.named_parameters()}


def pipeline_cases(rank, world, ws, x_lin, cot_lin, block_kw, blocks_sd, x_tok, cot_tok,
                   rope):
    """On a (pipe,) mesh of every rank: ``pipeline_apply`` with the linear
    body and ``pipeline_blocks`` on a block stack, each under remat off and
    "full", their outputs and the gradients of ``sum(out * cot)`` (weights,
    input, and the blocks' RoPE tables), beside the same through the
    sequential loop; the collectives of one pipelined call; the depth error
    and ``maybe_pipeline_blocks``' fallbacks."""
    from vtp_tpu_torch.models.blocks import Block, BlockConfig, run_blocks
    from vtp_tpu_torch.parallel.mesh import PIPE_AXIS, axis_group, make_pipeline_mesh
    from vtp_tpu_torch.parallel.pipeline import (
        maybe_pipeline_blocks,
        pipeline_apply,
        pipeline_blocks,
    )
    from vtp_tpu_torch.parallel.sharding import PipelineParallel

    g = axis_group(make_pipeline_mesh(world, device="cpu"), PIPE_AXIS)
    out = {}
    layers = torch.nn.ModuleList(_Weight(w) for w in ws)
    x_lin, cot_lin = torch.from_numpy(x_lin), torch.from_numpy(cot_lin)

    def seq_linear(x):
        for layer in layers:
            x = _linear_body(layer, x)
        return x

    for remat in (False, "full"):
        xg = x_lin.clone().requires_grad_()
        res = {}

        def loss():
            res["o"] = pipeline_apply(_linear_body, layers, xg, group=g, remat=remat)
            return (res["o"] * cot_lin).sum()

        sharding.CALLS.clear()
        grads = _param_grads(layers, loss)
        out[f"linear_{remat}"] = {"o": _np(res["o"]), "grads": grads, "dx": _np(xg.grad),
                                  "calls": dict(sharding.CALLS)}
    xg = x_lin.clone().requires_grad_()
    res = {}
    out["linear_seq"] = {"grads": _param_grads(layers, lambda: (seq_linear(xg) * cot_lin).sum()),
                         "dx": _np(xg.grad)}
    with torch.no_grad():
        out["linear_seq"]["o"] = _np(seq_linear(x_lin))

    blocks = torch.nn.ModuleList(Block(BlockConfig(**block_kw)) for _ in range(len(ws)))
    blocks.load_state_dict({k: torch.from_numpy(v) for k, v in blocks_sd.items()})
    x_tok, cot_tok = torch.from_numpy(x_tok), torch.from_numpy(cot_tok)
    b, n, d = x_tok.shape
    micro = 2  # microbatches need not match the stages
    for remat in (False, "full", "seq"):
        xg = x_tok.clone().requires_grad_()
        tables = [torch.from_numpy(t).clone().requires_grad_() for t in rope]
        res = {}

        def loss():
            if remat == "seq":
                (res["o"],) = run_blocks(blocks, [xg], [tuple(tables)])
            else:
                xm = xg.reshape(micro, (b // micro) * n, d)
                o = pipeline_blocks(xm, blocks, [tuple(tables)], [(b // micro, n)], group=g,
                                    remat=remat)
                res["o"] = o.reshape(b, n, d)
            return (res["o"] * cot_tok).sum()

        grads = _param_grads(blocks, loss)
        out[f"blocks_{remat}"] = {"o": _np(res["o"]), "grads": grads, "dx": _np(xg.grad),
                                  "drope": [_np(t.grad) for t in tables]}
    # the fallbacks of maybe_pipeline_blocks and of run_blocks under a pipe axis
    pp = PipelineParallel(g)
    with torch.no_grad():
        out["fallback_rows"] = maybe_pipeline_blocks([x_tok[:b - 1]], blocks, [None], g)
        out["fallback_depth"] = maybe_pipeline_blocks([x_tok], blocks[:world - 1], [None], g)
        out["fallback_seq"] = _np(run_blocks(blocks, [x_tok[:b - 1]], [None], pp=pp)[0])
        out["fallback_seq_want"] = _np(run_blocks(blocks, [x_tok[:b - 1]], [None])[0])
    try:
        pipeline_apply(_linear_body, layers[:world + 1], x_lin, group=g)
        out["depth_error"] = None
    except ValueError as e:
        out["depth_error"] = str(e)
    return out


def _cp_pp_mesh(kind, shape):
    from vtp_tpu_torch.parallel.mesh import make_cp_mesh, make_pp_mesh

    return (make_cp_mesh if kind == "cp" else make_pp_mesh)(*shape, device="cpu")


def vtp_cp_pp_arms(rank, world, cfg_kw, train_kw, arms, params, batch, enc):
    """Each arm ``(name, kind, shape, cp_mode, TrainConfig overrides)``, kind
    "cp" (``make_cp_mesh(*shape)``) or "pp" (``make_pp_mesh(*shape)``): one
    VTP train step from ``params`` on the global ``batch``; every rank
    returns the metrics, the gathered student and first moments and the
    collectives. ``enc`` (config, state dict, images): that model's encode
    and exact decode with its trunk and decoder split over a (1, world)
    seq axis, beside the calls of the fused attention."""
    from vtp_tpu_torch.models import blocks as blocks_mod
    from vtp_tpu_torch.train.state import load_numpy_train_state
    from vtp_tpu_torch.train.step import build_train_step, distribute_state, init_state

    out = {}
    batch = _tensors(batch)
    for name, kind, shape, cp_mode, arm_kw in arms:
        cfg, tcfg, tcfg_arm = _train_cfgs(cfg_kw, train_kw, arm_kw)
        mesh = _cp_pp_mesh(kind, shape)
        state = init_state(cfg, tcfg, device="cpu")
        load_numpy_train_state(state, params)
        distribute_state(state, tcfg_arm, mesh, cp_mode)
        sharding.CALLS.clear()
        state, metrics = build_train_step(cfg, tcfg_arm, mesh)(state, batch)
        layout = state.layout
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "calls": dict(sharding.CALLS),
                     "student": _sd_np(sharding.gather_state_dict(state.model)),
                     "mu": {n: _np(layout.gather(n, m) if layout.is_sharded(n, m.ndim) else m)
                            for n, m in state.optimizer.mu.items()}}
    cfg_kw, sd, images = enc
    model = VTPModel(VTPConfig(**cfg_kw), device="cpu", encode_dtype=None)
    model.load_numpy_state_dict(sd)
    sharding.parallelize_model(model, _cp_pp_mesh("cp", (world, 1)))
    fused = []
    real = blocks_mod.fused_qkv_rope_attention

    def counted(*a, **k):
        fused.append(1)
        return real(*a, **k)

    blocks_mod.fused_qkv_rope_attention = counted
    try:
        with torch.no_grad():
            x = torch.from_numpy(images)
            feats = model.trunk.forward_features(x, use_bottleneck=False)
            out["encode"] = {k: _np(feats[k]) for k in ("x_norm_clstoken", "x_norm_patchtokens")}
            out["encode"]["latents"] = _np(model.get_reconstruction_latents(x))
            out["encode"]["images"] = _np(model.get_latents_decoded_images(
                model.get_reconstruction_latents(x)))
    finally:
        blocks_mod.fused_qkv_rope_attention = real
    out["encode"]["fused_calls"] = len(fused)
    return out


def train_vtp_ranks(rank, world, argv, out_dir):
    """``train_vtp.main`` as under torchrun with ``--context_parallel 2
    --cp_mode ring`` and then ``--pipeline_parallel 2``: each run's metrics
    and what the PP run printed."""
    import contextlib
    import io
    import os

    from vtp_tpu_torch.tools import train_vtp

    _env_rank(rank, world)
    cp = train_vtp.main(argv + ["--context_parallel", "2", "--cp_mode", "ring",
                                "--out", os.path.join(out_dir, "cp")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pp = train_vtp.main(argv + ["--pipeline_parallel", "2", "--out",
                                    os.path.join(out_dir, "pp")])
    return {"rank": rank, "cp": cp["metrics"], "pp": pp["metrics"], "pp_stdout": buf.getvalue()}
