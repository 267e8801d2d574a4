"""The JAX package's native checkpoint format (port of
``vtp_tpu/checkpoint.py:25-89``: ``flatten_params``, ``unflatten_params``,
``save_pretrained``, ``load_pretrained``), without the ``safetensors``
package.

A native checkpoint is a directory with ``config.json`` (``model_format:
"vtp_tpu"`` and the ``VTPConfig`` fields) and one ``model.safetensors``
holding the JAX-layout parameter tree (``convert.from_torch``'s
``convert_state_dict``) flattened under ``/``-joined paths; a None leaf is
a zero-size tensor named ``<path>/__none__``. The trunk's qkv columns are
in the layout the config declares (``vision_qkv_head_major``), and the
RoPE periods are BF16 when the rope dtype is.

Train states (``checkpoint.py:109-215``, orbax there): ``save_train_state``
writes a train state (``dit.train.DiTState`` or ``train.state.TrainState``)
to ``<directory>/step_{step:08d}/train_state.safetensors`` with the port's
own ``.safetensors`` writer: every module's state dict under its attribute
name (``model/...``, ``ema/...``), every tensor attribute (the centers), the
optimizer's moments (``optimizer/mu/<leaf>``, ``optimizer/nu/<leaf>``) in
their dtypes and its Adam count, and the step (I32 scalars, as in the JAX
tree). ``block=False`` copies the state to the host before it returns (a
train step updates the state in place) and writes on a background thread;
``wait_for_checkpoints`` waits for those writes. ``restore_train_state``
fills a template state of the same structure in place and refuses a leaf
whose stored dtype differs from the template's (a ``--moment_dtype``
switch) unless ``allow_dtype_mismatch``.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.convert.safetensors_io import (
    load_safetensors,
    read_safetensors_header,
    save_safetensors,
)
from vtp_tpu_torch.train.optim import AdamW

_SEP = "/"
_NONE_MARKER = "__none__"
# leaves of the tree in the rope dtype
ROPE_LEAVES = ("trunk/rope/periods", "pixel_decoder/rope/periods")


def flatten_params(params: Any) -> Dict[str, np.ndarray]:
    """A parameter tree (dicts, lists, arrays, None) -> {path: array}."""
    flat = {}

    def visit(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(path + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(path + (str(i),), v)
        elif node is None:
            flat[_SEP.join(path) + _SEP + _NONE_MARKER] = np.zeros((0,), np.float32)
        else:
            flat[_SEP.join(path)] = np.asarray(node)

    visit((), params)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Any:
    """{path: array} -> the nested dict tree (list indices stay string keys,
    as in the JAX package)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        if parts[-1] == _NONE_MARKER:
            parts, value = parts[:-1], None
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def save_pretrained(path: str, model) -> None:
    """Write ``model`` (a ``VTPModel``) as a native checkpoint to the
    directory ``path``: the JAX-layout tree of its weights in the config's
    qkv layout, fp32 leaves, the rope periods in BF16 when the rope dtype is
    bf16. A tensor-parallelized model is gathered on every rank and written
    by rank 0."""
    from vtp_tpu_torch.convert.from_torch import convert_state_dict
    from vtp_tpu_torch.convert.to_torch import export_state_dict
    from vtp_tpu_torch.parallel.multihost import is_main_process
    from vtp_tpu_torch.parallel.sharding import permute_trunk_qkv

    cfg = model.config
    sd = export_state_dict(model)
    if not is_main_process():
        return
    params = convert_state_dict(sd, cfg)
    params["trunk"] = permute_trunk_qkv(params["trunk"], cfg.vision_num_heads,
                                        cfg.vision_qkv_head_major)
    flat = flatten_params(params)
    bf16 = [k for k in ROPE_LEAVES if k in flat] if cfg.rope_dtype == "bf16" else []
    if cfg.rope_dtype == "fp16":
        flat.update({k: flat[k].astype(np.float16) for k in ROPE_LEAVES if k in flat})
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_format": "vtp_tpu", **cfg.to_dict()}, f, indent=2)
    save_safetensors(os.path.join(path, "model.safetensors"), flat, bf16=bf16)


def load_pretrained(path: str) -> Tuple[VTPConfig, Any]:
    """A native checkpoint directory -> (VTPConfig, parameter tree of numpy
    arrays; BF16 leaves as fp32). ``convert.load_vtp_checkpoint`` reads
    either format."""
    with open(os.path.join(path, "config.json")) as f:
        cfg_dict = json.load(f)
    if cfg_dict.get("model_format") != "vtp_tpu":
        raise ValueError(f"{path} is not a native checkpoint (no model_format \"vtp_tpu\"); "
                         f"read it with convert.load_vtp_checkpoint")
    config = VTPConfig.from_dict(cfg_dict)
    return config, unflatten_params(load_safetensors(os.path.join(path, "model.safetensors")))


# ------------------------------------------------------------ train state

TRAIN_STATE_FILE = "train_state.safetensors"
_TAGS = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
         torch.int64: "I64", torch.int32: "I32"}
_writer: Optional[cf.ThreadPoolExecutor] = None
_pending: List[cf.Future] = []
_pending_lock = threading.Lock()


def train_state_tensors(state: Any) -> Dict[str, torch.Tensor]:
    """Every tensor of a train state by checkpoint name: the state dicts of
    its modules, its tensor attributes and its optimizer's moments. The
    tensors are the state's own (a copy into them updates the state)."""
    out: Dict[str, torch.Tensor] = {}
    for attr, value in vars(state).items():
        if isinstance(value, nn.Module):
            out.update((f"{attr}/{k}", v) for k, v in value.state_dict().items())
        elif isinstance(value, torch.Tensor):
            out[attr] = value
        elif isinstance(value, AdamW):
            for moment in ("mu", "nu"):
                out.update((f"{attr}/{moment}/{n}", t)
                           for n, t in getattr(value, moment).items())
    return out


def _leaf_of(name: str) -> Optional[str]:
    """A train-state tensor's leaf name in the shard layout (the student's,
    the teacher's and the moments' share it); None for the others."""
    head, _, rest = name.partition("/")
    if head in ("model", "teacher"):
        return rest
    if head == "dino_head":
        return f"dino_head.{rest}"
    if head == "optimizer":
        return rest.partition("/")[2]
    return None


def _sharded(layout, name: str, t: torch.Tensor) -> Optional[str]:
    """The layout's leaf name of a train-state tensor that a distributed
    state holds as a slab (model- or data-sharded), else None."""
    leaf = _leaf_of(name)
    if layout is None or leaf is None or not layout.is_sharded(leaf, t.ndim):
        return None
    return leaf


def _counters(state: Any) -> Dict[str, int]:
    """The state's integer counters: its step and each optimizer's count."""
    out = {"step": int(state.step)}
    out.update((f"{attr}/count", int(v.count)) for attr, v in vars(state).items()
               if isinstance(v, AdamW))
    return out


def _set_counters(state: Any, values: Dict[str, int]) -> None:
    state.step = values["step"]
    for attr, v in vars(state).items():
        if isinstance(v, AdamW):
            v.count = values[f"{attr}/count"]


def _write_train_state(path: str, arrays: Dict[str, np.ndarray], bf16: List[str]) -> None:
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_safetensors(os.path.join(tmp, TRAIN_STATE_FILE), arrays, bf16=bf16,
                     metadata={"format": "vtp_tpu_torch train state"})
    if os.path.isdir(path):  # force, as the JAX package saves
        shutil.rmtree(path)
    os.rename(tmp, path)


def save_train_state(directory: str, state: Any, step: Optional[int] = None,
                     block: bool = True) -> str:
    """Write ``state`` to ``directory/step_{step:08d}`` (``step`` defaults to
    the state's) and return that path. The state is copied to the host
    before this returns; with ``block=False`` the file is written on a
    background thread: call :func:`wait_for_checkpoints` before the
    process exits or the checkpoint is read back."""
    global _writer
    from vtp_tpu_torch.parallel.multihost import is_main_process

    step = int(state.step) if step is None else step
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}")
    layout = getattr(state, "layout", None)
    arrays, bf16 = {}, []
    for name, t in train_state_tensors(state).items():
        leaf = _sharded(layout, name, t)
        if leaf is not None:  # a collective: every rank gathers, rank 0 writes
            t = layout.gather(leaf, t)
        if not is_main_process():
            continue
        t = t.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()  # written back as BF16, exactly
            bf16.append(name)
        arrays[name] = t.numpy()
    if not is_main_process():
        return path
    arrays.update((k, np.array(v, np.int32)) for k, v in _counters(state).items())
    with _pending_lock:
        if _writer is None:
            _writer = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="train-state")
        _pending.append(_writer.submit(_write_train_state, path, arrays, bf16))
    if block:
        wait_for_checkpoints()
    return path


def wait_for_checkpoints() -> None:
    """Block until every train-state write started so far is on disk; a
    failed write raises here."""
    with _pending_lock:
        pending = list(_pending)
        _pending.clear()
    for fut in pending:
        fut.result()


def latest_train_state_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


def restore_train_state(directory: str, template: Any, step: Optional[int] = None,
                        allow_dtype_mismatch: bool = False) -> Any:
    """Fill ``template`` (a train state of the saved structure) in place
    from ``directory``'s checkpoint at ``step`` (default: the latest) and
    return it. A missing or extra leaf or a shape change raises
    ``ValueError``, and so does a leaf whose stored dtype differs from the
    template's (resuming with another ``--moment_dtype``) unless
    ``allow_dtype_mismatch``, which casts it to the template's dtype."""
    wait_for_checkpoints()
    step = latest_train_state_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}", TRAIN_STATE_FILE)
    _, header = read_safetensors_header(path)
    header.pop("__metadata__", None)
    tensors = train_state_tensors(template)
    layout = getattr(template, "layout", None)
    counters = _counters(template)
    want = set(tensors) | set(counters)
    if set(header) != want:
        missing, extra = sorted(want - set(header)), sorted(set(header) - want)
        raise ValueError(f"checkpoint {path} does not match the template: missing "
                         f"{missing[:10]}, unexpected {extra[:10]}")
    bad = []
    for name, t in tensors.items():
        leaf = _sharded(layout, name, t)
        shape = tuple(t.shape) if leaf is None else layout.full_shape(leaf, t.shape)
        if tuple(header[name]["shape"]) != shape:
            raise ValueError(f"checkpoint {path}: {name} has shape {header[name]['shape']}, "
                             f"the template {shape}")
        if header[name]["dtype"] != _TAGS.get(t.dtype):
            bad.append(f"  {name}: checkpoint {header[name]['dtype']} vs template {t.dtype}")
    if bad and not allow_dtype_mismatch:
        raise ValueError(f"checkpoint {path} dtype mismatch (did --moment_dtype change since it "
                         "was written?); pass allow_dtype_mismatch=True to cast on restore:\n"
                         + "\n".join(bad[:10])
                         + ("" if len(bad) <= 10 else f"\n  ... {len(bad) - 10} more"))
    arrays = load_safetensors(path)
    with torch.no_grad():
        for name, t in tensors.items():
            full = torch.from_numpy(arrays[name])
            leaf = _sharded(layout, name, t)
            t.copy_(full if leaf is None else layout.slab(leaf, full))
    _set_counters(template, {k: int(arrays[k]) for k in counters})
    return template
