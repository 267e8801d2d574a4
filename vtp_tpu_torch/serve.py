"""Batched serving runtime for the VTP tokenizer (port of
``vtp_tpu/serve.py:45-270``).

Requests (encode, decode, clip_image, clip_text) are queued per kind,
coalesced into fixed-size batches, run on the model's device by one
dispatcher thread, and handed back per request through futures. The
dispatcher serves the kind whose head request is oldest, so no kind
starves and each kind keeps its order. A batch gathers up to
``batch_size`` rows or waits ``max_wait_ms``; more rows than that run in
chunks of ``batch_size``. A short chunk is padded to ``batch_size`` on the
device by repeating its last row, and only its valid rows are fetched to
the host, so every call sees one batch shape and no padding crosses the
host link.

Usage:
    server = VTPServer(model, batch_size=32)
    fut = server.submit_encode(images_nchw)       # (n, 3, S, S) float32
    latents = fut.result()                        # (n, d, S/p, S/p), a CPU tensor

Payloads are numpy arrays or tensors; they move to the model's device in
the dispatcher. Results are CPU tensors in the model's output dtype.

Every model call of the server, the warm-up included, runs on the
dispatcher thread: the exact-fp32 decode switches the process-wide TF32
flags off while it runs (``models/pixel_decoder.exact_fp32``), and two
threads doing that at once could leave them wrong for each other.
Callers that run the model themselves while a server is up share those
flags with it.

``mesh=`` (a DeviceMesh over every rank, ``parallel.mesh.make_mesh``) serves
data- and tensor-parallel, with the JAX server's checks (:64-112): the
model is tensor-parallelized over the model axis (``tp_head_major``: its
trunk stored head-major for it, as the JAX server permutes a canonical
one), ``batch_size`` must divide over the data axis. Every rank constructs
the server. Rank 0 owns the queues and the coalescer; for each batch it
broadcasts the kind and the padded rows, every rank runs its data shard's
rows of them (``data_parallel_apply``) and the outputs are gathered, and
rank 0 hands them to the futures. The other ranks run that loop as workers
until rank 0's ``shutdown()`` broadcasts a stop; their ``shutdown()`` waits
for it. A batch that fails once it was broadcast leaves the ranks out of
step, since some may wait in a collective that others never reach: rank 0
then fails that batch's and every queued future and stops without a
broadcast, and a worker ends its loop and re-raises the error from its
``shutdown()``, so its process fails (a rank still waiting fails at the
process group's timeout). A batch that fails on rank 0 before its broadcast
fails only its own futures. Without a mesh ``tp_head_major`` is ignored, as
in the JAX server.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from vtp_tpu_torch.models.vtp_model import VTPModel
from vtp_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, check_mesh, mesh_axis_size
from vtp_tpu_torch.parallel.sharding import data_parallel_apply, parallelize_model

_seq = itertools.count()


class _Request:
    __slots__ = ("kind", "payload", "future", "seq")

    def __init__(self, kind: str, payload: torch.Tensor):
        self.kind = kind
        self.payload = payload
        self.future: Future = Future()
        self.seq = next(_seq)


# the payload dtypes a batch broadcast carries, by code
_DTYPES = (torch.float32, torch.int64, torch.float64, torch.bfloat16, torch.int32, torch.float16)
_STOP = -1


class VTPServer:
    """Batched inference server (threaded dispatcher) on the model's device;
    over a mesh, rank 0 serves and the other ranks work."""

    def __init__(self, model: VTPModel, batch_size: int = 32, max_wait_ms: float = 5.0,
                 warmup: bool = True, mesh=None, tp_head_major: bool = False):
        self.model = model
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        self.mesh = mesh
        self.rank = 0
        if mesh is not None:
            check_mesh(mesh, "mesh")
            n_data = mesh_axis_size(mesh, DATA_AXIS)
            n_model = mesh_axis_size(mesh, MODEL_AXIS)
            if batch_size % n_data:
                raise ValueError(f"batch_size {batch_size} must divide over the mesh data "
                                 f"axis ({n_data} shards)")
            heads, hm = model.config.vision_num_heads, model.config.vision_qkv_head_major
            if tp_head_major:
                if n_model <= 1:
                    raise ValueError("tp_head_major needs a model axis > 1")
                if heads % n_model:
                    raise ValueError(f"tp_head_major: vision_num_heads {heads} % model axis "
                                     f"{n_model} != 0")
                if hm not in (1, n_model):
                    raise ValueError(f"checkpoint layout vision_qkv_head_major={hm} does not "
                                     f"match the mesh model axis {n_model}")
            parallelize_model(model, mesh, head_major=tp_head_major)
            self.rank = dist.get_rank()
        self.max_wait = max_wait_ms / 1000.0
        self._stop = threading.Event()
        self._in_batch = False  # rank 0: a broadcast batch has not finished on every rank
        self._error: Optional[BaseException] = None  # a worker's failure
        enc = model.encode_dtype
        fns: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
            "encode": model.get_reconstruction_latents,
            "decode": model.get_latents_decoded_images,
            "clip_image": lambda x: model.get_clip_image_feature(x, True, enc),
            "clip_text": lambda x: model.get_clip_text_feature(x, True, enc),
        }
        if mesh is not None:
            fns = {k: (lambda x, fn=fn: data_parallel_apply(fn, x, mesh)) for k, fn in fns.items()}
        self._fns = fns
        self._queues: Dict[str, deque] = {k: deque() for k in self._fns}
        # model calls made for requests, by kind (the warm-up's not counted)
        self.calls: Dict[str, int] = {k: 0 for k in self._fns}
        self._cv = threading.Condition()
        ready: Future = Future()
        self._thread = threading.Thread(target=self._run, args=(warmup, ready), daemon=True)
        self._thread.start()
        ready.result()  # the warm-up's exception, if it raised

    # ------------------------------------------------------------- api

    def submit(self, kind: str, payload) -> Future:
        if self.rank != 0:
            raise RuntimeError("only rank 0 of a mesh takes requests")
        if kind not in self._fns:
            raise ValueError(f"unknown request kind {kind}")
        req = _Request(kind, torch.as_tensor(payload))
        with self._cv:
            if self._stop.is_set():
                req.future.set_exception(RuntimeError("VTPServer is shut down"))
                return req.future
            self._queues[kind].append(req)
            self._cv.notify_all()
        return req.future

    def submit_encode(self, images) -> Future:
        return self.submit("encode", images)

    def submit_decode(self, latents) -> Future:
        return self.submit("decode", latents)

    def submit_clip_image(self, images) -> Future:
        return self.submit("clip_image", images)

    def submit_clip_text(self, tokens) -> Future:
        return self.submit("clip_text", tokens)

    def shutdown(self) -> None:
        """Stop the dispatcher and fail every still-queued future: no
        request is left pending. On a worker rank: wait for rank 0's stop,
        and raise the error that ended the worker loop, if one did."""
        if self.rank != 0:
            self._thread.join()
            if self._error is not None:
                raise self._error
            return
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=30)
        self._fail_pending(RuntimeError("VTPServer shut down with request pending"))

    def _fail_pending(self, error: BaseException) -> None:
        with self._cv:
            pending = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
        for r in pending:
            r.future.set_exception(error)

    # -------------------------------------------------------- internals

    def _run(self, warmup: bool, ready: Future) -> None:
        try:
            if warmup:
                self._warmup()
        except Exception as e:
            ready.set_exception(e)
            return
        ready.set_result(None)
        if self.rank != 0:
            try:
                self._work()
            except BaseException as e:  # raised again by shutdown()
                self._error = e
            return
        try:
            self._loop()
        finally:
            if self.mesh is not None and not self._in_batch:
                self._broadcast(_STOP)

    def _warmup(self) -> None:
        """Encode and decode one batch of zeros: builds the kernels and
        brings up cuBLAS before the first request."""
        cfg = self.model.config
        s, g = cfg.image_size, cfg.image_size // cfg.vision_patch_size
        img = torch.zeros((self.batch_size, 3, s, s), device=self.device)
        lat = torch.zeros((self.batch_size, cfg.vision_feature_bottleneck, g, g),
                          device=self.device)
        self._fns["encode"](img).cpu()
        if self.model.pixel_decoder is not None:
            self._fns["decode"](lat).cpu()

    def _oldest_kind(self) -> Optional[str]:
        heads = [(q[0].seq, k) for k, q in self._queues.items() if q]
        return min(heads)[1] if heads else None

    def _collect_batch(self) -> List[_Request]:
        """Serve the kind whose head request is oldest; keep taking requests
        of that kind until batch_size rows or max_wait."""
        with self._cv:
            while not self._stop.is_set():
                kind = self._oldest_kind()
                if kind is not None:
                    break
                self._cv.wait(timeout=0.1)
            else:
                return []
            batch: List[_Request] = []
            rows = 0
            deadline = time.monotonic() + self.max_wait
            while not self._stop.is_set():
                q = self._queues[kind]
                while q and rows < self.batch_size:
                    req = q.popleft()
                    batch.append(req)
                    rows += req.payload.shape[0]
                if rows >= self.batch_size:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            return batch

    def _run_batch(self, kind: str, stacked: torch.Tensor) -> torch.Tensor:
        """The model on ``stacked`` (on the device) in chunks of batch_size,
        each short chunk padded on the device; only valid rows come back."""
        outs = []
        for s in range(0, stacked.shape[0], self.batch_size):
            chunk = stacked[s:s + self.batch_size]
            k = chunk.shape[0]
            if k < self.batch_size:
                pad = chunk[-1:].expand(self.batch_size - k, *chunk.shape[1:])
                chunk = torch.cat([chunk, pad])
            if self.mesh is not None:
                self._in_batch = True
                self._broadcast(list(self._fns).index(kind), chunk)
            outs.append(self._fns[kind](chunk)[:k].cpu())
            self._in_batch = False
            self.calls[kind] += 1
        return torch.cat(outs)

    def _broadcast(self, code: int, chunk: Optional[torch.Tensor] = None) -> None:
        """Rank 0: a batch's header (kind, dtype, shape) and rows to every rank."""
        header = torch.full((8,), 0, dtype=torch.int64, device=self.device)
        header[0] = code
        if chunk is not None:
            header[1] = _DTYPES.index(chunk.dtype)
            header[2] = chunk.ndim
            header[3:3 + chunk.ndim] = torch.tensor(chunk.shape)
        dist.broadcast(header, src=0)
        if chunk is not None:
            dist.broadcast(chunk.contiguous(), src=0)

    def _work(self) -> None:
        """A worker rank: run each broadcast batch until the stop; an error
        ends the loop."""
        kinds = list(self._fns)
        while True:
            header = torch.empty(8, dtype=torch.int64, device=self.device)
            dist.broadcast(header, src=0)
            code, dtype, ndim = (int(v) for v in header[:3])
            if code == _STOP:
                return
            chunk = torch.empty([int(v) for v in header[3:3 + ndim]], dtype=_DTYPES[dtype],
                                device=self.device)
            dist.broadcast(chunk, src=0)
            with torch.no_grad():
                self._fns[kinds[code]](chunk)

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect_batch()
            if not batch:
                continue
            kind = batch[0].kind
            try:
                with torch.no_grad():
                    stacked = torch.cat([r.payload.to(self.device) for r in batch])
                    result = self._run_batch(kind, stacked)
            except Exception as e:
                for r in batch:
                    r.future.set_exception(e)
                if self._in_batch:  # the ranks are out of step: serve no more
                    self._stop.set()
                    self._fail_pending(RuntimeError(f"VTPServer stopped: a batch failed on the "
                                                    f"mesh ({e!r})"))
                    return
                continue
            off = 0
            for r in batch:
                k = r.payload.shape[0]
                r.future.set_result(result[off:off + k])
                off += k
