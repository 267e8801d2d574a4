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

``mesh=`` and ``tp_head_major=`` (data- and tensor-parallel serving) are
not ported and raise.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import torch

from vtp_tpu_torch.models.vtp_model import VTPModel

_seq = itertools.count()


class _Request:
    __slots__ = ("kind", "payload", "future", "seq")

    def __init__(self, kind: str, payload: torch.Tensor):
        self.kind = kind
        self.payload = payload
        self.future: Future = Future()
        self.seq = next(_seq)


class VTPServer:
    """Batched inference server (threaded dispatcher) on the model's device."""

    def __init__(self, model: VTPModel, batch_size: int = 32, max_wait_ms: float = 5.0,
                 warmup: bool = True, mesh=None, tp_head_major: bool = False):
        if mesh is not None or tp_head_major:
            raise NotImplementedError("mesh= and tp_head_major= serving are not ported")
        self.model = model
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self._stop = threading.Event()
        enc = model.encode_dtype
        self._fns: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
            "encode": model.get_reconstruction_latents,
            "decode": model.get_latents_decoded_images,
            "clip_image": lambda x: model.get_clip_image_feature(x, True, enc),
            "clip_text": lambda x: model.get_clip_text_feature(x, True, enc),
        }
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
        request is left pending."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=30)
        with self._cv:
            pending = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
        for r in pending:
            r.future.set_exception(RuntimeError("VTPServer shut down with request pending"))

    # -------------------------------------------------------- internals

    def _run(self, warmup: bool, ready: Future) -> None:
        try:
            if warmup:
                self._warmup()
        except Exception as e:
            ready.set_exception(e)
            return
        ready.set_result(None)
        self._loop()

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
            outs.append(self._fns[kind](chunk)[:k].cpu())
            self.calls[kind] += 1
        return torch.cat(outs)

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
                continue
            off = 0
            for r in batch:
                k = r.payload.shape[0]
                r.future.set_result(result[off:off + k])
                off += k
