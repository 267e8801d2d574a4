"""Batch loader on the native C++ ingest library (port of
``vtp_tpu/data/native_loader.py``).

Whole batches are decoded and preprocessed in the library's thread pool (no
Python in the pixel loop) by one producer thread, ``prefetch`` batches ahead
of the card. Batches are ``(images, labels)`` CPU tensors: (B, 3, T, T)
fp32 and (B,) int64. The loader raises when the library is unavailable; it
never falls back to PIL. An error in the producer reaches the consumer.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import torch

from vtp_tpu_torch.data.imagefolder import ImageFolder
from vtp_tpu_torch.data.loader import DataLoader
from vtp_tpu_torch.native import MODE_ADM_CROP, build_error, ingest_batch, native_available


class NativeImageLoader(DataLoader):
    """``DataLoader``'s sampling, batching and prefetch thread, with each
    batch decoded by one ``ingest_batch`` call in place of per-image
    transforms."""

    def __init__(
        self,
        dataset: ImageFolder,
        batch_size: int,
        *,
        target: int = 256,
        mode: int = MODE_ADM_CROP,
        aux: int = 0,
        mean: Sequence[float] = (0.485, 0.456, 0.406),
        std: Sequence[float] = (0.229, 0.224, 0.225),
        flip_all: bool = False,
        sampler: Optional[Sequence[int]] = None,
        num_threads: int = 0,
        prefetch: int = 3,
        drop_last: bool = False,
    ):
        if not native_available():
            raise RuntimeError(f"native ingest library unavailable: {build_error()}")
        super().__init__(dataset, batch_size, sampler=sampler, num_workers=1, prefetch=prefetch,
                         drop_last=drop_last)
        self.target = target
        self.mode = mode
        self.aux = aux
        self.mean = mean
        self.std = std
        self.flip_all = flip_all
        self.num_threads = num_threads

    def _batches(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        for bidx in self._index_batches():
            paths = [self.dataset.samples[i][0] for i in bidx]
            labels = torch.tensor([self.dataset.samples[i][1] for i in bidx], dtype=torch.int64)
            flips = [1] * len(paths) if self.flip_all else None
            yield ingest_batch(paths, self.target, mode=self.mode, aux=self.aux, mean=self.mean,
                               std=self.std, flips=flips, num_threads=self.num_threads), labels
