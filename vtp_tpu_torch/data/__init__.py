"""Data: the class-per-directory image dataset, the threaded loader and
the multi-crop SSL pipeline (port of ``vtp_tpu/data``; the native loader is
``data/native_loader.py``), and the zero-shot eval's classnames and prompt
templates (``imagenet_classnames.json``, ``openai_imagenet_templates.json``)."""

from vtp_tpu_torch.data.imagefolder import ImageFolder, list_image_files
from vtp_tpu_torch.data.loader import DataLoader, InfiniteSampler, ShardedSampler
from vtp_tpu_torch.data.ssl_crops import (
    MultiCropDataset,
    MultiCropTransform,
    collate_multicrop,
    make_mask_bookkeeping,
    random_resized_crop,
)

__all__ = ["DataLoader", "ImageFolder", "InfiniteSampler", "MultiCropDataset",
           "MultiCropTransform", "ShardedSampler", "collate_multicrop", "list_image_files",
           "make_mask_bookkeeping", "random_resized_crop"]
