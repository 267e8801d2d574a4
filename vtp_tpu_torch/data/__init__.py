"""Eval data: the class-per-directory image dataset and the threaded
loader (port of ``vtp_tpu/data``, less the SSL crops; the native loader is
``data/native_loader.py``), and the zero-shot eval's classnames and prompt
templates (``imagenet_classnames.json``, ``openai_imagenet_templates.json``)."""

from vtp_tpu_torch.data.imagefolder import ImageFolder, list_image_files
from vtp_tpu_torch.data.loader import DataLoader, InfiniteSampler, ShardedSampler

__all__ = ["DataLoader", "ImageFolder", "InfiniteSampler", "ShardedSampler", "list_image_files"]
