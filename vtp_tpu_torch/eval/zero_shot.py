"""ImageNet zero-shot classification (port of ``vtp_tpu/eval/zero_shot.py``;
behavioural reference ``tools/test_zero_shot_hf.py``).

The 1000 classnames and 80 OpenAI prompt templates are the port's own
copies (``vtp_tpu_torch/data/*.json``). The classifier is built a chunk of
classes at a time (every template of each class through the CLIP text
tower, the mean over templates, renormalised); the eval scores
``100 * image_feature @ classifier`` and counts top-1 and top-5 hits.
The 80,000-text BPE pass is cached on disk under ``$VTP_CACHE_DIR`` when
that is set (and redone otherwise).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vtp_tpu_torch.models.vtp_model import l2_normalize

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
CACHE_ENV = "VTP_CACHE_DIR"


def load_imagenet_classnames() -> List[str]:
    with open(os.path.join(_DATA_DIR, "imagenet_classnames.json")) as f:
        return json.load(f)


def load_openai_templates() -> List[str]:
    """The 80 prompt templates, as format strings ('a photo of a {}.')."""
    with open(os.path.join(_DATA_DIR, "openai_imagenet_templates.json")) as f:
        return json.load(f)


def _token_cache_path(classnames, templates, context_length: int) -> Optional[str]:
    cache_dir = os.environ.get(CACHE_ENV)
    if not cache_dir:
        return None
    h = hashlib.sha256(json.dumps([list(classnames), list(templates), context_length]).encode())
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"zeroshot_tokens_{h.hexdigest()[:16]}.npy")


def tokenize_classifier_prompts(tokenizer, classnames: Sequence[str], templates: Sequence[str],
                                context_length: int = 77) -> np.ndarray:
    """(num_classes * num_templates, L) token ids, class-major, cached on
    disk under ``$VTP_CACHE_DIR`` when it is set."""
    path = _token_cache_path(classnames, templates, context_length)
    if path and os.path.exists(path):
        return np.load(path)
    tokens = tokenizer([t.format(c) for c in classnames for t in templates],
                       context_length=context_length)
    if path:
        np.save(path, tokens)
    return tokens


@torch.no_grad()
def build_zero_shot_classifier(model, tokenizer, classnames: Optional[Sequence[str]] = None,
                               templates: Optional[Sequence[str]] = None,
                               num_classes_per_batch: int = 10,
                               compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                               progress: bool = False) -> torch.Tensor:
    """-> (embed_dim, num_classes) fp32 classifier on the model's device
    (test_zero_shot_hf.py:342-394)."""
    classnames = classnames if classnames is not None else load_imagenet_classnames()
    templates = templates if templates is not None else load_openai_templates()
    device = next(model.parameters()).device
    n_t = len(templates)
    tokens = tokenize_classifier_prompts(tokenizer, classnames, templates,
                                         context_length=model.config.text_context_length)
    tokens = torch.as_tensor(tokens.astype(np.int64)).reshape(len(classnames), n_t, -1)
    steps = range(0, len(classnames), num_classes_per_batch)
    if progress:
        from tqdm import tqdm  # type: ignore

        steps = tqdm(list(steps), desc="building classifier")
    cols = []
    for start in steps:
        chunk = tokens[start: start + num_classes_per_batch].to(device)
        nc = chunk.shape[0]
        feats = model.get_clip_text_feature(chunk.reshape(nc * n_t, -1), True, compute_dtype)
        feats = feats.float().reshape(nc, n_t, -1).mean(1)
        cols.append(l2_normalize(feats).t())
    return torch.cat(cols, dim=1)


def topk_counts(logits: torch.Tensor, targets: torch.Tensor,
                ks: Tuple[int, ...] = (1, 5)) -> List[torch.Tensor]:
    """Top-k hit counts, fp32 scalars (test_zero_shot_hf.py:312-316)."""
    pred = logits.topk(max(ks), dim=-1).indices  # (B, max_k)
    correct = pred == targets[:, None]
    return [correct[:, :k].sum().float() for k in ks]


@torch.no_grad()
def evaluate_zero_shot(model, classifier: torch.Tensor, dataloader,
                       compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                       progress: bool = False) -> Tuple[float, float]:
    """(top-1 %, top-5 %) over ``dataloader``'s (images, targets) batches,
    images (B, 3, S, S) fp32 NCHW already resized and ImageNet-normalised
    (test_zero_shot_hf.py:401-441)."""
    device = classifier.device
    it = dataloader
    if progress:
        from tqdm import tqdm  # type: ignore

        it = tqdm(dataloader, desc="zero-shot eval")
    top1 = top5 = n = 0.0
    for images, targets in it:
        images = torch.as_tensor(images).to(device)
        targets = torch.as_tensor(np.asarray(targets) if not isinstance(targets, torch.Tensor)
                                  else targets).to(device)
        feats = model.get_clip_image_feature(images, True, compute_dtype)
        logits = 100.0 * feats @ classifier.to(feats.dtype)
        c1, c5 = topk_counts(logits, targets)
        top1 += c1.item()
        top5 += c5.item()
        n += images.shape[0]
    return top1 / n * 100.0, top5 / n * 100.0
