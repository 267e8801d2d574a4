"""LPIPS, VGG16 flavour (port of ``vtp_tpu/metrics/lpips.py``; behavioural
reference ``vtp/utils/lpips.py:61-175``): scale the inputs, run VGG16's
features, tap the five relu outputs, unit-normalise each over channels,
square the difference, weight the channels by the learned 1x1 linear
heads, average over positions and sum over the taps.

Weights come from ``$VTP_LPIPS_WEIGHTS``: a full LPIPS state dict, or a
directory of ``.pth`` files (torchvision ``vgg16`` + the ``vgg.pth`` lin
heads) merged in name order, loaded with ``torch.load``. Without them
``LPIPS().available`` is False and callers skip LPIPS, as the reference
does. Convolutions are ``conv2d`` in exact fp32 (TF32 off on the card).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vtp_tpu_torch.models.pixel_decoder import exact_fp32

WEIGHTS_ENV = "VTP_LPIPS_WEIGHTS"
# torchvision vgg16 ``features`` conv indices and channel plan
VGG_CONVS = [
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
]
_POOL_BEFORE = {5, 10, 17, 24}  # conv indices preceded by a 2x2 max pool
_TAP_AFTER_CONV = (2, 7, 14, 21, 28)  # the five relu taps
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def find_weights() -> Optional[str]:
    path = os.environ.get(WEIGHTS_ENV, "")
    return path if path and os.path.exists(path) else None


def lpips_available() -> bool:
    return find_weights() is not None


def vgg16_taps(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    """VGG16 features with the five LPIPS relu taps; x: (B, 3, H, W)."""
    taps: List[torch.Tensor] = []
    for idx, _, _ in VGG_CONVS:
        if idx in _POOL_BEFORE:
            x = F.max_pool2d(x, 2, 2)
        x = torch.relu(F.conv2d(x, params[f"conv{idx}"]["w"], params[f"conv{idx}"]["b"],
                                padding=1))
        if idx in _TAP_AFTER_CONV:
            taps.append(x)
    return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(1, keepdim=True)) + eps)


@torch.no_grad()
def lpips_forward(params: Dict, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per image pair, (B,); inputs in [-1, 1], (B, 3, H, W)."""
    dev = img1.device
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=dev)[None, :, None, None]
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=dev)[None, :, None, None]
    with exact_fp32():
        taps0 = vgg16_taps(params["vgg"], (img1.float() - shift) / scale)
        taps1 = vgg16_taps(params["vgg"], (img2.float() - shift) / scale)
        total = 0.0
        for k in range(5):
            diff = (_unit_normalize(taps0[k]) - _unit_normalize(taps1[k])) ** 2
            score = (diff * params["lins"][k][None, :, None, None]).sum(1)  # (B, H, W)
            total = total + score.mean((1, 2))
    return total


def _slice_of(conv_idx: int) -> int:
    return 1 if conv_idx < 4 else 2 if conv_idx < 9 else 3 if conv_idx < 16 else \
        4 if conv_idx < 23 else 5


def convert_lpips_state_dict(sd: Dict[str, np.ndarray], device="cuda") -> Dict:
    """A full LPIPS torch state dict (``net.slice*`` / ``lin*``), or raw
    torchvision ``features.*`` merged with the lin heads (``lin{k}`` or
    ``lins.{k}``) -> the params ``lpips_forward`` takes, fp32 on
    ``device``."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    vgg: Dict[str, Dict] = {}
    for idx, _, _ in VGG_CONVS:
        for key in (f"net.slice{_slice_of(idx)}.{idx}.weight", f"features.{idx}.weight"):
            if key in sd:
                vgg[f"conv{idx}"] = {"w": t(sd[key]), "b": t(sd[key.replace("weight", "bias")])}
                break
        else:
            raise KeyError(f"missing vgg conv {idx}")
    lins = []
    for k in range(5):
        for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if key in sd:
                lins.append(t(np.asarray(sd[key], np.float32)[0, :, 0, 0]))  # (1, C, 1, 1) -> (C,)
                break
        else:
            raise KeyError(f"missing lin{k}")
    return {"vgg": vgg, "lins": lins}


def random_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded full LPIPS state dict in the torch layout (``net.slice*``,
    ``lin*``; fp32 numpy): He-scaled convolutions, non-negative lin heads.
    Stands in for the released weights, which the repository does not
    hold."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for idx, cin, cout in VGG_CONVS:
        key = f"net.slice{_slice_of(idx)}.{idx}"
        sd[f"{key}.weight"] = (rng.standard_normal((cout, cin, 3, 3))
                               * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        sd[f"{key}.bias"] = (0.01 * rng.standard_normal(cout)).astype(np.float32)
    for k, c in enumerate((64, 128, 256, 512, 512)):
        sd[f"lin{k}.model.1.weight"] = np.abs(0.1 * rng.standard_normal((1, c, 1, 1))).astype(np.float32)
    return sd


def _load_torch_weights(path: str) -> Dict[str, np.ndarray]:
    files = ([os.path.join(path, f) for f in sorted(os.listdir(path)) if f.endswith((".pth", ".pt"))]
             if os.path.isdir(path) else [path])
    sd: Dict[str, np.ndarray] = {}
    for f in files:
        part = torch.load(f, map_location="cpu", weights_only=True)
        sd.update({k: v.float().numpy() for k, v in part.items()})
    return sd


class LPIPS:
    """The reference's LPIPS class (test_reconstruction_hf.py:65-80): built
    from ``weights_path``, ``$VTP_LPIPS_WEIGHTS`` or a state dict already
    in memory (``state_dict``); ``available`` is False, and a call returns
    None, when there are no weights."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda",
                 state_dict: Optional[Dict[str, np.ndarray]] = None):
        self.params = None
        if state_dict is None:
            path = weights_path or find_weights()
            if path is None:
                return
            state_dict = _load_torch_weights(path)
        self.params = convert_lpips_state_dict(state_dict, device=device)

    @property
    def available(self) -> bool:
        return self.params is not None

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> Optional[torch.Tensor]:
        """img1, img2 in [-1, 1], (B, 3, H, W) -> (B,) distances, or None."""
        if self.params is None:
            return None
        return lpips_forward(self.params, img1, img2)
