"""The FID Inception-v3 feature extractor (port of
``vtp_tpu/metrics/inception.py``): the pool3 graph (2048-d) and a
converter from a torch state dict (pytorch_fid's or torchvision's
naming).

* fid variant (pytorch_fid's pt_inception-2015-12-05, what published FID
  and rFID figures are defined on): the [0, 1] input is scaled to
  [-1, 1]; InceptionA/C pool branches average without the padding
  (count_include_pad=False); Mixed_7c's pool branch is a max pool.
* torchvision IMAGENET1K_V1 (``fid_variant=False``): the reference's
  manual fallback.

Inputs of another size are resized to 299 bilinearly with half-pixel
centres, as ``jax.image.resize``: no antialiasing when upsampling (the
256 -> 299 of the eval), antialiased when downsampling. Convolutions are
``conv2d`` in exact fp32 (TF32 off on the card); batch norm is folded at
inference (eps 1e-3). Weights come from ``$VTP_INCEPTION_WEIGHTS`` (a
torch .pt/.pth state dict); without them ``inception_available()`` is
False and callers skip rFID, as the reference does without pytorch_fid.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vtp_tpu_torch.models.pixel_decoder import exact_fp32

Params = Dict[str, Dict]
WEIGHTS_ENV = "VTP_INCEPTION_WEIGHTS"


def find_weights() -> Optional[str]:
    path = os.environ.get(WEIGHTS_ENV, "")
    return path if path and os.path.exists(path) else None


def inception_available() -> bool:
    return find_weights() is not None


# ------------------------------------------------------------ primitives


def _conv_bn(x: torch.Tensor, p: Dict, stride: int = 1, padding=(0, 0)) -> torch.Tensor:
    """BasicConv2d: conv (no bias) + batch norm (eps 1e-3, inference) + relu."""
    if isinstance(padding, int):
        padding = (padding, padding)
    out = F.conv2d(x, p["w"], stride=stride, padding=padding)
    scale = p["gamma"] * torch.rsqrt(p["var"] + 1e-3)
    shift = p["beta"] - p["mean"] * scale
    return torch.relu(out * scale[None, :, None, None] + shift[None, :, None, None])


def _maxpool(x: torch.Tensor, k: int = 3, s: int = 2, pad: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, k, s, pad)


def _avgpool3(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    """3x3 stride-1 pad-1 average pool."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


# --------------------------------------------------------------- blocks


def _inception_a(x, p, fid: bool):
    b1 = _conv_bn(x, p["branch1x1"])
    b5 = _conv_bn(_conv_bn(x, p["branch5x5_1"]), p["branch5x5_2"], padding=2)
    b3 = _conv_bn(x, p["branch3x3dbl_1"])
    b3 = _conv_bn(b3, p["branch3x3dbl_2"], padding=1)
    b3 = _conv_bn(b3, p["branch3x3dbl_3"], padding=1)
    bp = _conv_bn(_avgpool3(x, count_include_pad=not fid), p["branch_pool"])
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(x, p):
    b3 = _conv_bn(x, p["branch3x3"], stride=2)
    bd = _conv_bn(x, p["branch3x3dbl_1"])
    bd = _conv_bn(bd, p["branch3x3dbl_2"], padding=1)
    bd = _conv_bn(bd, p["branch3x3dbl_3"], stride=2)
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def _inception_c(x, p, fid: bool):
    b1 = _conv_bn(x, p["branch1x1"])
    b7 = _conv_bn(x, p["branch7x7_1"])
    b7 = _conv_bn(b7, p["branch7x7_2"], padding=(0, 3))
    b7 = _conv_bn(b7, p["branch7x7_3"], padding=(3, 0))
    bd = _conv_bn(x, p["branch7x7dbl_1"])
    bd = _conv_bn(bd, p["branch7x7dbl_2"], padding=(3, 0))
    bd = _conv_bn(bd, p["branch7x7dbl_3"], padding=(0, 3))
    bd = _conv_bn(bd, p["branch7x7dbl_4"], padding=(3, 0))
    bd = _conv_bn(bd, p["branch7x7dbl_5"], padding=(0, 3))
    bp = _conv_bn(_avgpool3(x, count_include_pad=not fid), p["branch_pool"])
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(x, p):
    b3 = _conv_bn(_conv_bn(x, p["branch3x3_1"]), p["branch3x3_2"], stride=2)
    b7 = _conv_bn(x, p["branch7x7x3_1"])
    b7 = _conv_bn(b7, p["branch7x7x3_2"], padding=(0, 3))
    b7 = _conv_bn(b7, p["branch7x7x3_3"], padding=(3, 0))
    b7 = _conv_bn(b7, p["branch7x7x3_4"], stride=2)
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def _inception_e(x, p, pool: str, fid: bool):
    b1 = _conv_bn(x, p["branch1x1"])
    b3 = _conv_bn(x, p["branch3x3_1"])
    b3 = torch.cat([_conv_bn(b3, p["branch3x3_2a"], padding=(0, 1)),
                    _conv_bn(b3, p["branch3x3_2b"], padding=(1, 0))], dim=1)
    bd = _conv_bn(x, p["branch3x3dbl_1"])
    bd = _conv_bn(bd, p["branch3x3dbl_2"], padding=1)
    bd = torch.cat([_conv_bn(bd, p["branch3x3dbl_3a"], padding=(0, 1)),
                    _conv_bn(bd, p["branch3x3dbl_3b"], padding=(1, 0))], dim=1)
    if pool == "max":  # pytorch_fid's FIDInceptionE_2 (Mixed_7c)
        bp = _maxpool(x, k=3, s=1, pad=1)
    else:
        bp = _avgpool3(x, count_include_pad=not fid)
    bp = _conv_bn(bp, p["branch_pool"])
    return torch.cat([b1, b3, bd, bp], dim=1)


# -------------------------------------------------------------- network


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 3, 299, 299), bilinear with half-pixel centres
    (``jax.image.resize(..., "bilinear")``: antialiased only when an axis
    shrinks)."""
    if x.shape[2] == 299 and x.shape[3] == 299:
        return x
    shrink = x.shape[2] > 299 or x.shape[3] > 299
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=shrink)


@torch.no_grad()
def inception_features(params: Params, x: torch.Tensor, *, fid_variant: bool = True) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> (B, 2048) pool3 features, fp32."""
    with exact_fp32():
        x = resize_299(x.float())
        if fid_variant:
            x = 2.0 * x - 1.0
        x = _conv_bn(x, params["Conv2d_1a_3x3"], stride=2)
        x = _conv_bn(x, params["Conv2d_2a_3x3"])
        x = _conv_bn(x, params["Conv2d_2b_3x3"], padding=1)
        x = _maxpool(x)
        x = _conv_bn(x, params["Conv2d_3b_1x1"])
        x = _conv_bn(x, params["Conv2d_4a_3x3"])
        x = _maxpool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = _inception_a(x, params[name], fid_variant)
        x = _inception_b(x, params["Mixed_6a"])
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = _inception_c(x, params[name], fid_variant)
        x = _inception_d(x, params["Mixed_7a"])
        x = _inception_e(x, params["Mixed_7b"], "avg", fid_variant)
        x = _inception_e(x, params["Mixed_7c"], "max" if fid_variant else "avg", fid_variant)
        return x.mean((2, 3))  # adaptive average pool -> (B, 2048)


# ------------------------------------------------------------- converter


def convert_inception_state_dict(sd: Dict[str, np.ndarray], device="cuda") -> Params:
    """A torch state dict (torchvision or pytorch_fid naming; numpy arrays
    or tensors) -> the params ``inception_features`` takes, fp32 on
    ``device``."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    params: Params = {}
    for k in sd:
        if not k.endswith(".conv.weight"):
            continue
        pref = k[: -len(".conv.weight")]
        top, _, leaf = pref.partition(".")
        entry = {"w": t(sd[f"{pref}.conv.weight"]), "gamma": t(sd[f"{pref}.bn.weight"]),
                 "beta": t(sd[f"{pref}.bn.bias"]), "mean": t(sd[f"{pref}.bn.running_mean"]),
                 "var": t(sd[f"{pref}.bn.running_var"])}
        if leaf:
            params.setdefault(top, {})[leaf] = entry
        else:
            params[top] = entry
    return params


def _conv_shapes():
    """(prefix, cin, cout, kernel) of every BasicConv2d, torchvision naming."""
    convs = [("Conv2d_1a_3x3", 3, 32, (3, 3)), ("Conv2d_2a_3x3", 32, 32, (3, 3)),
             ("Conv2d_2b_3x3", 32, 64, (3, 3)), ("Conv2d_3b_1x1", 64, 80, (1, 1)),
             ("Conv2d_4a_3x3", 80, 192, (3, 3))]
    for name, cin, pf in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64), ("Mixed_5d", 288, 64)):
        convs += [(f"{name}.branch1x1", cin, 64, (1, 1)), (f"{name}.branch5x5_1", cin, 48, (1, 1)),
                  (f"{name}.branch5x5_2", 48, 64, (5, 5)),
                  (f"{name}.branch3x3dbl_1", cin, 64, (1, 1)),
                  (f"{name}.branch3x3dbl_2", 64, 96, (3, 3)),
                  (f"{name}.branch3x3dbl_3", 96, 96, (3, 3)),
                  (f"{name}.branch_pool", cin, pf, (1, 1))]
    convs += [("Mixed_6a.branch3x3", 288, 384, (3, 3)), ("Mixed_6a.branch3x3dbl_1", 288, 64, (1, 1)),
              ("Mixed_6a.branch3x3dbl_2", 64, 96, (3, 3)),
              ("Mixed_6a.branch3x3dbl_3", 96, 96, (3, 3))]
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)):
        convs += [(f"{name}.branch1x1", 768, 192, (1, 1)), (f"{name}.branch7x7_1", 768, c7, (1, 1)),
                  (f"{name}.branch7x7_2", c7, c7, (1, 7)), (f"{name}.branch7x7_3", c7, 192, (7, 1)),
                  (f"{name}.branch7x7dbl_1", 768, c7, (1, 1)),
                  (f"{name}.branch7x7dbl_2", c7, c7, (7, 1)),
                  (f"{name}.branch7x7dbl_3", c7, c7, (1, 7)),
                  (f"{name}.branch7x7dbl_4", c7, c7, (7, 1)),
                  (f"{name}.branch7x7dbl_5", c7, 192, (1, 7)),
                  (f"{name}.branch_pool", 768, 192, (1, 1))]
    convs += [("Mixed_7a.branch3x3_1", 768, 192, (1, 1)), ("Mixed_7a.branch3x3_2", 192, 320, (3, 3)),
              ("Mixed_7a.branch7x7x3_1", 768, 192, (1, 1)),
              ("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7)),
              ("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1)),
              ("Mixed_7a.branch7x7x3_4", 192, 192, (3, 3))]
    for name, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        convs += [(f"{name}.branch1x1", cin, 320, (1, 1)), (f"{name}.branch3x3_1", cin, 384, (1, 1)),
                  (f"{name}.branch3x3_2a", 384, 384, (1, 3)),
                  (f"{name}.branch3x3_2b", 384, 384, (3, 1)),
                  (f"{name}.branch3x3dbl_1", cin, 448, (1, 1)),
                  (f"{name}.branch3x3dbl_2", 448, 384, (3, 3)),
                  (f"{name}.branch3x3dbl_3a", 384, 384, (1, 3)),
                  (f"{name}.branch3x3dbl_3b", 384, 384, (3, 1)),
                  (f"{name}.branch_pool", cin, 192, (1, 1))]
    return convs


def random_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded torch-layout state dict of the whole network (fp32 numpy):
    He-scaled convolutions and batch-norm statistics near the identity, so
    activations stay in range through the 2048-wide graph. Stands in for
    the released weights, which the repository does not hold."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for pref, cin, cout, (kh, kw) in _conv_shapes():
        std = np.sqrt(2.0 / (cin * kh * kw))
        sd[f"{pref}.conv.weight"] = (rng.standard_normal((cout, cin, kh, kw)) * std).astype(np.float32)
        sd[f"{pref}.bn.weight"] = (1.0 + 0.1 * rng.standard_normal(cout)).astype(np.float32)
        sd[f"{pref}.bn.bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        sd[f"{pref}.bn.running_mean"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        sd[f"{pref}.bn.running_var"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    return sd


def load_inception_feature_fn(weights_path: Optional[str] = None, *, fid_variant: bool = True,
                              device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """``feature_fn(images01_nchw) -> (B, 2048)`` on ``device``, from the
    state dict at ``weights_path`` or ``$VTP_INCEPTION_WEIGHTS``; raises
    FileNotFoundError when there is none."""
    path = weights_path or find_weights()
    if path is None:
        raise FileNotFoundError(
            f"Inception weights not found; set {WEIGHTS_ENV} to a pytorch_fid "
            "pt_inception-2015-12-05.pth or torchvision inception_v3 state dict.")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    params = convert_inception_state_dict(sd, device=device)
    return lambda x: inception_features(params, x.to(device), fid_variant=fid_variant)
