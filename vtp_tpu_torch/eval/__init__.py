"""Eval harnesses (port of ``vtp_tpu/eval``): the reconstruction eval
(PSNR, SSIM, LPIPS, rFID) and ImageNet zero-shot classification. The
linear probe is not ported."""

from vtp_tpu_torch.eval.reconstruction import evaluate_reconstruction
from vtp_tpu_torch.eval.zero_shot import (
    build_zero_shot_classifier,
    evaluate_zero_shot,
    load_imagenet_classnames,
    load_openai_templates,
)

__all__ = ["build_zero_shot_classifier", "evaluate_reconstruction", "evaluate_zero_shot",
           "load_imagenet_classnames", "load_openai_templates"]
