"""Eval harnesses (port of ``vtp_tpu/eval``): the reconstruction eval
(PSNR, SSIM, LPIPS, rFID), ImageNet zero-shot classification and linear
probing on frozen trunk features."""

from vtp_tpu_torch.eval.linear_probe import ProbeConfig, evaluate_linear_probe
from vtp_tpu_torch.eval.reconstruction import evaluate_reconstruction
from vtp_tpu_torch.eval.zero_shot import (
    build_zero_shot_classifier,
    evaluate_zero_shot,
    load_imagenet_classnames,
    load_openai_templates,
)

__all__ = ["ProbeConfig", "build_zero_shot_classifier", "evaluate_linear_probe",
           "evaluate_reconstruction", "evaluate_zero_shot", "load_imagenet_classnames",
           "load_openai_templates"]
