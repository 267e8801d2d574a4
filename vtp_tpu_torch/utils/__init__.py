"""Host-side helpers of the port: image preprocessing (``image``), the int8
W8A8 serving tier (``quantization``), the serving-time parameter transforms
(``params``), resolution buckets (``buckets``) and small utilities
(``misc``, imported as a module: it builds on ``models.blocks``)."""

from vtp_tpu_torch.utils.buckets import pick_bucket, snap_to_bucket
from vtp_tpu_torch.utils.params import cast_matmul_params, fuse_ffn_params, param_count, tree_bytes
from vtp_tpu_torch.utils.quantization import (
    Int8Weight,
    int8_linear,
    quantize_kernel,
    quantize_matmul_params,
)

__all__ = ["Int8Weight", "cast_matmul_params", "fuse_ffn_params", "int8_linear", "param_count",
           "pick_bucket", "quantize_kernel", "quantize_matmul_params", "snap_to_bucket",
           "tree_bytes"]
