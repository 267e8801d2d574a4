"""The latent DiT: model, flow-matching transport, training step and
sampler (port of ``vtp_tpu/dit``)."""

from vtp_tpu_torch.dit.model import DIT_PRESETS, DiT, DiTConfig, dit_forward, init_dit_params
from vtp_tpu_torch.dit.train import DiTTrainConfig, build_dit_train_step, init_dit_state
from vtp_tpu_torch.dit.transport import euler_sample, sample_timesteps, training_losses

__all__ = [
    "DiTConfig",
    "dit_forward",
    "init_dit_params",
    "DIT_PRESETS",
    "sample_timesteps",
    "training_losses",
    "euler_sample",
    "DiTTrainConfig",
    "build_dit_train_step",
    "init_dit_state",
    "DiT",
]
