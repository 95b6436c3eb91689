"""Differentiable rendering: pixel-radiance gradients with respect to material
and emitter parameters, and the inverse-rendering train step."""

from raysnail_tpu_torch.diff.params import SceneParams, extract_params, inject_params
from raysnail_tpu_torch.diff.train import make_loss_fn, make_train_step

__all__ = ["SceneParams", "extract_params", "inject_params",
           "make_loss_fn", "make_train_step"]
