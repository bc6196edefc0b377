"""Parameter synchronization helpers, weight interop and input feeding."""

from .data import prefetch_to_device
from .interop import params_from_jax
from .params import (allreduce_parameters, broadcast_optimizer_state,
                     broadcast_parameters)
from .torch_interop import resnet_from_torch, vgg_from_torch

__all__ = ["broadcast_parameters", "allreduce_parameters",
           "broadcast_optimizer_state", "params_from_jax",
           "prefetch_to_device", "resnet_from_torch", "vgg_from_torch"]
