"""Parameter synchronization helpers and weight interop."""

from .interop import params_from_jax
from .params import allreduce_parameters, broadcast_parameters

__all__ = ["broadcast_parameters", "allreduce_parameters", "params_from_jax"]
