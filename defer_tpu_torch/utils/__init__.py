from .config import DeferConfig, resolve_device
from .convert import params_from_jax, params_to_device, params_to_jax
from .metrics import PipelineMetrics

__all__ = ["DeferConfig", "resolve_device", "params_from_jax",
           "params_to_device", "params_to_jax", "PipelineMetrics"]
