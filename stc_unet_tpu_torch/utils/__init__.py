from .config import Config, ConfigDict
from .jax_convert import jax_to_torch_state
from .registry import Registry, build_from_cfg

__all__ = ['Config', 'ConfigDict', 'Registry', 'build_from_cfg',
           'jax_to_torch_state']
