from .config import Config, ConfigDict
from .jax_convert import jax_to_torch_state
from .registry import Registry, build_from_cfg
from .util_distribution import (default_data_mesh, get_dist_info, init_dist,
                                mesh_group)

__all__ = ['Config', 'ConfigDict', 'Registry', 'build_from_cfg',
           'default_data_mesh', 'get_dist_info', 'init_dist',
           'jax_to_torch_state', 'mesh_group']
