"""Registry: string-keyed factory binding config ``type=`` names to classes.

The port's own copy of ``stc_unet_tpu/utils/registry.py``: the same
``Registry``/``build_from_cfg`` vocabulary, so the reference configs build
the port's modules 1:1.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A string → class/callable registry with config-driven build.

    Example::

        BACKBONES = Registry('backbone')

        @BACKBONES.register_module()
        class UnetBackbone: ...

        model = BACKBONES.build(dict(type='UnetBackbone', in_channels=3))
    """

    def __init__(self, name: str, build_func: Optional[Callable] = None,
                 parent: Optional['Registry'] = None):
        self._name = name
        self._module_dict: Dict[str, Any] = {}
        self.parent = parent
        self.build_func = build_func or build_from_cfg

    def __len__(self):
        return len(self._module_dict)

    def __contains__(self, key):
        return self.get(key) is not None

    def __repr__(self):
        return (f'{self.__class__.__name__}(name={self._name}, '
                f'items={list(self._module_dict)})')

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str):
        """Look up a registered class by name (checks parent if set)."""
        obj = self._module_dict.get(key)
        if obj is None and self.parent is not None:
            obj = self.parent.get(key)
        return obj

    def _register(self, module, module_name=None, force=False):
        if not callable(module):
            raise TypeError(f'module must be callable, got {type(module)}')
        if module_name is None:
            module_name = module.__name__
        names = [module_name] if isinstance(module_name, str) else module_name
        for name in names:
            if not force and name in self._module_dict:
                raise KeyError(f'{name} is already registered in {self._name}')
            self._module_dict[name] = module

    def register_module(self, name=None, force=False, module=None):
        """Register a class. Usable as a plain decorator, with arguments, or
        as a function call: ``REG.register_module(module=Cls)``."""
        if module is not None:
            self._register(module, module_name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, module_name=name, force=force)
            return cls

        return _decorator

    def build(self, cfg: dict, default_args: Optional[dict] = None):
        return self.build_func(cfg, registry=self, default_args=default_args)


def build_from_cfg(cfg: dict, registry: Registry,
                   default_args: Optional[dict] = None):
    """Instantiate ``registry.get(cfg['type'])(**cfg-minus-type, **defaults)``.

    Mirrors the semantics the reference relies on from mmcv's
    ``build_from_cfg``: ``type`` may be a string key or a callable; keys in
    ``default_args`` only fill in when absent from cfg.
    """
    if not isinstance(cfg, dict):
        raise TypeError(f'cfg must be a dict, got {type(cfg)}')
    if 'type' not in cfg:
        if default_args is None or 'type' not in default_args:
            raise KeyError(f'cfg must contain the key "type": {cfg}')
    args = dict(cfg)
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not in the {registry.name} registry')
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or class, got {type(obj_type)}')
    try:
        return obj_cls(**args)
    except Exception as e:
        raise type(e)(f'{obj_cls.__name__}: {e}') from e
