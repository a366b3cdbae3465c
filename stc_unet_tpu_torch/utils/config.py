"""Python-file config system with ``_base_`` inheritance and CLI overrides.

The port's own copy of ``stc_unet_tpu/utils/config.py`` (the JAX package's
``utils`` pulls in jax at import, so the port carries this module instead
of importing it). ``Config.fromfile`` with ``_base_`` multi-inheritance,
``merge_from_dict`` for dotted-key overrides; reference ``my_config/*.py``
files load verbatim.
"""
from __future__ import annotations

import copy
import os
import os.path as osp
import pprint
import types
from typing import Any, Dict, List, Union

BASE_KEY = '_base_'
DELETE_KEY = '_delete_'
RESERVED_KEYS = ('filename', 'text', 'pretty_text')


class ConfigDict(dict):
    """dict with attribute access, raising AttributeError for missing keys."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            items = arg.items() if isinstance(arg, dict) else arg
            for k, v in items:
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"'{self.__class__.__name__}' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        self[name] = _to_config_dict(value)

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def __setitem__(self, key, value):
        super().__setitem__(key, _to_config_dict(value))

    def __deepcopy__(self, memo):
        other = self.__class__()
        memo[id(self)] = other
        for k, v in self.items():
            dict.__setitem__(other, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return other

    def get(self, key, default=None):
        return self[key] if key in self else default

    def pop(self, key, *args):
        return super().pop(key, *args)

    def copy(self):
        return copy.copy(self)

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]


def _to_config_dict(obj):
    if isinstance(obj, ConfigDict):
        return obj
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge_a_into_b(a: dict, b: dict, allow_list_keys: bool = True) -> dict:
    """Deep-merge dict ``a`` (override) into dict ``b`` (base).

    ``a[k]['_delete_']=True`` replaces ``b[k]`` wholesale instead of merging.
    Integer string keys may index into base lists when ``allow_list_keys``.
    """
    b = copy.deepcopy(b)
    for k, v in a.items():
        if allow_list_keys and k.isdigit() and isinstance(b, list):
            k = int(k)
            if len(b) <= k:
                raise KeyError(f'Index {k} exceeds list length {len(b)}')
            b[k] = _merge_a_into_b(v, b[k]) if isinstance(v, dict) else v
        elif isinstance(v, dict):
            if k in b and not v.pop(DELETE_KEY, False):
                if not isinstance(b[k], (dict, list)):
                    raise TypeError(
                        f'Cannot merge dict into non-dict value for key {k}: '
                        f'{type(b[k])}. Use _delete_=True to replace it.')
                b[k] = _merge_a_into_b(v, b[k], allow_list_keys)
            else:
                v = dict(v)
                v.pop(DELETE_KEY, None)
                b[k] = copy.deepcopy(v)
        else:
            b[k] = v
    return b


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    with open(filename, encoding='utf-8') as f:
        code = f.read()
    module = types.ModuleType('_cfg_')
    module.__file__ = filename
    exec(compile(code, filename, 'exec'), module.__dict__)
    return {
        k: v for k, v in module.__dict__.items()
        if not k.startswith('__') and not isinstance(v, types.ModuleType)
        and not isinstance(v, types.FunctionType) and not isinstance(v, type)
    }


def _load_file(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f'Config file not found: {filename}')
    if not filename.endswith('.py'):
        raise ValueError(f'Only .py configs are supported, got {filename}')
    cfg_dict = _exec_pyfile(filename)

    base = cfg_dict.pop(BASE_KEY, None)
    if base is None:
        return cfg_dict
    base_files = [base] if isinstance(base, str) else list(base)
    merged: Dict[str, Any] = {}
    cfg_dir = osp.dirname(filename)
    for bf in base_files:
        base_dict = _load_file(osp.join(cfg_dir, bf))
        dup = set(merged) & set(base_dict)
        if dup:
            raise KeyError(f'Duplicate keys across _base_ files: {dup}')
        merged.update(base_dict)
    return _merge_a_into_b(cfg_dict, merged)


class Config:
    """A config object backed by a :class:`ConfigDict`.

    Supports attribute access, ``fromfile`` loading of python configs with
    ``_base_`` inheritance, ``merge_from_dict`` for dotted-key CLI overrides,
    and text dumping.
    """

    @staticmethod
    def fromfile(filename: Union[str, os.PathLike]) -> 'Config':
        filename = str(filename)
        cfg_dict = _load_file(filename)
        with open(filename, encoding='utf-8') as f:
            text = f.read()
        return Config(cfg_dict, cfg_text=text, filename=filename)

    @staticmethod
    def fromstring(cfg_str: str, file_format: str = '.py') -> 'Config':
        import tempfile
        with tempfile.NamedTemporaryFile(
                'w', suffix=file_format, delete=False) as f:
            f.write(cfg_str)
            path = f.name
        try:
            return Config.fromfile(path)
        finally:
            os.remove(path)

    def __init__(self, cfg_dict: dict = None, cfg_text: str = None,
                 filename: str = None):
        if cfg_dict is None:
            cfg_dict = {}
        if not isinstance(cfg_dict, dict):
            raise TypeError(f'cfg_dict must be a dict, got {type(cfg_dict)}')
        for key in cfg_dict:
            if key in RESERVED_KEYS:
                raise KeyError(f'{key} is reserved for Config')
        super().__setattr__('_cfg_dict', _to_config_dict(cfg_dict))
        super().__setattr__('_filename', filename)
        super().__setattr__('_text', cfg_text or '')

    # -- mapping protocol ---------------------------------------------------
    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = value

    def __getitem__(self, key):
        return self._cfg_dict[key]

    def __setitem__(self, key, value):
        self._cfg_dict[key] = value

    def __contains__(self, key):
        return key in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self):
        return len(self._cfg_dict)

    def __repr__(self):
        return f'Config (path: {self.filename}): {self._cfg_dict!r}'

    def __deepcopy__(self, memo):
        other = Config(copy.deepcopy(dict(self._cfg_dict), memo),
                       cfg_text=self._text, filename=self._filename)
        return other

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def pop(self, key, *args):
        return self._cfg_dict.pop(key, *args)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def values(self):
        return self._cfg_dict.values()

    # -- properties ---------------------------------------------------------
    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    @property
    def pretty_text(self):
        return _format_dict(dict(self._cfg_dict))

    def to_dict(self):
        return _plain(dict(self._cfg_dict))

    # -- mutation -----------------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any],
                        allow_list_keys: bool = True):
        """Merge dotted-key overrides, e.g. ``{'model.backbone.depth': 50}``.

        Equivalent of the reference's ``cfg.merge_from_dict(args.cfg_options)``
        (``tools/train.py:116``).
        """
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split('.')
            for sub in keys[:-1]:
                d = d.setdefault(sub, {})
            d[keys[-1]] = v
        merged = _merge_a_into_b(option_cfg, dict(self._cfg_dict),
                                 allow_list_keys=allow_list_keys)
        super().__setattr__('_cfg_dict', _to_config_dict(merged))

    def dump(self, file: str = None) -> str:
        text = self.pretty_text
        if file is not None:
            with open(file, 'w', encoding='utf-8') as f:
                f.write(text)
        return text


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _format_dict(d: dict) -> str:
    """Render a config dict back to executable python source."""
    lines: List[str] = []
    for k, v in d.items():
        lines.append(f'{k} = {pprint.pformat(_plain(v), width=100, sort_dicts=False)}')
    return '\n'.join(lines) + '\n'
