"""Registry + build_from_cfg — the config-dispatch kernel.

mmaction2-compatible semantics (reference: mmaction/models/builder.py:9-16,
mmaction/datasets/builder.py:23-25 use mmcv.Registry): configs are plain dicts
with a ``type`` key naming a registered class; ``build_from_cfg`` pops ``type``
and instantiates the class with the remaining keys as kwargs.

This is a fresh implementation, not a copy of mmcv: a registry is a dict from
name -> callable with decorator-based registration, parent/child scopes are not
needed (the reference never uses them), and we add ``build`` as a bound method.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A string -> class map with decorator registration.

    >>> MODELS = Registry('models')
    >>> @MODELS.register_module()
    ... class Foo: ...
    >>> MODELS.build(dict(type='Foo'))
    """

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Callable]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f'Registry(name={self._name}, items={list(self._module_dict)})'

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None,
                        module: Optional[Callable] = None,
                        force: bool = False):
        """Register a class/function, usable as decorator or direct call."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def _register(self, module: Callable, name: Optional[str] = None,
                  force: bool = False) -> None:
        if not callable(module):
            raise TypeError(f'module must be callable, got {type(module)}')
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f'{key} is already registered in {self._name}')
        self._module_dict[key] = module

    def build(self, cfg: Dict[str, Any], default_args: Optional[dict] = None):
        return build_from_cfg(cfg, self, default_args)


def build_from_cfg(cfg: Dict[str, Any], registry: Registry,
                   default_args: Optional[dict] = None):
    """Instantiate ``registry[cfg['type']](**cfg_without_type, **default_args)``.

    Mirrors mmcv.build_from_cfg semantics: ``type`` may also be a class
    directly; default_args fill in missing keys only.
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
            raise KeyError(
                f'{obj_type} is not in the {registry.name} registry. '
                f'Available: {sorted(registry.module_dict)}')
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or class, got {type(obj_type)}')
    try:
        return obj_cls(**args)
    except TypeError as e:
        raise TypeError(f'{obj_cls.__name__}: {e}') from e
