"""Python-file config system with ``_base_`` inheritance.

mmcv.Config-compatible semantics (reference usage: tools/train.py:82-84 —
``Config.fromfile`` + ``cfg.merge_from_dict(args.cfg_options)``): a config is a
python file whose module-level variables form a nested dict; ``_base_`` (str or
list of str, relative to the file) pulls in parent configs which are merged
underneath; a child dict with ``_delete_=True`` replaces the base dict instead
of merging into it; dotted-key overrides (``--cfg-options a.b.c=v``) merge on
top.

Fresh implementation (no mmcv): files are exec'd in an isolated namespace,
merging is a recursive dict merge, and attribute access is provided by
``ConfigDict``.
"""
from __future__ import annotations

import ast
import copy
import os
import os.path as osp
import types
from typing import Any, Dict, List, Optional, Union

DELETE_KEY = '_delete_'
BASE_KEY = '_base_'
RESERVED_KEYS = ('filename', 'text')


class ConfigDict(dict):
    """dict with attribute access, recursively applied on construction."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        d = dict(*args, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, ConfigDict._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{key}'")

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key)

    def __deepcopy__(self, memo):
        out = ConfigDict()
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def get(self, key, default=None):
        return super().get(key, default)

    def pop(self, key, *args):
        return super().pop(key, *args)

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def to_dict(self) -> dict:
        def _plain(v):
            if isinstance(v, dict):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(_plain(x) for x in v)
            return v
        return _plain(self)


def _merge_a_into_b(a: dict, b: dict) -> dict:
    """Merge dict ``a`` (child) into dict ``b`` (base); ``a`` wins.

    A child value that is a dict with ``_delete_: True`` replaces the base
    value entirely (mmcv semantics used throughout the reference configs).
    """
    b = copy.deepcopy(b)
    a = copy.deepcopy(a)  # side-effect free: _delete_ is stripped below
    for k, v in a.items():
        if isinstance(v, dict) and k in b and isinstance(b[k], dict) \
                and not v.pop(DELETE_KEY, False):
            b[k] = _merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = dict(v)
                v.pop(DELETE_KEY, None)
            b[k] = copy.deepcopy(v)
    return b


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f'config file not found: {filename}')
    with open(filename, 'r') as f:
        source = f.read()
    # Validate syntax early with a clear error message.
    try:
        ast.parse(source)
    except SyntaxError as e:
        raise SyntaxError(f'config file {filename} has a syntax error: {e}')
    mod = types.ModuleType('_mscl_cfg')
    mod.__file__ = filename
    exec(compile(source, filename, 'exec'), mod.__dict__)
    cfg_dict = {
        k: v for k, v in mod.__dict__.items()
        if not k.startswith('__') and not isinstance(v, types.ModuleType)
        and not isinstance(v, types.FunctionType)
    }
    return cfg_dict


def _load_with_bases(filename: str) -> Dict[str, Any]:
    cfg_dict = _exec_pyfile(filename)
    base = cfg_dict.pop(BASE_KEY, None)
    if base is None:
        return cfg_dict
    if isinstance(base, str):
        base = [base]
    cfg_base: Dict[str, Any] = {}
    cfg_dir = osp.dirname(osp.abspath(osp.expanduser(filename)))
    for b in base:
        bdict = _load_with_bases(osp.join(cfg_dir, b))
        dup = set(bdict) & set(cfg_base)
        if dup:
            raise KeyError(f'duplicate keys between _base_ files: {dup}')
        cfg_base.update(bdict)
    return _merge_a_into_b(cfg_dict, cfg_base)


class Config:
    """Top-level config object: attribute access + merge + dump."""

    def __init__(self, cfg_dict: Optional[dict] = None,
                 filename: Optional[str] = None):
        if cfg_dict is None:
            cfg_dict = {}
        for k in RESERVED_KEYS:
            if k in cfg_dict:
                raise KeyError(f'{k} is a reserved key')
        object.__setattr__(self, '_cfg_dict', ConfigDict(cfg_dict))
        object.__setattr__(self, '_filename', filename)

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        cfg_dict = _load_with_bases(filename)
        return Config(cfg_dict, filename=filename)

    @staticmethod
    def fromdict(cfg_dict: dict) -> 'Config':
        return Config(copy.deepcopy(cfg_dict))

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, '_cfg_dict'), name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = value

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = value

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self):
        return len(self._cfg_dict)

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(self._cfg_dict, memo), self._filename)

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge dotted-key options, e.g. {'model.backbone.depth': 50}.

        Mirrors mmcv Config.merge_from_dict used by --cfg-options
        (reference tools/train.py:58-65).
        """
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split('.')
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = v
        merged = _merge_a_into_b(option_cfg, self._cfg_dict.to_dict())
        object.__setattr__(self, '_cfg_dict', ConfigDict(merged))

    def to_dict(self) -> dict:
        return self._cfg_dict.to_dict()

    def dump(self, file: Optional[str] = None) -> Optional[str]:
        """Serialize the resolved config as a runnable python file."""
        lines = []
        for k, v in self._cfg_dict.items():
            lines.append(f'{k} = {_pformat(v)}')
        text = '\n'.join(lines) + '\n'
        if file is None:
            return text
        os.makedirs(osp.dirname(osp.abspath(file)), exist_ok=True)
        with open(file, 'w') as f:
            f.write(text)
        return None

    @property
    def pretty_text(self) -> str:
        return self.dump()


def _pformat(v: Any, indent: int = 0) -> str:
    pad = ' ' * indent
    if isinstance(v, dict):
        if not v:
            return 'dict()'
        items = ',\n'.join(
            f"{pad}    {k}={_pformat(val, indent + 4)}" if _is_ident(k)
            else f"{pad}    '{k}': {_pformat(val, indent + 4)}"
            for k, val in v.items())
        if all(_is_ident(k) for k in v):
            return f'dict(\n{items})'
        return f'{{\n{items}}}'
    if isinstance(v, (list, tuple)):
        inner = ', '.join(_pformat(x, indent) for x in v)
        return f'[{inner}]' if isinstance(v, list) else f'({inner}{"," if len(v) == 1 else ""})'
    return repr(v)


def _is_ident(k: Any) -> bool:
    return isinstance(k, str) and k.isidentifier()


def parse_cfg_option_value(raw: str) -> Any:
    """Parse a CLI override value: literal-eval with str fallback;
    'true'/'false'/'none' map to python values; commas make tuples."""
    lowered = raw.lower()
    if lowered == 'true':
        return True
    if lowered == 'false':
        return False
    if lowered in ('none', 'null'):
        return None
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        pass
    if ',' in raw:
        return tuple(parse_cfg_option_value(x) for x in raw.split(','))
    return raw


class DictAction:
    """argparse action-compatible helper: parse KEY=VALUE pairs into a dict.

    Usage: parser.add_argument('--cfg-options', nargs='+', action=DictAction)
    """

    def __init__(self, option_strings, dest, nargs=None, **kwargs):
        self.option_strings = option_strings
        self.dest = dest
        self.nargs = nargs
        self.required = kwargs.get('required', False)
        self.default = kwargs.get('default', None)
        self.help = kwargs.get('help', None)
        self.const = None
        self.choices = None
        self.type = None
        self.metavar = None

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, _, val = kv.partition('=')
            options[key] = parse_cfg_option_value(val)
        setattr(namespace, self.dest, options)
