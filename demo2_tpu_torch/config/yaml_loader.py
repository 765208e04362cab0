"""YAML files and CLI opts merged into the config tree, copied from
demo2_tpu/config/yaml_loader.py (yacs-style: values cast to the type of the
existing default, lists to tuples, the strings 'None' / 'True' / 'False' in
opts parsed as Python values).  PyYAML is imported inside `merge_yaml_file`,
so that the package imports where PyYAML is not installed.
tests/test_torch_package.py asserts that every file under configs/ gives the
JAX package's tree.
"""

from __future__ import annotations

import ast
from typing import Any, List

from .defaults import _Node

# String-enum knobs that accept YAML 1.1 booleans (unquoted on/off/yes/no)
# and normalise them at the consumer.  Every other str knob rejects bools:
# consumers compare against literal spellings ('on', 'yes', ...), so a stored
# Python bool would flip the knob's meaning (`TPU.INT8_MLP: off` parsing to
# False would turn int8 on).
_BOOL_OK_STR_KNOBS = frozenset({"DATALOADER.NATIVE_DECODE"})


def _coerce(old: Any, new: Any, key: str = "") -> Any:
    if old is None:
        if isinstance(new, str):
            try:
                return ast.literal_eval(new)
            except (ValueError, SyntaxError):
                return new
        return new
    if isinstance(new, str) and not isinstance(old, str):
        # "None" / "True" / "(1,2)" strings from CLI opts; a str-typed knob
        # keeps its string verbatim (TEST.MISS='None' stays a str).
        try:
            return _coerce(old, ast.literal_eval(new), key)
        except (ValueError, SyntaxError):
            pass
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, (int, float)):
            return bool(new)
        raise TypeError(f"Cannot coerce {new!r} to bool")
    if isinstance(old, tuple):
        if isinstance(new, (list, tuple)):
            return tuple(new)
        raise TypeError(f"Expected a sequence for a tuple knob, got {new!r}")
    if isinstance(old, int):
        if isinstance(new, bool):
            return int(new)
        if isinstance(new, int):
            return new
        if isinstance(new, float) and new.is_integer():
            return int(new)
        raise TypeError(f"Cannot coerce {new!r} to int")
    if isinstance(old, float):
        if isinstance(new, (int, float)) and not isinstance(new, bool):
            return float(new)
        raise TypeError(f"Cannot coerce {new!r} to float")
    if isinstance(old, str):
        if isinstance(new, str):
            return new
        if isinstance(new, bool):
            if key in _BOOL_OK_STR_KNOBS:
                return new
            raise TypeError(
                f"{key or 'knob'}: YAML parsed the value as boolean {new} (unquoted "
                f"on/off/yes/no/true/false), but this is a string-enum knob: quote the "
                f"value, e.g. 'on'")
        raise TypeError(f"Cannot coerce {new!r} to str")
    return new


def _merge_dict(node: _Node, data: dict, path: str = "") -> None:
    for key, value in data.items():
        if not hasattr(node, key):
            raise KeyError(f"Unknown config key: {path}{key}")
        old = getattr(node, key)
        if isinstance(old, _Node):
            if not isinstance(value, dict):
                raise TypeError(f"Expected mapping for {path}{key}")
            _merge_dict(old, value, path=f"{path}{key}.")
        else:
            setattr(node, key, _coerce(old, value, f"{path}{key}"))


def merge_yaml_file(cfg: _Node, path: str) -> _Node:
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f)
    if data:
        _merge_dict(cfg, data)
    return cfg


def merge_opts_list(cfg: _Node, opts: List[Any]) -> _Node:
    """Apply a flat ['A.B', value, 'C.D', value, ...] override list."""
    if not opts:
        return cfg
    if len(opts) % 2 != 0:
        raise ValueError("opts list must have even length (key value pairs)")
    for key, value in zip(opts[0::2], opts[1::2]):
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = getattr(node, p)
        setattr(node, parts[-1], _coerce(getattr(node, parts[-1]), value, key))
    return cfg
