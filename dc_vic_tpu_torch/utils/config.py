"""mmcv-style YAML config with ``_base_`` inheritance.

Behavioral contract (ref: src/utils/options.py:39-278):
  * ``_base_:`` is a path or list of paths (relative to the including file);
    bases are merged in order, then the child is merged on top.
  * ``_delete_: true`` inside a mapping replaces the base subtree instead of
    merging into it.
  * Duplicate top-level keys across sibling bases raise an error.
  * CLI ``--key.subkey value`` overrides win over YAML.
  * Values are attribute-accessible (cfg.model.type) and dict-like.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

import yaml

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


class Config(dict):
    """Attribute-accessible dict. Missing attribute access returns None-like
    sentinel via .get(); direct attr access on a missing key raises."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    def to_plain(self) -> Dict:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v
        return unwrap(self)


def _merge_a_into_b(a: Dict, b: Dict) -> Dict:
    """Recursively merge dict ``a`` (child / override) into ``b`` (base)."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and isinstance(b.get(k), dict):
            if v.pop(DELETE_KEY, False):
                b[k] = _merge_a_into_b(v, {})
            else:
                b[k] = _merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = dict(v)
                v.pop(DELETE_KEY, None)
                v = _merge_a_into_b(v, {})
            b[k] = copy.deepcopy(v)
    return b


def load_yaml_with_base(path: str, _seen: Optional[set] = None) -> Dict:
    path = os.path.abspath(path)
    _seen = _seen or set()
    if path in _seen:
        raise ValueError(f"Circular _base_ inheritance involving {path}")
    _seen = _seen | {path}

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise TypeError(f"Top level of {path} must be a mapping")

    base_spec = cfg.pop(BASE_KEY, None)
    if base_spec is None:
        return cfg

    base_paths = base_spec if isinstance(base_spec, list) else [base_spec]
    merged_base: Dict = {}
    seen_keys: set = set()
    for bp in base_paths:
        bp_abs = bp if os.path.isabs(bp) else os.path.join(os.path.dirname(path), bp)
        base_cfg = load_yaml_with_base(bp_abs, _seen)
        dup = seen_keys & set(base_cfg.keys())
        if dup:
            raise KeyError(f"Duplicate keys {sorted(dup)} across _base_ files of {path}")
        seen_keys |= set(base_cfg.keys())
        merged_base = _merge_a_into_b(base_cfg, merged_base)

    return _merge_a_into_b(cfg, merged_base)


def _parse_value(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def apply_cli_overrides(cfg: Dict, overrides: List[str]) -> Dict:
    """Apply ``key.subkey=value`` style overrides (CLI wins over YAML)."""
    cfg = copy.deepcopy(cfg)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override must be key=value, got {item!r}")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.strip().lstrip("-").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return cfg


def load_config(
    path: str,
    overrides: Optional[List[str]] = None,
    is_train: bool = False,
) -> Config:
    """Load a config file, resolving ``_base_`` and applying CLI overrides.

    Also sets ``exp`` (experiment name = config filename stem, ref:
    src/utils/options.py:209) and ``is_train``.
    """
    cfg = load_yaml_with_base(path)
    if overrides:
        cfg = apply_cli_overrides(cfg, overrides)
    cfg.setdefault("exp", os.path.splitext(os.path.basename(path))[0])
    cfg["is_train"] = is_train
    cfg["config_path"] = os.path.abspath(path)
    return Config._wrap(cfg)


def dump_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_plain(), f, sort_keys=False)
