"""Hierarchical YAML config system (port of detzero_tpu/core/config.py).

The reference's config surface (utils/detzero_utils/config_utils.py):
`_BASE_CONFIG_` single-level include with recursive merge (a relative base
path resolves against the working directory), dotted-path CLI overrides
with literal_eval and type enforcement, and a global attribute-dict config
object.  YAML is read by `yaml_subset.safe_load`, never PyYAML, which the
card's machine lacks.
"""

from __future__ import annotations

import ast
import copy
from pathlib import Path

from detzero_tpu_torch.core.yaml_subset import safe_load


class Config(dict):
    """dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v
                for v in value
            )
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def get_nested(self, dotted: str, default=None):
        cur = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def merge_new_config(config: Config, new_config: dict) -> Config:
    """Recursively merge ``new_config`` into ``config``.

    Mirrors reference semantics (config_utils.py:59-77): a `_BASE_CONFIG_` key
    is loaded first so sibling keys override the base.
    """
    if "_BASE_CONFIG_" in new_config:
        base_path = new_config.pop("_BASE_CONFIG_")
        with open(base_path) as f:
            base = safe_load(f.read())
        merge_new_config(config, base)
    for key, val in new_config.items():
        if isinstance(val, dict):
            if not isinstance(config.get(key), dict):
                config[key] = Config()
            merge_new_config(config[key], val)
        else:
            config[key] = copy.deepcopy(val) if isinstance(val, list) else val
    return config


def cfg_from_yaml_file(cfg_file, config: Config | None = None) -> Config:
    """Load a YAML file (with `_BASE_CONFIG_` include) into ``config``."""
    if config is None:
        config = Config()
    with open(cfg_file) as f:
        new_config = safe_load(f.read())
    merge_new_config(config, new_config or {})
    config.setdefault("TAG", Path(cfg_file).stem)
    return config


def cfg_from_list(cfg_list, config: Config) -> Config:
    """Apply CLI `--set KEY.SUBKEY value` overrides (config_utils.py:24-56).

    Values are parsed with ``ast.literal_eval`` (falling back to string) and
    must match the type of the existing entry when one exists.
    """
    assert len(cfg_list) % 2 == 0, "--set expects KEY VALUE pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split(".")
        d = config
        for subkey in key_list[:-1]:
            if subkey not in d:
                d[subkey] = Config()
            d = d[subkey]
        subkey = key_list[-1]
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if subkey in d and d[subkey] is not None and not isinstance(value, type(d[subkey])):
            if isinstance(d[subkey], bool) and isinstance(value, int):
                value = bool(value)
            elif isinstance(d[subkey], float) and isinstance(value, int):
                value = float(value)
            elif isinstance(d[subkey], (list, tuple)) and isinstance(value, (list, tuple)):
                value = type(d[subkey])(value)
            else:
                raise ValueError(
                    f"type mismatch for {full_key}: "
                    f"{type(d[subkey]).__name__} vs {type(value).__name__}"
                )
        d[subkey] = value
    return config


def log_config_to_file(config: Config, pre="cfg", logger=None):
    out = logger.info if logger is not None else print
    for key, val in config.items():
        if isinstance(val, dict):
            out(f"{pre}.{key} = Config(")
            log_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
            out(")")
        else:
            out(f"{pre}.{key}: {val}")


# Global config instance, mirroring the reference's module-level `cfg`.
cfg = Config()
