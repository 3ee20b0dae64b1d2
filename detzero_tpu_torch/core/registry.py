"""String-name registries (port of detzero_tpu/core/registry.py).

The reference wires everything through name-keyed dicts
(models/__init__.py:8-10, centerpoint_modules/__init__.py:8-17,
kalman_filter/__init__.py:4-7). We formalize that as a Registry class so each
subsystem (datasets, models, heads, filters, processors) declares a registry
and components self-register with a decorator.
"""

from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: dict[str, type] = {}

    def register(self, name: str | None = None):
        def deco(cls):
            key = name or cls.__name__
            if key in self._registry:
                raise KeyError(f"{key} already registered in {self.name}")
            self._registry[key] = cls
            return cls

        return deco

    def get(self, name: str):
        if name not in self._registry:
            raise KeyError(
                f"{name!r} not found in registry {self.name!r}; "
                f"available: {sorted(self._registry)}"
            )
        return self._registry[name]

    def build(self, name: str, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name):
        return name in self._registry

    def keys(self):
        return self._registry.keys()


# the port's datasets, the tracker's motion filters and the refining
# models; the reference's other registries come with the modules that fill
# them
DATASETS = Registry("datasets")
MOTION_FILTERS = Registry("motion_filters")
REFINE_MODULES = Registry("refine_modules")
