"""String-keyed component registries, so YAML ``type:`` strings resolve to
the port's classes under the same names as in the JAX package (a copy of
super_resolution_tpu/utils/registry.py, without its unused suffix lookup)."""

from __future__ import annotations

from typing import Any, Dict


class Registry:
    """A name -> factory mapping with decorator registration."""

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: str | None = None):
        """Register a class or function under its __name__ (or ``name``).
        Usable as ``@REGISTRY.register()`` or ``@REGISTRY.register``."""
        if obj is None:
            return lambda o: self.register(o, name=name)
        key = name if name is not None else obj.__name__
        if key in self._obj_map:
            raise KeyError(f"'{key}' already registered in '{self._name}' "
                           f"registry")
        self._obj_map[key] = obj
        return obj

    def get(self, name: str) -> Any:
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(f"'{name}' not found in '{self._name}' registry. "
                           f"Available: {sorted(self._obj_map)}")
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()


ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
DATASET_REGISTRY = Registry("dataset")
METRIC_REGISTRY = Registry("metric")
LOSS_REGISTRY = Registry("loss")
