"""A string -> object registry and a dotted-path ``locate`` (the port's copy
of densepose_tpu/utils/registry.py: detectron2/utils/registry.py's surface,
without fvcore)."""

from __future__ import annotations

import importlib
from typing import Any, Dict


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map: Dict[str, Any] = {}

    def register(self, name_or_obj=None, obj: Any = None):
        """``reg.register("name", obj)``, or as a decorator: ``@reg.register``,
        ``@reg.register()`` (the object's ``__name__``) or
        ``@reg.register("name")``."""
        if obj is not None:
            self._register(name_or_obj, obj)
            return obj
        if callable(name_or_obj) and not isinstance(name_or_obj, str):
            self._register(name_or_obj.__name__, name_or_obj)
            return name_or_obj

        def deco(fn):
            self._register(name_or_obj if isinstance(name_or_obj, str) else fn.__name__, fn)
            return fn
        return deco

    def _register(self, name: str, obj: Any) -> None:
        if name in self._map:
            raise KeyError(f"{name!r} already registered in {self._name}")
        self._map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._map:
            raise KeyError(f"{name!r} not found in {self._name} registry; available: "
                           f"{sorted(self._map)}")
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def keys(self):
        return self._map.keys()


def locate(name: str) -> Any:
    """The object at a dotted path ``package.module.attr``."""
    parts = name.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(f"Cannot locate {name!r}")
