"""Name -> object registries gluing YAML ``type:`` strings to classes.

The port's own copy of ``lowlight_image_enhancement_tpu/utils/
registry.py`` (the reference's 5-registry system, ``NAFNet_base/basicsr/
utils/registry.py:8-64``): DATASET / ARCH / MODEL / LOSS / METRIC
registries with decorator or direct registration and duplicate-key errors.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional


class Registry:
    """A simple name -> object mapping supporting decorator registration.

    Example::

        ARCH_REGISTRY = Registry("arch")

        @ARCH_REGISTRY.register()
        class NAFNet: ...

        ARCH_REGISTRY.get("NAFNet")
    """

    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in "
                f"'{self._name}' registry!"
            )
        self._obj_map[name] = obj

    def register(self, obj: Any = None, name: Optional[str] = None) -> Callable:
        """Register ``obj`` (or use as a decorator when ``obj`` is None)."""
        if obj is None:

            def deco(func_or_class: Any) -> Any:
                self._do_register(name or func_or_class.__name__, func_or_class)
                return func_or_class

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry! "
                f"Available: {sorted(self._obj_map)}"
            )
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[tuple[str, Any]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()

    def __len__(self) -> int:
        return len(self._obj_map)

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={sorted(self._obj_map)})"


DATASET_REGISTRY = Registry("dataset")
ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
