"""String-keyed component registries.

The reference wires every component type through a registry populated at import
time and selected via ``type:`` keys in YAML configs (ref: src/utils/registry.py:11-92).
We keep the same public surface so configs remain the experiment API.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(
                f"'{name}' is already registered in '{self._name}' registry"
            )
        self._obj_map[name] = obj

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None) -> Callable:
        """Decorator (``@REG.register()`` / ``@REG.register("Name")``) or
        direct call (``REG.register(obj)``)."""
        if isinstance(obj, str):
            obj, name = None, obj
        if obj is None:
            def deco(fn_or_class: Any) -> Any:
                self._do_register(name or fn_or_class.__name__, fn_or_class)
                return fn_or_class
            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()

    def items(self):
        return self._obj_map.items()


# One registry per component type (ref: src/utils/registry.py:73-92).
TRAINER_REGISTRY = Registry("trainer")
OPTIMIZER_REGISTRY = Registry("optimizer")
SCHEDULER_REGISTRY = Registry("scheduler")
MODEL_REGISTRY = Registry("model")
ENCODER_REGISTRY = Registry("encoder")
DECODER_REGISTRY = Registry("decoder")
HYPERENCODER_REGISTRY = Registry("hyperencoder")
HYPERDECODER_REGISTRY = Registry("hyperdecoder")
CONTEXTMODEL_REGISTRY = Registry("context_model")
ENTROPYMODEL_REGISTRY = Registry("entropy_model")
DISCRIMINATOR_REGISTRY = Registry("discriminator")
LRP_REGISTRY = Registry("lrp")
DATASET_REGISTRY = Registry("dataset")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
VQ_ESTIMATOR_REGISTRY = Registry("vq_estimator")
VQ_FUSION_REGISTRY = Registry("vq_fusion")
