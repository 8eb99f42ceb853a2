"""Explicit component registries.

Counterpart of ``syntalker_tpu/registry.py``: small named registries of
datasets, models, trainers, eval models and samplers, filled by decorator
registration (:mod:`syntalker_tpu_torch.components`), which the CLIs resolve
configured names through; the explicit form of the reference's
``__import__(f"...{args.name}")`` strings (train.py:46,85,122,267).
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._items:
                raise KeyError(f"{self.kind} '{name}' already registered")
            self._items[name] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        if name not in self._items:
            raise KeyError(
                f"unknown {self.kind} '{name}'; available: {sorted(self._items)}"
            )
        return self._items[name]

    def names(self):
        return sorted(self._items)


DATASETS: Registry = Registry("dataset")
MODELS: Registry = Registry("model")
TRAINERS: Registry = Registry("trainer")
EVAL_MODELS: Registry = Registry("eval model")
SAMPLERS: Registry = Registry("sampler")
