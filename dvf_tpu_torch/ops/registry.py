"""Filter plugin registry — the framework's operator boundary.

A registered factory is ``factory(**config) -> Filter``; one op name covers
a config family (``gaussian_blur(ksize=9, sigma=2.0)``). The names are the
reference package's, so an op-chain string means the same in both.

The port has no measured per-backend defaults yet: where a filter has a
hand-written kernel, ``impl=None`` resolves to it (see each factory).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from dvf_tpu_torch.api.filter import Filter

_REGISTRY: Dict[str, Callable[..., Filter]] = {}


def register_filter(name: str) -> Callable[[Callable[..., Filter]], Callable[..., Filter]]:
    """Decorator: register a filter factory under ``name`` (last wins)."""

    def deco(factory: Callable[..., Filter]) -> Callable[..., Filter]:
        _REGISTRY[name] = factory
        return factory

    return deco


def get_filter(name: str, **config) -> Filter:
    """Instantiate the filter registered under ``name`` with ``config``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no filter named {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return factory(**config)


def list_filters() -> List[str]:
    return sorted(_REGISTRY)
