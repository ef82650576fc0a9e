"""Filter plugin registry — the framework's operator boundary.

A registered factory is ``factory(**config) -> Filter``; one op name covers
a config family (``gaussian_blur(ksize=9, sigma=2.0)``). The names are the
reference package's, so an op-chain string means the same in both.

Where a filter has a hand-written kernel, ``impl=None`` resolves to it
(see each factory). The neural filters' exact conv rewrites resolve
through :data:`MEASURED_DEFAULTS`, which holds a backend's winner only
from a committed A/B run of the port on that backend.
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


# Measured per-backend defaults of the port. ``winners`` maps a backend
# ("cuda", "cpu") to the impl label its committed A/B picked; a backend
# without one takes ``fallback``. No TPU winner of the JAX package carries
# over, and no port A/B has been committed yet, so both keys run the
# reference lowering ("ref") everywhere.
#   comparison    — the A/B it is decided by (the JAX package's name)
#   label_to_impl — A/B labels → the factory's choice
MEASURED_DEFAULTS = {
    "style_fast": {
        "comparison": "style_fast_720p",
        "winners": {},
        "fallback": "ref",
        "label_to_impl": {"ref": "ref", "fast": "fast"},
    },
    "espcn_fast": {
        "comparison": "sr_fast_540p",
        "winners": {},
        "fallback": "ref",
        "label_to_impl": {"ref": "ref", "fast": "fast"},
    },
}


def measured_default(winners: Dict[str, str], fallback: str,
                     backend: str = "cuda") -> str:
    """Pick an implementation from measured per-backend ``winners``
    (backend → impl label, filled only from committed A/B runs of the
    port); a backend without one takes ``fallback``. ``backend`` is
    "cuda" unless the caller names another: the port's entry points run
    on the card unless told otherwise, and no device is asked here."""
    return winners.get(backend, fallback)


def measured_default_for(key: str, backend: str = "cuda") -> str:
    """The measured winner of ``MEASURED_DEFAULTS[key]`` on ``backend``,
    else its fallback."""
    entry = MEASURED_DEFAULTS[key]
    return measured_default(entry["winners"], entry["fallback"], backend)
