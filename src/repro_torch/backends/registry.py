"""Backend registry: name -> LookupBackend factory.

Built-in backends register when ``repro_torch.backends`` is imported;
``REPRO_LUT_BACKEND`` names the default backend picked by :func:`resolve`
(the same variable the reference reads).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

from repro_torch.backends.base import LookupBackend

DEFAULT_BACKEND = "take"
ENV_BACKEND = "REPRO_LUT_BACKEND"

_FACTORIES: Dict[str, Callable[[], LookupBackend]] = {}
_INSTANCES: Dict[str, LookupBackend] = {}


def register(name: str,
             factory: Optional[Callable[[], LookupBackend]] = None):
    """Register a backend factory under ``name`` (directly or as a class
    decorator); re-registering a name replaces it."""
    def _do(f: Callable[[], LookupBackend]):
        _FACTORIES[name] = f
        _INSTANCES.pop(name, None)
        return f
    return _do(factory) if factory is not None else _do


def unregister(name: str) -> None:
    """Drop a registered backend (no-op for unknown names)."""
    _FACTORIES.pop(name, None)
    _INSTANCES.pop(name, None)


def available() -> Tuple[str, ...]:
    """Registered backend names, in registration order."""
    return tuple(_FACTORIES)


def get(name: str) -> LookupBackend:
    """Instantiate (and memoize) the backend registered under ``name``."""
    if name not in _FACTORIES:
        raise ValueError(
            f"unknown lookup backend {name!r}; registered: "
            f"{', '.join(_FACTORIES) or '(none)'}")
    if name not in _INSTANCES:
        inst = _FACTORIES[name]()
        inst.name = name
        _INSTANCES[name] = inst
    return _INSTANCES[name]


def default_backend() -> str:
    """The ambient default backend name (env override or 'take')."""
    return os.environ.get(ENV_BACKEND, DEFAULT_BACKEND)


def resolve(name: Optional[str] = None) -> LookupBackend:
    """``name`` if given, else ``$REPRO_LUT_BACKEND``, else 'take'."""
    return get(name or default_backend())
