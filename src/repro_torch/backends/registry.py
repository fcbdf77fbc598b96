"""Backend registry: name -> LookupBackend factory.

Built-in backends register when ``repro_torch.backends`` is imported;
out-of-tree code registers with the same :func:`register` decorator
(importing its module is the registration).
``REPRO_TORCH_LUT_BACKEND_PLUGINS`` (comma-separated module paths) pulls
such modules in without code changes; it is the port's own variable, since
the reference's ``REPRO_LUT_BACKEND_PLUGINS`` names modules that register
into the reference.  ``REPRO_LUT_BACKEND`` names the default backend
picked by :func:`resolve` (the same variable the reference reads).
"""
from __future__ import annotations

import importlib
import os
from typing import Callable, Dict, Optional, Tuple

from repro_torch.backends.base import LookupBackend

DEFAULT_BACKEND = "take"
ENV_BACKEND = "REPRO_LUT_BACKEND"
ENV_PLUGINS = "REPRO_TORCH_LUT_BACKEND_PLUGINS"

_FACTORIES: Dict[str, Callable[[], LookupBackend]] = {}
_INSTANCES: Dict[str, LookupBackend] = {}
_PLUGINS_LOADED = False


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


def load_plugins() -> None:
    """Import the modules named in ``REPRO_TORCH_LUT_BACKEND_PLUGINS``
    (once).

    Every module is tried even after an earlier one fails, then one
    ``ImportError`` names every failure.  A failed load is not latched:
    the next registry call tries again, so a caller that swallows the
    first error cannot go on without the plugins."""
    global _PLUGINS_LOADED
    if _PLUGINS_LOADED:
        return
    failures = []
    for mod in filter(None, os.environ.get(ENV_PLUGINS, "").split(",")):
        try:
            importlib.import_module(mod.strip())
        except Exception as e:  # noqa: BLE001 - report, don't mask others
            failures.append(f"{mod.strip()} ({e})")
    if failures:
        raise ImportError(
            "failed to import lookup-backend plugin module(s): "
            + "; ".join(failures))
    _PLUGINS_LOADED = True


def available() -> Tuple[str, ...]:
    """Registered backend names, in registration order."""
    load_plugins()
    return tuple(_FACTORIES)


def get(name: str) -> LookupBackend:
    """Instantiate (and memoize) the backend registered under ``name``."""
    load_plugins()
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
