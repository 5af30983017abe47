"""The backend registry — the one place lookup backend names resolve (the
port of ``repro.kernels.backends``).

Every dispatch surface (``core.index.LearnedIndex``, ``core.index.Snapshot``,
``serving.PlexService``) resolves backend names through ``get_backend``;
nothing outside this module branches on a backend name string. A backend
is described by two factories:

* ``stacked_factory`` — the serving hot path: ``(plexes, row_off, *,
  device, block, probe, cache_slots, host_planes, summary_keys, planes) ->
  impl | None``, the impl conforming to ``StackedTorchPlex``'s
  ``lookup_planes(q, n_valid=None, delta=None, ...) -> LaneResult`` and
  ``dispatch`` protocol. ``None`` means the shards' statics could not be
  unified and the caller serves shard by shard. ``planes`` is the
  ``StackedPlanes`` an earlier impl of the same shards on the same device
  holds (``None`` for the first): an impl that reads them adopts them, so
  the backends of one snapshot share one copy on the card. ``None`` for the
  whole factory marks a host-only backend with no stacked device path.
* ``index_factory`` — the per-index path behind ``LearnedIndex.lookup``:
  ``(plex, *, block, device) -> impl`` with a ``lookup(q) -> np.ndarray``
  method. Host backends (``host=True``) serve straight from the ``PLEX``.

The built-ins:

* ``numpy`` — host only: the ``PLEX`` itself.
* ``torch`` — the plain PyTorch pipeline (``stacked_lookup_plain``, the plain
  ``DevicePlex``) on whatever device the planes live on, the card included.
  It is the only way the plain version runs on the card's serving path, and
  only when a caller or the fallback chain names it.
* ``cuda`` — K1 (``stacked_lookup``) and the fused K2/K3 + K4 launch
  (``DevicePlex``); on CPU tensors their plain versions.

Factories import the kernel modules inside their bodies, so importing this
module stays cheap.

Fault injection: registration instruments every factory with the
resilience registry's named points — ``backend.factory`` fires when an impl
is built, ``backend.dispatch`` on every ``lookup_planes`` / batched
``lookup`` call of the built impl, both carrying ``backend=<name>``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

from ..obs.metrics import METRICS
from ..resilience.faults import (POINT_BACKEND_DISPATCH,
                                 POINT_BACKEND_FACTORY, fire)


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered lookup backend (factory contracts in the module
    docstring)."""
    name: str
    stacked_factory: Optional[Callable[..., Any]]
    index_factory: Optional[Callable[..., Any]] = None
    host: bool = False

    @property
    def stacked(self) -> bool:
        """Whether this backend has a fused stacked device path."""
        return self.stacked_factory is not None


_REGISTRY: dict[str, Backend] = {}

# the registered names, refreshed on registration (``backend_names()`` when
# late registrations matter)
BACKENDS: tuple[str, ...] = ()


def _hook_dispatch(impl: Any, name: str, method: str) -> None:
    """Bind an instrumented ``method`` on ``impl`` that fires the
    ``backend.dispatch`` injection point before delegating (an instance
    attribute, so ``isinstance`` and every other attribute stay intact)."""
    orig = getattr(impl, method, None)
    if orig is None:
        return

    @functools.wraps(orig)
    def instrumented(*args, **kw):
        try:
            fire(POINT_BACKEND_DISPATCH, backend=name)
            if METRICS.enabled:
                METRICS.counter(f"serve.dispatch.{name}").inc()
            return orig(*args, **kw)
        except Exception:
            if METRICS.enabled:
                METRICS.counter(f"serve.dispatch_errors.{name}").inc()
            raise

    try:
        setattr(impl, method, instrumented)
    except (AttributeError, TypeError):  # pragma: no cover - exotic impls
        pass


def _instrument_stacked(name: str,
                        factory: Optional[Callable[..., Any]]
                        ) -> Optional[Callable[..., Any]]:
    if factory is None:
        return None

    @functools.wraps(factory)
    def wrapped(*args, **kw):
        fire(POINT_BACKEND_FACTORY, backend=name)
        impl = factory(*args, **kw)
        if impl is not None:
            _hook_dispatch(impl, name, "lookup_planes")
        return impl

    return wrapped


def _instrument_index(name: str,
                      factory: Optional[Callable[..., Any]]
                      ) -> Optional[Callable[..., Any]]:
    if factory is None:
        return None

    @functools.wraps(factory)
    def wrapped(px, *args, **kw):
        fire(POINT_BACKEND_FACTORY, backend=name)
        impl = factory(px, *args, **kw)
        # a passthrough factory returns the shared PLEX itself; hooking it
        # would leak the instrumentation to other backends
        if impl is not None and impl is not px:
            _hook_dispatch(impl, name, "lookup")
        return impl

    return wrapped


def register_backend(name: str,
                     stacked_factory: Optional[Callable[..., Any]], *,
                     index_factory: Optional[Callable[..., Any]] = None,
                     host: bool = False,
                     overwrite: bool = False) -> Backend:
    """Register (or with ``overwrite=True`` replace) a lookup backend."""
    global BACKENDS
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"backend {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    spec = Backend(name=name,
                   stacked_factory=_instrument_stacked(name, stacked_factory),
                   index_factory=_instrument_index(name, index_factory),
                   host=host)
    _REGISTRY[name] = spec
    BACKENDS = tuple(_REGISTRY)
    return spec


def unregister_backend(name: str) -> None:
    """Remove a registered backend (primarily for tests)."""
    global BACKENDS
    _REGISTRY.pop(name, None)
    BACKENDS = tuple(_REGISTRY)


def get_backend(name: str) -> Backend:
    """Resolve a backend name, or raise the one unknown-backend error every
    dispatch surface shares."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(repr(n) for n in _REGISTRY)}") from None


def backend_names() -> tuple[str, ...]:
    """The currently registered backend names, registration order."""
    return tuple(_REGISTRY)


# -- built-ins ---------------------------------------------------------------

def _numpy_index(px, *, block, device):   # pragma: no cover - host passthrough
    return px


def _torch_index(px, *, block, device):
    from .ops import DevicePlex
    return DevicePlex.from_plex(px, block=block, device=device, plain=True)


def _torch_stacked(plexes, row_off, **kw):
    from .stacked_lookup import StackedTorchPlex
    return StackedTorchPlex.from_plexes(plexes, row_off, plain=True, **kw)


def _cuda_index(px, *, block, device):
    from .ops import DevicePlex
    return DevicePlex.from_plex(px, block=block, device=device)


def _cuda_stacked(plexes, row_off, **kw):
    from .stacked_lookup import StackedTorchPlex
    return StackedTorchPlex.from_plexes(plexes, row_off, **kw)


register_backend("numpy", None, index_factory=_numpy_index, host=True)
register_backend("torch", _torch_stacked, index_factory=_torch_index)
register_backend("cuda", _cuda_stacked, index_factory=_cuda_index)
