"""Build detector — count what the port builds at run time across a
region of code (the JAX package's ``analysis/retrace.py``, which counts
XLA compilations).

The port compiles no graph: it uses no ``torch.compile``, and one step
function serves every participating-subset size (``fl/engine.py``
``step_stats``). What it does build at run time is

  * a kernel library: an ``nvcc`` build, or the first ``ctypes`` load of
    a built one (``kernels/build.py`` ``build`` / ``load``): events
    ``"build"`` and ``"load"``;
  * a new entry of an engine's embedding-artifact cache
    (``core/netchange.py`` ``KeyedCache.get``, a miss): event
    ``"cache_miss"``, named by the key's namespace.

All of them belong in round 1. The known hazard is anything that keys
them on what changes every round (a round's seed, a fresh closure), which
no accuracy test can see. So

    with RetraceDetector() as det:
        fed.run(rounds=3)
    assert det.since_checkpoint == 0      # checkpoint() after round 1

is the regression probe. The detector watches from outside: while one is
active, ``kernels.build.build`` / ``load`` and ``KeyedCache.get`` are
wrapped (a build is a library file that did not exist before the call,
a load a library not yet loaded, a miss a key not yet cached), and the
originals are put back when the last detector exits. Not part of the
default ``python -m repro_torch.analysis`` run: it needs a federation
actually run (``tests/test_torch_retrace.py``).
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

EVENTS = ("build", "load", "cache_miss")

_ACTIVE: List["RetraceDetector"] = []
_GUARD = threading.Lock()
_restore: Optional[Callable[[], None]] = None


def record(kind: str, what: str) -> None:
    """One run-time build of ``kind`` (``EVENTS``) named ``what``, counted
    by the detectors entered on this thread."""
    me = threading.get_ident()
    for det in _ACTIVE:
        if det._thread == me:
            det._record(kind, what)


def _watch() -> Callable[[], None]:
    """Wrap the three places the port builds at run time; returns the
    function that puts the originals back."""
    from repro_torch.core.netchange import KeyedCache
    from repro_torch.kernels import build as kbuild
    build0, load0, get0 = kbuild.build, kbuild.load, KeyedCache.get

    def build(name):
        fresh = not kbuild.library_path(name).exists()
        path = build0(name)
        if fresh:
            record("build", name)
        return path

    def load(name, declare):
        fresh = name not in kbuild._libs
        lib = load0(name, declare)
        if fresh:
            record("load", name)
        return lib

    def get(self, key, make):
        fresh = key not in self
        val = get0(self, key, make)
        if fresh:
            record("cache_miss", str(key[0]))       # the namespace
        return val

    kbuild.build, kbuild.load, KeyedCache.get = build, load, get

    def restore():
        kbuild.build, kbuild.load, KeyedCache.get = build0, load0, get0
    return restore


class RetraceDetector:
    """Context manager counting run-time builds while active.

    ``compiles``   — count since ``__enter__`` (monotone), every event.
    ``counts``     — the same by kind (``EVENTS``).
    ``checkpoint()`` — stash the current count and return it.
    ``since_checkpoint`` — events since the last checkpoint (or entry).
    ``events``     — the raw ``(kind, what)`` pairs, for diagnostics.

    Nesting is fine: each active detector counts independently. A
    detector counts what its own thread builds (a build another thread
    runs beside the region, as ``chip_smoke.py`` does, is not the
    region's).
    """

    def __init__(self) -> None:
        self.compiles = 0
        self.counts = dict.fromkeys(EVENTS, 0)
        self.events: List[Tuple[str, str]] = []
        self._mark = 0
        self._entered = False
        self._thread: Optional[int] = None

    def _record(self, kind: str, what: str) -> None:
        self.compiles += 1
        self.counts[kind] += 1
        self.events.append((kind, what))

    def checkpoint(self) -> int:
        self._mark = self.compiles
        return self._mark

    @property
    def since_checkpoint(self) -> int:
        return self.compiles - self._mark

    def __enter__(self) -> "RetraceDetector":
        global _restore
        if self._entered:
            raise RuntimeError("RetraceDetector is not reentrant; "
                               "create a new instance")
        self._entered = True
        self._thread = threading.get_ident()
        self.compiles = 0
        self.counts = dict.fromkeys(EVENTS, 0)
        self._mark = 0
        self.events.clear()
        with _GUARD:
            if not _ACTIVE:
                _restore = _watch()
            _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        global _restore
        with _GUARD:
            _ACTIVE.remove(self)
            if not _ACTIVE:
                _restore()
                _restore = None
        self._entered = False
        return None
