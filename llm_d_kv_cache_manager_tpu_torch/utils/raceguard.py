"""Guarded-by runtime enforcement: kvlint's static model, executed.

kvlint KV001 proves from source that every ``# guarded-by:`` attribute
is touched only under its declared lock — within the access shapes the
AST can see.  Aliases, foreign-object accesses, dynamic dispatch and
plain annotation lies are invisible to it.  This module closes the
loop at runtime: ``hack/kvlint --emit-manifest`` exports phase 1's
class→{guarded attrs, lock attr, caller-locked methods} model to
``utils/raceguard_manifest.json`` beside this module (checked in,
staleness-pinned), and when ``KVTPU_RACEGUARD=1`` :func:`install`
imports every manifest class and replaces each guarded attribute with
a data descriptor that asserts *the current thread holds the declared
lock instance* on every read and write.

Composition (utils/lockorder.py): enforcement needs to know which lock
instances the current thread holds, which is the held-lock registry —
fed by ``TrackedLock`` (watchdog), ``ContentionTimedLock`` (telemetry)
and ``GuardRecordingLock`` (the minimal wrapper instances get at
``__init__`` time when neither debug mode armed their lock).  A storm
can therefore run watchdog + raceguard together and each wrapper
records exactly once.

Zero-cost when unarmed, same contract as the watchdog: with
``KVTPU_RACEGUARD`` unset nothing is instrumented — class dicts keep
their raw slots/attributes, ``tracked`` locks stay raw, attribute
access is native (pinned by a tier-1 test).

Violations raise :class:`RaceGuardViolation` (an ``AssertionError``
subclass, so storms fail loudly) carrying BOTH thread stacks: the
offending accessor's and — via ``sys._current_frames`` and the
registry's holder map — the stack of the thread currently holding the
lock, which is the pair a race report needs.

Known soundness gaps (documented, deliberate): an object is exempt
while its ``__init__`` runs in the constructing thread (not shared
yet); a subclass ``__init__`` continuing after the instrumented base
``__init__`` returned re-enters enforcement; a ``Condition.wait``
still counts as holding for the waiting thread while it is blocked
(it cannot access anything meanwhile).

Copied from the JAX reference's ``utils/raceguard.py``.  The port keeps
its own manifest, made from the port's sources by
``python -m hack.kvlint llm_d_kv_cache_manager_tpu_torch --emit-manifest
llm_d_kv_cache_manager_tpu_torch/utils/raceguard_manifest.json`` and
shipped as package data.  :func:`install` refuses a manifest key outside
this package before importing anything, so a manifest of another package
(``KVTPU_RACEGUARD_MANIFEST``) can never load that package.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import threading
import traceback
import warnings
from typing import Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.utils import lockorder

__all__ = [
    "RaceGuardViolation",
    "armed_from_env",
    "guard_class",
    "install",
    "install_from_env",
    "installed",
    "uninstall",
]

MANIFEST_ENV = "KVTPU_RACEGUARD_MANIFEST"


class RaceGuardViolation(AssertionError):
    """A guarded attribute was accessed without its declared lock."""


def armed_from_env() -> bool:
    return os.environ.get("KVTPU_RACEGUARD", "") in ("1", "true", "yes")


_local = threading.local()

# class -> {attr -> original class-dict entry (or _MISSING)}, plus the
# original __init__, for uninstall(); mutated only by install/uninstall
# (single-threaded test/boot paths).
_instrumented: Dict[type, dict] = {}

_MISSING = object()


def installed() -> bool:
    return bool(_instrumented)


def _other_thread_stack(ident: Optional[int]) -> str:
    if ident is None:
        return "  (no thread currently holds the lock)"
    if ident == threading.get_ident():
        return "  (the holder IS the current thread)"
    frame = sys._current_frames().get(ident)
    if frame is None:
        return f"  (holder thread {ident} already exited)"
    name = str(ident)
    for thread in threading.enumerate():
        if thread.ident == ident:
            name = f"{thread.name} ({ident})"
            break
    stack = "".join(traceback.format_stack(frame))
    return f"  holder thread {name}:\n{stack}"


class GuardedAttribute:
    """Data descriptor enforcing ``# guarded-by:`` on one attribute.

    Storage is delegated to the original slot descriptor when the
    class used ``__slots__``, to the instance ``__dict__`` otherwise
    (a data descriptor shadows the instance dict, so the raw value
    stays invisible to normal lookup).
    """

    __slots__ = ("attr", "lock_attr", "owner_name", "slot")

    def __init__(
        self,
        attr: str,
        lock_attr: str,
        owner_name: str,
        slot=None,
    ) -> None:
        self.attr = attr
        self.lock_attr = lock_attr
        self.owner_name = owner_name
        self.slot = slot

    # -- enforcement ----------------------------------------------------

    def _check(self, obj, mode: str) -> None:
        initializing = getattr(_local, "initializing", None)
        if initializing and id(obj) in initializing:
            return  # under construction in this thread: not shared yet
        hook = lockorder._fuzz_hook
        if hook is not None:
            hook(f"guard-{mode}", f"{self.owner_name}.{self.attr}")
        lock = getattr(obj, self.lock_attr, None)
        if lock is None:
            return  # lock not built yet (partially-initialized object)
        if lockorder.holds(lock):
            return
        mine = "".join(traceback.format_stack())
        other = _other_thread_stack(lockorder.holder_of(lock))
        raise RaceGuardViolation(
            f"raceguard: {mode} of '{self.owner_name}.{self.attr}' "
            f"without holding 'self.{self.lock_attr}' "
            f"(declared `# guarded-by: {self.lock_attr}`)\n"
            f"  accessing thread {threading.current_thread().name} "
            f"({threading.get_ident()}):\n{mine}\n{other}"
        )

    # -- storage --------------------------------------------------------

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        self._check(obj, "read")
        if self.slot is not None:
            return self.slot.__get__(obj, owner)
        try:
            return obj.__dict__[self.attr]
        except KeyError:
            raise AttributeError(self.attr) from None

    def __set__(self, obj, value) -> None:
        self._check(obj, "write")
        if self.slot is not None:
            self.slot.__set__(obj, value)
        else:
            obj.__dict__[self.attr] = value

    def __delete__(self, obj) -> None:
        self._check(obj, "write")
        if self.slot is not None:
            self.slot.__delete__(obj)
        else:
            try:
                del obj.__dict__[self.attr]
            except KeyError:
                raise AttributeError(self.attr) from None


def _wrap_instance_locks(obj, lock_attrs) -> None:
    """Post-``__init__``: ensure every lock attr feeds the held-lock
    registry.  Locks already wrapped by the watchdog or contention
    timing record on their own; raw primitives get the minimal
    recording wrapper.  Identity is the RAW lock, so double wrapping
    elsewhere could never split an instance's identity."""
    for attr in lock_attrs:
        try:
            lock = object.__getattribute__(obj, attr)
        except AttributeError:
            continue
        if lock is None or isinstance(
            lock,
            (
                lockorder.TrackedLock,
                lockorder.ContentionTimedLock,
                lockorder.GuardRecordingLock,
            ),
        ):
            continue
        if not hasattr(lock, "acquire"):
            continue
        wrapped = lockorder.GuardRecordingLock(
            lock, f"{type(obj).__name__}.{attr}"
        )
        setattr(obj, attr, wrapped)


def _wrap_init(cls, lock_attrs) -> object:
    orig_init = cls.__init__

    def raceguard_init(self, *args, **kwargs):
        initializing = getattr(_local, "initializing", None)
        if initializing is None:
            initializing = _local.initializing = set()
        fresh = id(self) not in initializing
        if fresh:
            initializing.add(id(self))
        try:
            orig_init(self, *args, **kwargs)
        finally:
            if fresh:
                initializing.discard(id(self))
        if fresh:
            _wrap_instance_locks(self, lock_attrs)

    raceguard_init.__name__ = getattr(orig_init, "__name__", "__init__")
    raceguard_init.__qualname__ = getattr(
        orig_init, "__qualname__", f"{cls.__name__}.__init__"
    )
    raceguard_init.__raceguard_wrapped__ = True
    cls.__init__ = raceguard_init
    return orig_init


def guard_class(
    cls: type,
    guarded: Dict[str, str],
    locks: Optional[List[str]] = None,
) -> type:
    """Instrument one class (the manifest path calls this for every
    entry; tests call it directly to plant violations).  ``guarded``
    maps attr -> lock attr; ``locks`` lists lock attrs to wrap at
    ``__init__`` time (defaults to the distinct guard locks)."""
    if cls in _instrumented:
        return cls
    lock_attrs = sorted(set(locks or ()) | set(guarded.values()))
    saved: dict = {"__init__": cls.__init__, "attrs": {}}
    for attr, lock_attr in sorted(guarded.items()):
        original = cls.__dict__.get(attr, _MISSING)
        saved["attrs"][attr] = original
        slot = original if _is_slot_descriptor(original) else None
        setattr(
            cls,
            attr,
            GuardedAttribute(attr, lock_attr, cls.__name__, slot),
        )
    _wrap_init(cls, lock_attrs)
    _instrumented[cls] = saved
    return cls


def _is_slot_descriptor(obj) -> bool:
    return type(obj).__name__ == "member_descriptor"


# ---------------------------- manifest ---------------------------------


PACKAGE = __name__.split(".")[0]


def _default_manifest_path() -> str:
    override = os.environ.get("KVTPU_RACEGUARD_MANIFEST")
    if override:
        return override
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "raceguard_manifest.json"
    )


def load_manifest(path: Optional[str] = None) -> dict:
    manifest_path = path or _default_manifest_path()
    with open(manifest_path, encoding="utf-8") as handle:
        return json.load(handle)


def _resolve(key: str) -> type:
    module_name, _, qualname = key.partition(":")
    module = importlib.import_module(module_name)
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def install(path: Optional[str] = None) -> int:
    """Instrument every manifest class; returns the class count.
    Import or resolution failures raise — silently skipping a class
    would silently skip its enforcement; so does a key outside this
    package, before any class is instrumented or module imported."""
    manifest = load_manifest(path)
    for key in manifest.get("classes", {}):
        if not key.partition(":")[0].startswith(PACKAGE + "."):
            raise ValueError(
                f"raceguard manifest key {key!r} names a module outside "
                f"{PACKAGE!r}; nothing was installed"
            )
    lock_attrs_by_cls: Dict[type, List[str]] = {}
    count = 0
    for key, entry in manifest.get("classes", {}).items():
        cls = _resolve(key)
        locks = sorted(
            set(entry.get("locks", ()))
            | set(entry.get("guarded", {}).values())
        )
        guard_class(
            cls,
            guarded=dict(entry.get("guarded", {})),
            locks=locks,
        )
        lock_attrs_by_cls[cls] = locks
        count += 1
    _sweep_existing_instances(lock_attrs_by_cls)
    return count


def _sweep_existing_instances(
    lock_attrs_by_cls: Dict[type, List[str]],
) -> None:
    """Module-level singletons (``TRACER``, ``PROFILER``, …) are built
    while :func:`install` is still importing their modules — before
    their ``__init__`` was wrapped — so their locks never entered the
    held-lock registry and every guarded access would look unlocked.
    One gc pass wraps the locks of instances that already exist; every
    later construction goes through the wrapped ``__init__``."""
    import gc

    classes = tuple(lock_attrs_by_cls)
    if not classes:
        return
    # isinstance() on some of torch's deprecated module-level objects
    # (torch.distributed.reduce_op) warns; the sweep only reads them.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for obj in gc.get_objects():
            if isinstance(obj, classes):
                for cls in type(obj).__mro__:
                    attrs = lock_attrs_by_cls.get(cls)
                    if attrs:
                        _wrap_instance_locks(obj, attrs)


def install_from_env() -> bool:
    """Boot hook (package ``__init__``): install iff
    ``KVTPU_RACEGUARD=1``; False (and zero work) otherwise."""
    if not armed_from_env():
        return False
    if not installed():
        install()
        lockorder.set_guard_recording(True)
    return True


def uninstall() -> None:
    """Restore every instrumented class (test isolation)."""
    for cls, saved in list(_instrumented.items()):
        cls.__init__ = saved["__init__"]
        for attr, original in saved["attrs"].items():
            if original is _MISSING:
                try:
                    delattr(cls, attr)
                except AttributeError:
                    pass
            else:
                setattr(cls, attr, original)
        del _instrumented[cls]
