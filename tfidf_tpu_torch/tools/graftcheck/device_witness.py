"""Runtime device witness for the torch/CUDA port: kernel-build and
transfer instrumentation (test-only, lockdep-style) — the dynamic side of
``devicecheck``.

The static analyzer claims two properties of the hot serving paths:
steady-state serving never builds a kernel, and every implicit
device->host transfer is confined to the named fetch stage or carries a
reviewed allowlist reason. This witness checks both claims against what
actually happens, the same way ``witness.py`` checks the static lock
graph:

* **builds** — ``end_warmup()`` snapshots ``kernels.build_count()`` (the
  count of ``nvcc`` runs this process started); any later build is a
  post-warmup build and fails ``check()``.

* **transfers seen from Python** — ``install()`` wraps ``torch.Tensor``'s
  ``item``, ``tolist``, ``cpu``, ``numpy``, ``__bool__``, ``__int__``
  and ``__float__`` at class level, and swaps a recording proxy over the
  ``np`` binding in every imported ``tfidf_tpu_torch*`` module
  (``np.asarray`` / ``np.array`` / ``np.ascontiguousarray`` of a
  tensor). Each call is recorded at the first ``tfidf_tpu_torch`` frame
  on the stack as a ``(module, function, op)`` site. On a machine
  without CUDA every tensor stands in for a device tensor (the tier-1
  tests); with CUDA only CUDA tensors are recorded. ``uninstall()``
  restores the originals.

* **transfers the card reports** — with CUDA, ``install()`` also sets
  ``torch.cuda.set_sync_debug_mode("warn")``, which warns on every
  synchronizing CUDA call: the copies behind ``.item()`` and ``.cpu()``,
  the count copied back by an op whose output shape depends on the data
  (``nonzero``, ``unique``, boolean-mask indexing), stream and device
  synchronizes, and blocking host->device copies from pageable memory.
  The hook is process-wide — a ``warnings.showwarning`` replacement and
  an ``"always"`` filter for that message, never
  ``warnings.catch_warnings``, which is neither thread-safe nor
  per-thread, while the pipeline's dispatch and fetch threads warn from
  threads of their own. Each warning is attributed by walking the stack
  to the first port frame, with its direction: ``h2d`` inside a host->
  device copy (``Tensor.to`` / ``cuda`` / ``copy_`` from a CPU tensor,
  ``torch.tensor`` / ``torch.as_tensor`` of host data), ``d2h`` inside
  one of the wrapped methods or a ``torch.tensor`` / ``torch.as_tensor``
  whose data holds a device tensor, and ``sync`` otherwise. ``d2h`` and
  ``sync`` sites are gated like the Python-side transfers, and so is a
  reported sync with no port frame on its stack; blocking ``h2d`` copies
  are reported by site and count, not gated.

Every gated site must appear in the static explained set
(:func:`devicecheck.explained_transfer_sites`: the fetch stage, the
sanctioned bulk stages, plus allowlisted-with-reason sites) or
``check()`` fails — each side validating the other.

The hand-written kernel's launch goes through ``ctypes``, which sync debug
mode cannot see; it is asynchronous by construction (it returns
``cudaGetLastError()`` and calls no copy or synchronize), which a tier-1
test holds by reading ``csrc/*.cu``.

Vacuous-pass floor: ``check(min_observations=N)`` fails a run that
observed fewer than N transfers or syncs — an instrumented run that saw
nothing proves nothing (the lockdep ``min_multilock_edges`` contract).

Like the lockdep witness, the overhead makes this test-only: nothing
under ``tfidf_tpu_torch/`` outside ``tools/`` imports it.
"""

from __future__ import annotations

import os
import sys
import threading
import warnings

_PACKAGE = "tfidf_tpu_torch"
_TOOLS = f"{_PACKAGE}.tools"
_SYNC_MESSAGE = "called a synchronizing CUDA operation"

# torch.Tensor methods that leave the device -> the op name recorded
_D2H_METHODS = {"item": "item", "tolist": "tolist", "cpu": "cpu",
                "numpy": "numpy", "__bool__": "bool", "__int__": "int",
                "__float__": "float"}
# host->device entry points (for the direction of a reported sync)
_H2D_METHODS = ("to", "cuda", "copy_")
_H2D_FUNCS = ("tensor", "as_tensor")

_ACTIVE: list = [None]          # the installed witness, if any
_TLS = threading.local()        # .dir: direction of the enclosing copy


def _port_site(frame) -> tuple[str, str] | None:
    """(module, function) of the first ``tfidf_tpu_torch`` frame at or
    above ``frame`` (the tools subpackage excluded). A function nested in
    another (a closure, a local helper) is named by its outermost
    enclosing function, the unit the static cone reasons about: a helper
    ``h`` inside ``export_snapshot_arrays`` belongs to that stage."""
    while frame is not None:
        name = frame.f_globals.get("__name__", "")
        if name.startswith(_PACKAGE + ".") and not name.startswith(
                _TOOLS):
            code = frame.f_code
            qual = getattr(code, "co_qualname", code.co_name)
            if ".<locals>." in qual:
                fn = qual.split(".<locals>.")[0].rsplit(".", 1)[-1]
            else:
                fn = code.co_name
            return name[len(_PACKAGE) + 1:], fn
        frame = frame.f_back
    return None


def _host_data(src) -> bool:
    """Whether ``src``, the data of ``torch.tensor`` / ``as_tensor``,
    holds no tensor off the host (a device tensor, or a list of device
    scalars, is read back to the host by such a call)."""
    import torch
    if isinstance(src, torch.Tensor):
        return src.device.type == "cpu"
    if isinstance(src, (list, tuple)):
        return all(_host_data(x) for x in src)
    return True


def _kernels():
    from tfidf_tpu_torch import kernels
    return kernels


class _Direction:
    """Marks the calling thread as inside a copy of one direction."""

    def __init__(self, d: str) -> None:
        self.d = d

    def __enter__(self):
        self.prev = getattr(_TLS, "dir", None)
        if self.prev is None:
            _TLS.dir = self.d
        return self

    def __exit__(self, *exc):
        _TLS.dir = self.prev
        return False


class _NumpyProxy:
    """Delegating stand-in for the ``np`` binding in one package module:
    records fetcher calls whose first argument is a tensor, then
    delegates. Attribute access falls through to real numpy."""

    _FETCHERS = ("asarray", "array", "ascontiguousarray")

    def __init__(self, witness: "DeviceWitness", real) -> None:
        self._w = witness
        self._real = real

    def __getattr__(self, name: str):
        real_fn = getattr(self._real, name)
        if name not in self._FETCHERS:
            return real_fn
        w = self._w

        def wrapper(*args, **kwargs):
            if args and w._watched(args[0]):
                w._record_call(sys._getframe(1), name)
            return real_fn(*args, **kwargs)
        wrapper.__name__ = name
        return wrapper


class DeviceWitness:
    """One instrumented run: install -> (warmup) -> end_warmup ->
    exercise -> uninstall -> check."""

    def __init__(self, explained: set | None = None, *,
                 cpu_tensors: bool | None = None) -> None:
        # (module, function) pairs the static cone explains; None =
        # compute from the committed allowlist + the fetch-stage seam
        if explained is None:
            from tfidf_tpu_torch.tools.graftcheck.core import SourceTree
            from tfidf_tpu_torch.tools.graftcheck.devicecheck import (
                explained_transfer_sites)
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
            explained = explained_transfer_sites(SourceTree(root))
        self.explained = set(explained)
        import torch
        self._cuda = torch.cuda.is_available()
        # without CUDA every tensor stands in for a device tensor
        self.cpu_tensors = (not self._cuda if cpu_tensors is None
                            else cpu_tensors)
        # (module, function, op) -> count, from the Python-side wrappers
        self.observed: dict[tuple[str, str, str], int] = {}
        # (module, function, direction) -> count, reported by the card
        self.syncs: dict[tuple[str, str, str], int] = {}
        self.unattributed = 0    # card syncs with no port frame
        self._mu = threading.Lock()
        self._saved: list = []
        self._installed = False
        self._warmup_builds: int | None = None
        self._install_builds = 0

    # -- recording --------------------------------------------------------

    def _watched(self, x) -> bool:
        import torch
        return isinstance(x, torch.Tensor) and (
            self.cpu_tensors or x.device.type != "cpu")

    def _record_call(self, frame, op: str) -> None:
        site = _port_site(frame)
        if site is None:
            return
        key = (site[0], site[1], op)
        with self._mu:
            self.observed[key] = self.observed.get(key, 0) + 1

    def _record_sync(self, frame) -> None:
        site = _port_site(frame)
        with self._mu:
            if site is None:
                self.unattributed += 1
                return
            key = (site[0], site[1], getattr(_TLS, "dir", None) or "sync")
            self.syncs[key] = self.syncs.get(key, 0) + 1

    # -- lifecycle --------------------------------------------------------

    def install(self) -> "DeviceWitness":
        assert not self._installed and _ACTIVE[0] is None
        import numpy as _real_np
        import torch

        self._install_builds = _kernels().build_count()
        _ACTIVE[0] = self
        try:
            self._wrap_tensor(torch)
            for name, mod in list(sys.modules.items()):
                if mod is None or not (
                        name == _PACKAGE or name.startswith(_PACKAGE + ".")
                        ) or name.startswith(_TOOLS):
                    continue
                if mod.__dict__.get("np") is _real_np:
                    self._saved.append(("np", mod.__dict__, _real_np))
                    mod.__dict__["np"] = _NumpyProxy(self, _real_np)
            if self._cuda:
                self._hook_sync_warnings(torch)
        except BaseException:
            self.uninstall()
            raise
        self._installed = True
        return self

    def _wrap_tensor(self, torch) -> None:
        T = torch.Tensor
        w = self

        def d2h(attr, op, orig):
            def wrapper(t, *a, **kw):
                if w._watched(t):
                    w._record_call(sys._getframe(1), op)
                with _Direction("d2h"):
                    return orig(t, *a, **kw)
            wrapper.__name__ = attr
            return wrapper

        def h2d_method(attr, orig):
            def wrapper(t, *a, **kw):
                src = a[0] if attr == "copy_" and a else t
                host = isinstance(src, T) and src.device.type == "cpu"
                if host:
                    with _Direction("h2d"):
                        return orig(t, *a, **kw)
                return orig(t, *a, **kw)
            wrapper.__name__ = attr
            return wrapper

        def h2d_func(orig):
            def wrapper(*a, **kw):
                src = a[0] if a else kw.get("data")
                with _Direction("h2d" if _host_data(src) else "d2h"):
                    return orig(*a, **kw)
            wrapper.__name__ = orig.__name__
            return wrapper

        for attr, op in _D2H_METHODS.items():
            self._saved.append(("cls", attr, T.__dict__.get(attr)))
            setattr(T, attr, d2h(attr, op, getattr(T, attr)))
        if self._cuda:
            for attr in _H2D_METHODS:
                self._saved.append(("cls", attr, T.__dict__.get(attr)))
                setattr(T, attr, h2d_method(attr, getattr(T, attr)))
            for fn in _H2D_FUNCS:
                orig = getattr(torch, fn)
                self._saved.append(("attr", (torch, fn), orig))
                setattr(torch, fn, h2d_func(orig))

    def _hook_sync_warnings(self, torch) -> None:
        w = self
        self._prev_mode = torch.cuda.get_sync_debug_mode()
        self._prev_filters = list(warnings.filters)
        self._prev_show = warnings.showwarning
        prev_show = self._prev_show

        def showwarning(message, category, filename, lineno, file=None,
                        line=None):
            if _SYNC_MESSAGE in str(message):
                w._record_sync(sys._getframe(1))
                return
            prev_show(message, category, filename, lineno, file, line)

        warnings.filterwarnings("always", message=f".*{_SYNC_MESSAGE}")
        warnings.showwarning = showwarning
        torch.cuda.set_sync_debug_mode("warn")
        self._sync_hooked = True

    def uninstall(self) -> None:
        """Restore every wrapped method, proxy and hook (in a ``finally``:
        test workers run other files in the same process)."""
        import torch
        try:
            if getattr(self, "_sync_hooked", False):
                torch.cuda.set_sync_debug_mode(self._prev_mode)
                warnings.showwarning = self._prev_show
                warnings.filters[:] = self._prev_filters
                getattr(warnings, "_filters_mutated", lambda: None)()
                self._sync_hooked = False
        finally:
            for kind, where, orig in reversed(self._saved):
                if kind == "np":
                    where["np"] = orig
                elif kind == "attr":
                    setattr(where[0], where[1], orig)
                elif orig is None:
                    delattr(torch.Tensor, where)
                else:
                    setattr(torch.Tensor, where, orig)
            self._saved = []
            if _ACTIVE[0] is self:
                _ACTIVE[0] = None
            self._installed = False

    def end_warmup(self) -> None:
        """Builds up to here are warmup; any later one is a post-warmup
        build."""
        self._warmup_builds = _kernels().build_count()

    # -- verdict ----------------------------------------------------------

    def post_warmup_builds(self) -> int:
        base = (self._warmup_builds if self._warmup_builds is not None
                else self._install_builds)
        return _kernels().build_count() - base

    def n_observations(self) -> int:
        return sum(self.observed.values()) + sum(self.syncs.values())

    def unexplained(self) -> list[tuple[str, str, str]]:
        gated = list(self.observed) + [k for k in self.syncs
                                       if k[2] != "h2d"]
        return sorted(k for k in gated if (k[0], k[1]) not in self.explained)

    def report(self) -> str:
        lines = [f"device witness: {sum(self.observed.values())} tensor "
                 f"transfer(s) at {len(self.observed)} site(s), "
                 f"{sum(self.syncs.values())} card-reported sync(s) at "
                 f"{len(self.syncs)} site(s) ({self.unattributed} outside "
                 f"the port), {self.post_warmup_builds()} kernel build(s) "
                 f"after warmup"]
        for (mod, fn, op), n in sorted(self.observed.items()):
            mark = "" if (mod, fn) in self.explained else "  <-- UNEXPLAINED"
            lines.append(f"  {mod}.{fn} [{op}] x{n}{mark}")
        for (mod, fn, d), n in sorted(self.syncs.items()):
            mark = ("" if d == "h2d" or (mod, fn) in self.explained
                    else "  <-- UNEXPLAINED")
            lines.append(f"  {mod}.{fn} [cuda sync, {d}] x{n}{mark}")
        return "\n".join(lines)

    def check(self, *, max_post_warmup_builds: int | None = 0,
              min_observations: int = 0) -> None:
        """Raise AssertionError on any unexplained transfer or sync, on
        a card-reported sync with no port frame on its stack, on more than
        ``max_post_warmup_builds`` kernel builds after :meth:`end_warmup`
        (None skips the build check), or on a vacuous run that observed
        fewer than ``min_observations``."""
        problems: list[str] = []
        bad = self.unexplained()
        if bad:
            problems.append(
                f"{len(bad)} transfer site(s) the static cone did not "
                f"explain (add the code to the fetch stage, fix the sync, "
                f"or pin the devicecheck finding with a reviewed reason): "
                + ", ".join(f"{m}.{f} [{o}]" for m, f, o in bad))
        if self.unattributed:
            problems.append(
                f"{self.unattributed} card-reported sync(s) with no "
                f"{_PACKAGE} frame on the stack: no site can explain them")
        if max_post_warmup_builds is not None:
            n = self.post_warmup_builds()
            if n > max_post_warmup_builds:
                problems.append(
                    f"{n} post-warmup kernel build(s) (limit "
                    f"{max_post_warmup_builds}): a kernel library was "
                    f"built inside the steady-state window")
        if self.n_observations() < min_observations:
            problems.append(
                f"vacuous run: {self.n_observations()} observed "
                f"transfer(s) < floor {min_observations} — the "
                f"instrumented run no longer exercises the device paths "
                f"this witness exists to watch")
        if problems:
            raise AssertionError(
                "device witness FAILED:\n- " + "\n- ".join(problems)
                + "\n" + self.report())
