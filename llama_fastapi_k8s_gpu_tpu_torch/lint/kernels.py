"""KER001-003: the port's kernel contract.

The JAX package's KER001-003 (and its EXC001) enforce a Pallas kernel's
probe-or-fallback contract: a Mosaic failure must degrade a pod to a
slower XLA path.  The port inverts it.  A hand-written Hopper kernel that
fails to build or launch raises — there is no fallback that hides the
device or a kernel — and every launch is bound, status-checked and
counted, so a run can prove which kernels it went through.  The contract,
over ``ops/_kernels.py`` ``SIGNATURES``, the wrappers in ``ops/`` and
``csrc/``:

- KER001 — every ``SIGNATURES`` key has an ``extern "C"`` (``LFKT_API``)
  definition in ``csrc/*.cu``; every ``lfkt_*`` symbol that ``ops/`` uses
  is bound (in ``SIGNATURES`` or given its ``argtypes`` in
  ``_kernels.py``); and every launcher (a definition taking a stream) is
  reached by exactly one wrapper, at a call whose
  status goes straight into ``_kernels.check(...)``, in a function that
  counts the launch (``<wrapper>.launches += 1``).  A wrapper is an
  ``ops/`` function with a module-level ``<name>.launches = 0``.
- KER002 — no fallback: the wrapper's module defines its plain version
  (a ``*_plain`` function the wrapper's path names); the plain version is
  chosen by the tensor's device type alone (an ``if`` whose test is a
  single ``<tensor>.device.type ==/!= "<type>"`` comparison); and no
  ``except`` on the path from the wrapper to the launch (the ``ops/``
  helpers, ``_kernels``, ``utils/kernelcache.py``) completes without
  raising.
- KER003 — every wrapper is in ``ops/__init__.py`` ``KERNELS`` (launch
  counters and ``register_program``), and ``chip_smoke.py`` names it among
  the kernels it holds against their plain versions.

Only the package's ``ops/`` tree and ``csrc/`` are read; the checker skips
itself where the package has no ``ops/_kernels.py``.
"""

from __future__ import annotations

import ast
import os
import re

from .core import Context, Finding, Source, const_str, dotted
from .graph import _Index

RULES = {
    "KER001": "kernel launcher not defined in csrc/, not bound, not launched "
              "by exactly one wrapper, or launched without a status check "
              "or a launch count",
    "KER002": "kernel wrapper without its plain version, choosing it by more "
              "than the device type, or with an except that does not raise "
              "on the path to the launch",
    "KER003": "kernel wrapper missing from ops.KERNELS or not held by "
              "chip_smoke.py",
}

KERNELS_REL = "ops/_kernels.py"
OPS_INIT_REL = "ops/__init__.py"
OPS_DIR = "ops/"
#: modules on a wrapper's path to the launch (besides ops/)
PATH_MODULES = ("utils.kernelcache",)
_SYMBOL_RE = re.compile(r"^lfkt_\w+$")
_STREAM_RE = re.compile(r"\bstream\b|\bcudaStream_t\b")
_C_DEF_RE = re.compile(r"(?:LFKT_API|extern\s+\"C\")[^;{(]*?\b(lfkt_\w+)\s*\(([^)]*)\)")


def _signatures(src: Source) -> dict[str, int]:
    """SIGNATURES key -> line."""
    out: dict[str, int] = {}
    for stmt in src.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == "SIGNATURES" \
                and isinstance(stmt.value, ast.Dict):
            for k in stmt.value.keys:
                name = const_str(k) if k is not None else None
                if name:
                    out[name] = k.lineno
    return out


def _bound_by_argtypes(src: Source) -> set[str]:
    """Symbols given their argtypes by name: ``lib.<sym>.argtypes = ...``."""
    out = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "argtypes" \
                        and isinstance(t.value, ast.Attribute) \
                        and _SYMBOL_RE.match(t.value.attr):
                    out.add(t.value.attr)
    return out


def _c_definitions(csrc: str) -> dict[str, bool]:
    """C symbol -> whether it takes a stream (a launcher: a parameter named
    ``stream`` or of type ``cudaStream_t``)."""
    out: dict[str, bool] = {}
    if not os.path.isdir(csrc):
        return out
    for name in sorted(os.listdir(csrc)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(csrc, name), encoding="utf-8") as f:
            text = f.read()
        for m in _C_DEF_RE.finditer(text):
            out[m.group(1)] = bool(_STREAM_RE.search(m.group(2)))
    return out


def _symbols_in(node: ast.AST) -> set[str]:
    """``lfkt_*`` names a function body uses: attributes and strings."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and _SYMBOL_RE.match(sub.attr):
            out.add(sub.attr)
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and _SYMBOL_RE.match(sub.value):
            out.add(sub.value)
    return out


def _launch_calls(fn: ast.AST, launchers: set[str]):
    """Calls in ``fn`` that invoke a kernel launcher: ``x.<launcher>(...)``
    or the helper form ``getattr(<lib>, <name>)(...)``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in launchers:
            yield node, f.attr
        elif isinstance(f, ast.Call) and dotted(f.func) == "getattr" \
                and len(f.args) == 2 and not isinstance(f.args[1], ast.Constant):
            yield node, None


def _status_checked(fn: ast.AST, call: ast.Call) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and node.args and node.args[0] is call:
            d = dotted(node.func)
            if d and d.split(".")[-1] == "check":
                return True
    return False


def _counts_launch(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Attribute) \
                and node.target.attr == "launches":
            return True
    return False


def _wrappers(ctx: Context) -> dict[str, tuple[Source, int]]:
    """Wrapper name -> (module source, line of ``<name>.launches = 0``)."""
    out = {}
    for src in ctx.sources:
        if not src.rel.startswith(OPS_DIR):
            continue
        defs = {s.name for s in src.tree.body
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for stmt in src.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                t = stmt.targets[0]
                if isinstance(t, ast.Attribute) and t.attr == "launches" \
                        and isinstance(t.value, ast.Name) and t.value.id in defs:
                    out[t.value.id] = (src, stmt.lineno)
    return out


def _on_path(index: _Index, key: tuple, wrapper_keys: set) -> list:
    """The indexed functions a wrapper's launch path may run: the wrapper
    and every function it references in ops/ and :data:`PATH_MODULES`,
    stopping at other wrappers and at the plain versions (``*_plain``: the
    CPU path, not the launch's)."""
    seen: set[tuple] = set()
    todo = [key]
    while todo:
        k = todo.pop()
        if k in seen or k not in index.fns:
            continue
        if k != key and (k in wrapper_keys or k[1].endswith("_plain")):
            continue
        seen.add(k)
        fn = index.fns[k]
        for node in ast.walk(fn.node):
            if isinstance(node, (ast.Name, ast.Attribute)):
                for tgt in index.resolve(fn.module, node, scope=fn):
                    mod = tgt[0]
                    if mod.startswith("ops.") or mod == "ops" or mod in PATH_MODULES:
                        todo.append(tgt)
    return [index.fns[k] for k in sorted(seen)]


def _is_device_test(test: ast.AST) -> bool:
    """A single ``<tensor>.device.type ==/!= "<type>"`` comparison."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], (ast.Eq, ast.NotEq))):
        return False
    sides = [test.left, test.comparators[0]]
    has_type = any(isinstance(s, ast.Attribute) and s.attr == "type"
                   and isinstance(s.value, ast.Attribute)
                   and s.value.attr == "device" for s in sides)
    return has_type and any(const_str(s) is not None for s in sides)


def _plain_calls(fn: ast.AST, plain_names: set[str]):
    """Calls of a plain version inside ``fn``: by name, or through a
    parameter named ``plain``."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and (node.func.id in plain_names or node.func.id == "plain"):
            yield node


def _device_guarded(fn: ast.AST, call: ast.Call) -> bool:
    """Whether ``call`` sits in the body of an ``if`` on the device type
    alone (the plain branch of the wrapper)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and _is_device_test(node.test):
            for stmt in node.body:
                if any(sub is call for sub in ast.walk(stmt)):
                    return True
    return False


def _falls_through(handler: ast.ExceptHandler) -> bool:
    return not (handler.body and isinstance(handler.body[-1], ast.Raise))


def check(ctx: Context) -> list[Finding]:
    ksrc = next((s for s in ctx.sources if s.rel == KERNELS_REL), None)
    if ksrc is None:
        return []
    out: list[Finding] = []
    kpath = ctx.display_path(ksrc)
    sigs = _signatures(ksrc)
    bound = set(sigs) | _bound_by_argtypes(ksrc)
    cdefs = _c_definitions(os.path.join(ctx.package_dir, "csrc"))
    launchers = {s for s in sigs if cdefs.get(s)}
    ops = [s for s in ctx.sources if s.rel.startswith(OPS_DIR)]

    # -- KER001: defined, bound ---------------------------------------------
    for sym, line in sorted(sigs.items()):
        if sym not in cdefs:
            out.append(Finding(
                "KER001", kpath, line,
                f"SIGNATURES binds {sym}, which no csrc/*.cu defines with "
                "extern \"C\" (LFKT_API)"))
    for src in ops:
        for node in ast.walk(src.tree):
            sym = None
            if isinstance(node, ast.Attribute) and _SYMBOL_RE.match(node.attr):
                sym = node.attr
            elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and _SYMBOL_RE.match(node.value):
                sym = node.value
            if sym is not None and sym not in bound:
                out.append(Finding(
                    "KER001", ctx.display_path(src), node.lineno,
                    f"{sym} is used but not bound: add it to "
                    "ops/_kernels.py SIGNATURES (ctypes would pass its "
                    "arguments unchecked)"))

    # -- KER001: status-checked and counted at every launch -------------------
    for src in ops:
        for fn in ast.walk(src.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for call, sym in _launch_calls(fn, launchers):
                what = sym or "a launcher"
                if not _status_checked(fn, call):
                    out.append(Finding(
                        "KER001", ctx.display_path(src), call.lineno,
                        f"{fn.name} launches {what} without passing its "
                        "status to _kernels.check(...): a refused launch "
                        "would pass silently"))
                if not _counts_launch(fn):
                    out.append(Finding(
                        "KER001", ctx.display_path(src), call.lineno,
                        f"{fn.name} launches {what} without counting it "
                        "(<wrapper>.launches += 1)"))

    # -- KER001/002: per wrapper ---------------------------------------------
    index = _Index(ctx)
    wrappers = _wrappers(ctx)
    wkeys = {(ctx.module_name(src), name): name
             for name, (src, _) in wrappers.items()}
    reaches: dict[str, set[str]] = {}
    for (module, name), _ in sorted(wkeys.items()):
        src, line = wrappers[name]
        path = _on_path(index, (module, name), set(wkeys))
        syms = set()
        for fn in path:
            syms |= _symbols_in(fn.node)
        reaches[name] = syms & launchers
        if not reaches[name]:
            out.append(Finding(
                "KER001", ctx.display_path(src), line,
                f"wrapper {name} counts launches but reaches no kernel "
                "launcher of SIGNATURES"))
        plains = {s.name for s in src.tree.body
                  if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and s.name.endswith("_plain")}
        named = set()
        for fn in path:
            named |= {n.id for n in ast.walk(fn.node)
                      if isinstance(n, ast.Name) and n.id in plains}
        if not named:
            out.append(Finding(
                "KER002", ctx.display_path(src), line,
                f"wrapper {name} has no plain version in its module (a "
                "*_plain function its path names): CPU tensors need one, "
                "and it is what chip runs hold the kernel against"))
        for fn in path:
            fpath = ctx.display_path(fn.src)
            for call in _plain_calls(fn.node, plains):
                if not _device_guarded(fn.node, call):
                    out.append(Finding(
                        "KER002", fpath, call.lineno,
                        f"{fn.key[1]} runs the plain version outside a "
                        "test of the device type alone: a wrapper chooses "
                        "by device, never as a fallback"))
            for node in ast.walk(fn.node):
                if isinstance(node, ast.ExceptHandler) and _falls_through(node):
                    out.append(Finding(
                        "KER002", fpath, node.lineno,
                        f"{fn.key[1]} is on {name}'s path to the launch and "
                        "has an except that completes without raising: a "
                        "kernel that fails must raise, not fall back"))
    for sym in sorted(launchers):
        users = sorted(n for n, s in reaches.items() if sym in s)
        if len(users) != 1:
            out.append(Finding(
                "KER001", kpath, sigs[sym],
                f"launcher {sym} is reached by {len(users)} wrappers "
                f"({', '.join(users) or 'none'}); exactly one wrapper "
                "launches each kernel and counts it"))

    # -- KER003: KERNELS and chip_smoke.py -----------------------------------
    init = next((s for s in ctx.sources if s.rel == OPS_INIT_REL), None)
    listed: dict[str, str] = {}        # wrapper name -> KERNELS key
    if init is not None:
        for stmt in init.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "KERNELS" \
                    and isinstance(stmt.value, ast.Dict):
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    key = const_str(k) if k is not None else None
                    if key and isinstance(v, ast.Name):
                        listed[v.id] = key
    smoke_names: set[str] | None = None
    if ctx.repo_root:
        smoke = os.path.join(ctx.repo_root, "chip_smoke.py")
        if os.path.isfile(smoke):
            with open(smoke, encoding="utf-8") as f:
                tree = ast.parse(f.read(), smoke)
            smoke_names = {n.value for n in ast.walk(tree)
                           if isinstance(n, ast.Constant)
                           and isinstance(n.value, str)}
    for name, (src, line) in sorted(wrappers.items()):
        key = listed.get(name)
        if key is None:
            out.append(Finding(
                "KER003", ctx.display_path(src), line,
                f"wrapper {name} is not in ops/__init__.py KERNELS: its "
                "launch counter and devtime registration are missing"))
        elif smoke_names is not None and key not in smoke_names:
            out.append(Finding(
                "KER003", ctx.display_path(src), line,
                f"chip_smoke.py never names kernel {key!r}: every kernel "
                "is built, launched and held against its plain version "
                "there"))
    return out
