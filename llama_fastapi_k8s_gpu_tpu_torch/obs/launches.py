"""Launch audit of one decode step: its kernel launches, counted exactly.

The JAX package's audit (llama_fastapi_k8s_gpu_tpu/obs/launches.py)
walks a decode step's jaxpr and counts its launch-bearing primitives
(``pallas_call``, ``dot_general``), weighted by the layer loop's trip
count.  The port has no jaxpr, so it runs one eager step and counts what
launches:

- a call of one of the port's kernel wrappers (the fused linears, the
  int8 KV write, the layer-looped kernel, flash attention) is **one**
  launch, whether its CUDA kernel or, on the CPU, its plain version runs —
  so the audit reads the same on both; what the plain version runs inside
  is not counted;
- every library product the step runs outside a wrapper — aten ``mm``,
  ``bmm``, ``addmm``, ``baddbmm`` and ``_int_mm``, as a
  ``TorchDispatchMode`` sees them — is one launch (the bf16 and int8
  linears and the decode attention's two products a layer).  Under
  ``torch.inference_mode`` a product reaches the mode whole, as
  ``matmul`` or ``linear``, and counts once as that; the decode-step audit
  runs under ``torch.no_grad``, where it arrives as ``mm``/``bmm``.  Elementwise
  ops, norms and reductions are not counted, as the reference's audit
  does not count what XLA fuses.

A launch made inside the layer stack (a ``models.llama._layer`` call, or
the layer-looped kernel's launches) is ``in_loop``; the output head is
``outside``.  ``loop_trips`` holds the layer stack's trip count: its
layers, or its looped launches.  The result has the reference's keys;
``by_prim`` is keyed by wrapper or aten op name, ``(flat)`` outside the
loop, and ``while_loops`` is always 0 (the port's loops are host loops of
known length).
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["count_launches", "decode_step_launches"]

#: library products counted as launches (aten op names)
LAUNCH_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "_int_mm", "mv", "dot",
                        "matmul", "linear"})


class _Audit:
    """The counts of one audited call, on the thread that makes it."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.result = {"total": 0, "in_loop": 0, "outside": 0, "by_prim": {},
                       "loop_trips": [], "while_loops": 0}
        self.inside_kernel = 0
        self.in_loop = 0
        self.trips = 0

    def add(self, name: str) -> None:
        r = self.result
        r["total"] += 1
        r["in_loop" if self.in_loop else "outside"] += 1
        key = name if self.in_loop else f"{name}(flat)"
        r["by_prim"][key] = r["by_prim"].get(key, 0) + 1


_ACTIVE: _Audit | None = None


def _audit() -> _Audit | None:
    a = _ACTIVE
    return a if a is not None and a.thread == threading.get_ident() else None


def _kernel(name: str, fn):
    """``fn`` counted as one launch of ``name`` (its insides uncounted)."""
    def call(*args, **kwargs):
        a = _audit()
        if a is None or a.inside_kernel:
            return fn(*args, **kwargs)
        a.add(name)
        a.inside_kernel += 1
        try:
            return fn(*args, **kwargs)
        finally:
            a.inside_kernel -= 1
    return call


def _loop(fn, trip_kernel: str | None = None):
    """``fn`` run as the layer stack: launches inside are ``in_loop``.  A
    call is one trip, or as many as it launched ``trip_kernel``.  A call
    inside a kernel's plain version is the kernel's, not the stack's."""
    def call(*args, **kwargs):
        a = _audit()
        if a is None or a.inside_kernel:
            return fn(*args, **kwargs)
        before = a.result["by_prim"].get(trip_kernel, 0)
        a.in_loop += 1
        try:
            return fn(*args, **kwargs)
        finally:
            a.in_loop -= 1
            a.trips += (1 if trip_kernel is None
                        else a.result["by_prim"].get(trip_kernel, 0) - before)
    return call


@contextlib.contextmanager
def _hooks():
    """Route the kernel wrappers and the layer loop through the audit for
    the duration (the call sites look them up at each call)."""
    from ..models import llama
    from ..ops import KERNELS, decode_loop, linear

    names = {fn: name for name, fn in KERNELS.items()}
    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    fused = dict(linear._FUSED)
    for kind, fn in fused.items():
        linear._FUSED[kind] = _kernel(names[fn], fn)
    for attr in ("kv_quantize", "flash_attention", "flash_attention_int8"):
        patch(llama, attr, _kernel(names[getattr(llama, attr)], getattr(llama, attr)))
    patch(decode_loop, "decode_loop_step",
          _kernel("decode_loop", decode_loop.decode_loop_step))
    patch(llama, "_layer", _loop(llama._layer))
    patch(decode_loop, "forward_layers_looped",
          _loop(decode_loop.forward_layers_looped, trip_kernel="decode_loop"))
    try:
        yield
    finally:
        linear._FUSED.update(fused)
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)


def _dispatch_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Products(TorchDispatchMode):
        """Counts the library products run outside a kernel wrapper."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            a = _audit()
            if a is not None and not a.inside_kernel:
                name = func._overloadpacket.__name__
                if name in LAUNCH_OPS:
                    a.add(name)
            return func(*args, **(kwargs or {}))

    return _Products()


_LOCK = threading.Lock()


def count_launches(fn, *args) -> dict:
    """Run ``fn(*args)`` once and return its launch audit::

        {"total":      launches of the call,
         "in_loop":    those inside the layer stack,
         "outside":    the others (the output head),
         "loop_trips": the layer stack's trip count,
         "by_prim":    {wrapper or aten op: count},
         "while_loops": 0}

    One audit at a time; other threads keep running unaudited and
    uncounted meanwhile."""
    global _ACTIVE
    with _LOCK:
        audit = _Audit()
        with _hooks():
            _ACTIVE = audit
            try:
                with _dispatch_mode():
                    fn(*args)
            finally:
                _ACTIVE = None
        if audit.trips:
            audit.result["loop_trips"].append(audit.trips)
        return audit.result


def decode_step_launches(params, cfg) -> dict:
    """Launch audit of ONE decode step under ``cfg`` (the per-layer path,
    or L/K looped launches under ``cfg.decode_layer_unroll``): a token at
    slot 0 of a scratch ring on the params' device.  On the card the
    step's kernels do launch; the wrappers' launch counters are put back
    afterwards, as a graph capture puts them back."""
    import torch

    from ..models.llama import decode_step, init_cache
    from ..ops import KERNELS

    device = params.tok_emb.device
    cache = init_cache(cfg, device)
    before = {name: fn.launches for name, fn in KERNELS.items()}
    try:
        with torch.no_grad():
            return count_launches(
                lambda: decode_step(params, cfg, torch.zeros((), dtype=torch.int64,
                                                             device=device), 0, cache))
    finally:
        for name, n in before.items():
            KERNELS[name].launches = n
