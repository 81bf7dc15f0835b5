"""Live device-memory ledger: where the card's memory went.

The JAX package's ledger (llama_fastapi_k8s_gpu_tpu/obs/memledger.py).
Every allocation surface registers a live byte-count provider under a
component of :data:`~.catalog.MEM_COMPONENTS` (an unknown name raises
``KeyError``), with its owner held by **weakref**, so a closed engine's
rows vanish with it.  Providers read sizes only and run at snapshot time
(``/debug/memory``, scrapes, incident bundles), never on the decode path.
The serial engine registers ``weights`` and ``kv_ring``.

Ground truth, which the attributed sum is reconciled against (the
``residual`` line):

- **on the card**, the caching allocator's live bytes,
  ``torch.cuda.memory_stats(dev)["allocated_bytes.all.current"]``, with
  the card's total memory (``torch.cuda.mem_get_info(dev)``) as the limit.
  Live blocks only: memory the allocator holds cached, the CUDA context
  and cuBLAS's workspace outside the allocator are not in it.  Whatever
  the decode graphs' private pool holds between replays, and every other
  allocation no component names, lands in ``residual``.  Where CUDA is
  available the ledger never takes the CPU walk below: a failed probe
  reads ``unavailable``.
- **on the CPU** there is no allocator to ask: the storage bytes of every
  live tensor the garbage collector tracks, each storage counted once (by
  its data pointer); ``source`` says ``gc.live_tensors``.

:meth:`MemLedger.pressure` (device headroom under
``LFKT_MEM_PRESSURE_FRACTION`` of the limit) and :meth:`MemLedger.fit_check`
keep the reference's API for the continuous scheduler and the model
registry; the serial pod reads neither.

Zero cost when disarmed (``LFKT_MEM_LEDGER=0``): ``pressure()`` returns
False on one attribute read and ``snapshot()`` a two-key stub.
"""

from __future__ import annotations

import gc
import logging
import threading
import weakref

from .catalog import MEM_COMPONENTS

logger = logging.getLogger(__name__)

#: /debug/memory document schema
SCHEMA = 1


def _live_tensor_bytes() -> int:
    """The CPU's ground truth: the storage bytes of every live CPU tensor
    ``gc`` tracks, each storage once."""
    import torch

    seen: dict[int, int] = {}
    for obj in gc.get_objects():
        # the type, not isinstance: a lazy module attribute must not load
        if not issubclass(type(obj), torch.Tensor) or obj.device.type != "cpu":
            continue
        try:
            st = obj.untyped_storage()
        except Exception:  # noqa: BLE001 — a tensor without storage
            continue
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class MemLedger:
    """The process-wide ledger (module instance: :data:`MEMLEDGER`)."""

    def __init__(self, armed: bool | None = None,
                 pressure_fraction: float | None = None):
        if armed is None or pressure_fraction is None:
            from ..utils.config import knob

            if armed is None:
                armed = bool(knob("LFKT_MEM_LEDGER"))
            if pressure_fraction is None:
                pressure_fraction = float(knob("LFKT_MEM_PRESSURE_FRACTION"))
        self._lock = threading.Lock()
        #: (component, weakref(owner), provider)
        self._entries: list[tuple] = []
        self._armed = bool(armed)
        self.pressure_fraction = max(0.0, min(1.0, float(pressure_fraction)))
        #: latched after a probe found no device: pressure() then never
        #: probes again
        self._no_device_stats = False
        #: (free_bytes, limit_bytes) of the last successful probe
        self.last_headroom: tuple[int, int] | None = None
        #: test seam: () -> {"bytes_in_use", "bytes_limit"}; None = the card
        self.stats_fn = None

    # -- configuration (tests + ops) ---------------------------------------
    def configure(self, armed: bool | None = None,
                  pressure_fraction: float | None = None) -> None:
        if armed is not None:
            self._armed = bool(armed)
        if pressure_fraction is not None:
            self.pressure_fraction = max(0.0, min(1.0, float(pressure_fraction)))

    @property
    def armed(self) -> bool:
        return self._armed

    def reset(self) -> None:
        """Drop every registration (tests)."""
        with self._lock:
            self._entries = []

    # -- registration ------------------------------------------------------
    def register_component(self, component: str, owner, provider) -> None:
        """Register one allocation surface: ``provider(owner)`` returns its
        live bytes (the row's model label is the owner's ``model_name``) or
        ``{model: bytes}``.  Weakly held; idempotent per (component,
        owner)."""
        spec = MEM_COMPONENTS.get(component)
        if spec is None or component == "residual":
            raise KeyError(
                f"memory component {component!r} is not in the "
                "MEM_COMPONENTS catalog (obs/catalog.py); register it "
                "before reporting it" if spec is None else
                "the 'residual' component is computed by the ledger, "
                "never registered")
        ref = weakref.ref(owner)
        with self._lock:
            for comp, r, _fn in self._entries:
                if comp == component and r() is owner:
                    return
            self._entries.append((component, ref, provider))

    # -- consumers ---------------------------------------------------------
    def _rows(self) -> list[dict]:
        """Live attribution rows, equal (component, model) keys summed.
        Dead owners are pruned; a raising provider is skipped."""
        with self._lock:
            entries = list(self._entries)
        merged: dict[tuple, int] = {}
        dead = False
        for component, ref, provider in entries:
            owner = ref()
            if owner is None:
                dead = True
                continue
            try:
                val = provider(owner)
            except Exception:  # noqa: BLE001 — telemetry must never fail
                logger.exception("memory-ledger provider for %r raised", component)
                continue
            spec = MEM_COMPONENTS[component]
            items = (val.items() if isinstance(val, dict)
                     else ((getattr(owner, "model_name", "") or "", val),))
            for model, b in items:
                b = max(0, int(b or 0))
                if b == 0 and not spec.always:
                    continue
                key = (component, str(model))
                merged[key] = merged.get(key, 0) + b
        if dead:
            with self._lock:
                self._entries = [e for e in self._entries if e[1]() is not None]
        return [{"component": c, "model": m, "bytes": b,
                 "device": MEM_COMPONENTS[c].device}
                for (c, m), b in sorted(merged.items())]

    def _raw_device_stats(self) -> dict | None:
        """The card's live bytes and limit, or None without a card.  Raises
        when CUDA is there but cannot be read."""
        import torch

        if not torch.cuda.is_available():
            return None
        dev = torch.cuda.current_device()
        in_use = int(torch.cuda.memory_stats(dev).get("allocated_bytes.all.current", 0))
        _free, total = torch.cuda.mem_get_info(dev)
        return {"bytes_in_use": in_use, "bytes_limit": int(total)}

    def _device_stats(self) -> dict:
        if self.stats_fn is not None:
            try:
                return dict(self.stats_fn() or {})
            except Exception:  # noqa: BLE001 — the seam keeps the contract
                return {}
        if self._no_device_stats:
            return {}
        try:
            stats = self._raw_device_stats()
        except Exception:  # noqa: BLE001 — a card that cannot be read
            logger.exception("CUDA memory stats unreadable")
            return {"error": True}
        if stats is None:
            self._no_device_stats = True
            return {}
        return stats

    def ground_truth(self) -> dict:
        """What the device holds: the CUDA allocator's live bytes on the
        card, the live tensors' storage on the CPU."""
        stats = self._device_stats()
        if "bytes_in_use" in stats:
            limit = stats.get("bytes_limit")
            return {"source": ("torch.cuda.memory_stats" if self.stats_fn is None
                               else "stats_fn"),
                    "bytes": int(stats["bytes_in_use"]),
                    "limit": int(limit) if limit else None}
        if stats.get("error"):
            return {"source": "unavailable", "bytes": None, "limit": None}
        return {"source": "gc.live_tensors", "bytes": _live_tensor_bytes(),
                "limit": None}

    def snapshot(self) -> dict:
        """The ``/debug/memory`` document: attribution rows, ground truth,
        the residual line and headroom (the reference's schema)."""
        if not self._armed:
            return {"schema": SCHEMA, "armed": False}
        rows = self._rows()
        truth = self.ground_truth()
        attributed = sum(r["bytes"] for r in rows if r["device"])
        host = sum(r["bytes"] for r in rows if not r["device"])
        residual = truth["bytes"] - attributed if truth["bytes"] is not None else None
        headroom = None
        if truth["bytes"] is not None and truth["limit"]:
            headroom = {
                "bytes": truth["limit"] - truth["bytes"],
                "limit": truth["limit"],
                "fraction": round((truth["limit"] - truth["bytes"]) / truth["limit"], 4),
                "pressure_fraction": self.pressure_fraction,
            }
        return {
            "schema": SCHEMA,
            "armed": True,
            "components": rows,
            "attributed_bytes": attributed,
            "host_bytes": host,
            "ground_truth": truth,
            "residual_bytes": residual,
            "headroom": headroom,
        }

    def pressure(self) -> bool:
        """True when device headroom is under ``pressure_fraction`` of the
        limit.  Disarmed: one attribute read.  Without a card: False, and
        the probe latches off."""
        if not self._armed:
            return False
        stats = self._device_stats()
        limit = stats.get("bytes_limit")
        if not limit:
            return False
        free = int(limit) - int(stats.get("bytes_in_use", 0))
        self.last_headroom = (free, int(limit))
        return free < self.pressure_fraction * int(limit)

    def fit_check(self, est_bytes: int, label: str = "") -> str | None:
        """Would loading ``est_bytes`` more overrun the device?  The refusal
        message, or None when it fits or cannot be judged."""
        if not self._armed or est_bytes <= 0:
            return None
        stats = self._device_stats()
        limit = stats.get("bytes_limit")
        if not limit:
            return None
        free = int(limit) - int(stats.get("bytes_in_use", 0))
        need = int(est_bytes)
        if need <= free:
            return None
        return (f"pre-load fit check: loading {label or 'model'!s} needs "
                f"~{need / 1e6:.0f}MB but the device reports only "
                f"{free / 1e6:.0f}MB of {limit / 1e6:.0f}MB free")


#: THE process-wide ledger
MEMLEDGER = MemLedger()


def register_component(component: str, owner, provider) -> None:
    """Register on the current process ledger (resolved at call time so
    tests can swap :data:`MEMLEDGER`)."""
    MEMLEDGER.register_component(component, owner, provider)
