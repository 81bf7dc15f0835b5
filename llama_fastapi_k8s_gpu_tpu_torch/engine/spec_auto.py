"""``spec_decode="auto"``: decide speculation from the measured dispatch
round trip (the reference's engine/spec_auto.py, on the card).

Cost model: pipelined chunked decode hides the host's round trip behind
the device's work, so a token costs its weight read, ``t_tok =
bytes_per_token / hbm_bw``.  A verify round cannot pipeline — the next
draft needs this round's accepted tokens on the host — so each round
pays the whole round trip ``rtt`` and yields ``1 + a`` tokens (``a`` the
acceptance).  ``(t_tok + rtt) / (1 + a)`` beats ``t_tok`` iff ``a > rtt /
t_tok``:

    breakeven_acceptance = rtt / t_tok

``auto`` takes lookup iff the breakeven is under ``LFKT_SPEC_AUTO_ACCEPT``
(default 1.0).  The decision and its inputs are logged and kept as
``engine.spec_auto_decision`` (``/health`` ``engine.spec_auto``).

The bandwidth default is the H100 SXM's published 3.35 TB/s (the figure
behind PERF.md's bounds), not the reference's v5e figure; a card held
under its power limit reads slower, so ``LFKT_HBM_GBPS`` overrides it.
"""

from __future__ import annotations

import statistics
import time

from ..utils.config import knob

#: H100 SXM HBM3, published bandwidth (GB/s); override with LFKT_HBM_GBPS
HBM_GBPS_DEFAULT = 3350.0


def measure_dispatch_rtt_s(n: int = 7) -> float:
    """Median wall time of one minimal CUDA launch plus the host fetch of
    its result: the overhead a verify round pays over a pipelined chunk.
    Two warm runs are discarded first."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to time a dispatch on")
    x = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(2):
        int(x + 1)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        int(x + 1)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def decode_bytes_per_token(params) -> int:
    """Device bytes one decode token must read: every weight byte but the
    token-embedding table (a one-row gather).  Over a mesh
    (``parallel.mesh.MeshParams``) the whole model's bytes, each weight
    counted once however it is laid out — what the reference counts over
    its global arrays."""
    if hasattr(params, "whole_nbytes"):
        emb = params.shard().tok_emb
        return max(params.whole_nbytes() - emb.numel() * emb.element_size(), 1)
    emb = params.tok_emb
    return max(params.nbytes() - emb.numel() * emb.element_size(), 1)


def resolve_auto(params, *, hbm_gbps: float | None = None,
                 accept: float | None = None) -> tuple[str, dict]:
    """→ ("lookup" | "off", decision record).  Never raises: a failed
    measurement resolves to "off" with the error recorded."""
    try:
        if hbm_gbps is None:
            hbm_gbps = knob("LFKT_HBM_GBPS")
        if accept is None:
            accept = knob("LFKT_SPEC_AUTO_ACCEPT")
        # a module-global lookup, so tests can replace the measurement
        rtt_s = measure_dispatch_rtt_s()
        bpt = decode_bytes_per_token(params)
        t_tok_s = bpt / (hbm_gbps * 1e9)
        breakeven = rtt_s / t_tok_s
        mode = "lookup" if breakeven < accept else "off"
        return mode, {
            "rtt_ms": round(rtt_s * 1e3, 3),
            "bytes_per_token": int(bpt),
            "t_tok_ms": round(t_tok_s * 1e3, 3),
            "breakeven_acceptance": round(breakeven, 3),
            "assumed_acceptance": accept,
            "hbm_gbps": hbm_gbps,
            "resolved": mode,
        }
    except Exception as e:  # noqa: BLE001 — serve without speculation
        return "off", {"resolved": "off", "error": str(e)[:200]}
