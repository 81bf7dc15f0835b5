"""lfkt-lint over the port — static analysis of the port's invariants.

The port's serving tier is concurrency-heavy code whose correctness rests
on hand-maintained protocols: lock disciplines in the engines and the
paged pool, the disagg page wire and the fleet router's client bytes,
purity of everything a captured CUDA graph runs (a host sync, env read or
clock read inside a capture is baked in at capture time or fails it), the
buffers whose addresses a graph holds, a single env-knob registry
(utils/config.py) that the GPU Helm chart and the docs must agree with,
and the kernel contract: every launcher of ``csrc/`` is bound, its status
checked, its launches counted, and a kernel that fails raises.

This package checks them at test time, on CPU, stdlib-``ast`` only; it
imports neither torch nor jax nor the package it analyzes:

- :mod:`.locks`       — LOCK001-004: ``_GUARDED_BY`` lock discipline and
                        thread-confinement declarations.
- :mod:`.concurrency` — LOCK005/006, ASY001/002: lock-order cycles,
                        blocking under a lock, blocking on the event loop.
- :mod:`.resources`   — RES001-003: resource lifecycle over the CFG
                        (``# lfkt: transfers[...]`` is the handoff audit).
- :mod:`.taint`       — TAINT001-003: attacker bytes reaching addresses,
                        paths and log records.
- :mod:`.wire`        — WIRE001-003: the wire-surface registry
                        (serving/wiresurface.py).
- :mod:`.configreg`   — CFG001-005: the LFKT_* knob registry against the
                        docs and ``helm-gpu/``; probe routes exist.
- :mod:`.obsreg`      — OBS001-003: the metric and memory-component
                        catalogs (obs/catalog.py).
- :mod:`.deadcode`    — DEAD001-002: unreferenced functions and bogus
                        ``__all__`` entries, counting only the port's own
                        consumers.
- :mod:`.perf`        — PERF001-002: every graph capture site and kernel is
                        registered with obs/devtime.py; every SLO names a
                        cataloged metric.
- :mod:`.graph`       — GRAPH001-003: purity of what a CUDA graph captures
                        (the port's JIT001-003).
- :mod:`.pin`         — PIN001-002: buffers a graph holds by address (the
                        port's DON001-002).
- :mod:`.kernels`     — KER001-003: the port's kernel contract — bound,
                        status-checked, counted, no fallback.

The RES, WIRE and KER-path rules run on :mod:`.cfg` — statement-level
control-flow graphs with exception edges plus a forward may/must dataflow
solver; the interprocedural rules on :mod:`.callgraph`.

Run ``python -m llama_fastapi_k8s_gpu_tpu_torch.lint`` (exit 1 on
findings, ``--json`` for machine-readable output) or the tier-1 tests in
tests/test_torch_lint.py.  Suppress a finding with
``# lfkt: noqa[<RULE>] -- reason`` (the reason is mandatory; unknown rule
IDs are themselves findings).
"""

from .core import Finding, all_rules, run_lint  # noqa: F401

__all__ = ["Finding", "all_rules", "run_lint"]
