"""The sequence-parallel engine: long context over an sp × tp mesh.

The port of the JAX package's ``SPEngine`` (llama_fastapi_k8s_gpu_tpu/
engine/sp.py).  The KV ring's slots shard over the ``sp`` mesh axis and its
kv heads over ``tp``; a prompt pass runs ring attention and a decode step
the sharded log-sum-exp (parallel/ring.py), so no device holds more than
1/sp of the KV.  The serving surface — ``create_chat_completion``,
streaming, deadlines — stays the serial :class:`Engine`'s: only its two
call points, :meth:`Engine._prefill_call` and
:meth:`Engine._decode_chunk_call`, run on the mesh.  On the card a decode
chunk is replays of the sharded step's CUDA graph, as the serial engine's.

Enable from the server with ``LFKT_MESH_SP > 1`` (utils/config.py), with
``LFKT_MESH_TP`` for heads sharded inside the ring.  The mesh takes
``sp · tp`` devices: the pod's cards by default (too few raise), or an
explicit ``devices`` list, which may repeat a device (tests, and
``chip_smoke.py``'s ``mesh_sp`` arm on one card).
"""

from __future__ import annotations

import logging

import torch

from ..obs.devtime import record_dispatch
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.ring import sp_generate_chunk, sp_prefill
from .engine import Engine

logger = logging.getLogger(__name__)


class SPEngine(Engine):
    """An :class:`Engine` whose KV ring and attention are sequence-parallel.

    Serial like the base engine (one generation at a time); the mesh is
    spent on context length, not batch."""

    #: a prompt is one ring pass a bucket (the ring shards the bucket's rows)
    _SLICE_PREFILL = False
    #: the paged pool slices the ring's slot dim, which this ring shards
    _KV_PAGED = False
    #: decode attention is a collective over the ring's shards a layer
    _DECODE_LOOP = False
    _DECODE_PROGRAM = "sp_decode_chunk"
    _ATTN_IMPL = "ring"

    def __init__(self, model_path: str | None, *, sp: int = 2, tp: int = 1,
                 n_ctx: int = 4096, devices=None, **kw):
        if sp < 2:
            raise ValueError(f"SPEngine needs sp >= 2, got {sp} "
                             f"(use Engine for single-device serving)")
        attn = kw.pop("attn_impl", "auto")
        if attn not in ("auto", "ring"):
            raise ValueError(f"SPEngine serves ring attention; attn_impl must be "
                             f"auto|ring, got {attn!r}")
        if n_ctx % sp:
            raise ValueError(f"n_ctx {n_ctx} must divide sp={sp}")
        self.sp, self._tp, self._devices = sp, tp, devices
        # every reuse path prefills a suffix at an offset into the ring;
        # the reference's sequence-parallel engine keeps whole prefill
        kw["prefix_cache"] = False
        super().__init__(model_path, n_ctx=n_ctx, **kw)
        # the ring shards each bucket's rows over sp: buckets round up
        self.prefill_buckets = sorted(
            {min(self.cfg.n_ctx, -(-b // sp) * sp) for b in self.prefill_buckets})
        logger.info("SPEngine: n_ctx=%d over sp=%d tp=%d (%s)", self.cfg.n_ctx, sp, tp,
                    self.mesh)

    def _make_mesh(self) -> Mesh:
        return make_mesh(dp=1, tp=self._tp, sp=self.sp,
                         devices=self._mesh_devices(self._devices))

    # -- the call points, on the ring -------------------------------------
    def _prefill_call(self, tokens: torch.Tensor, length: int) -> torch.Tensor:
        record_dispatch("sp_prefill")
        return sp_prefill(self.params, self.cfg, tokens, length, self._cache)

    def _decode_chunk_call(self, state: dict, st: dict, n_steps: int,
                           top_k: int) -> torch.Tensor:
        return sp_generate_chunk(self.params, self.cfg, state, st, n_steps, top_k=top_k)
