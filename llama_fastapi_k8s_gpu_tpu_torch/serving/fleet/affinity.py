"""Prefix-affinity keys + rendezvous hashing — the router's brain.

The port's copy of the JAX package's module
(llama_fastapi_k8s_gpu_tpu/serving/fleet/affinity.py); keys and rankings
are bit-identical to it, so a router and a log reader agree across the two
implementations.

The radix prefix cache (parallel/kvpool.py) makes a replica *warm* for the
conversations it has served.  Round-robin placement scatters a
conversation's turns across replicas, so every turn is cold somewhere.
The fix is a STABLE key per conversation, derived from the content the
radix tree keys on — the request's prefix:

- an explicit ``x-lfkt-affinity`` header wins (clients that know their
  conversation id pin themselves);
- ``/response``/``/response/stream`` bodies key on the bot profile (the
  persona is the system prompt) plus the conversation's FIRST user
  message — both byte-stable across every later turn;
- ``/v1/chat/completions`` bodies key on the OpenAI ``user`` field when
  set, else on (model, first system message, first user message);
- anything else falls back to a digest of the body (or the path for
  bodyless requests): retries of one request land on one replica.

The key picks its owner by **rendezvous (HRW) hashing** over the replica
set: each (key, peer) pair scores ``sha256(key|peer)`` and the highest
score owns the key.  Removing a peer remaps only that peer's keys, and the
sorted score order is the spill order.  sha256, not ``hash()``: Python's
string hash is salted per process, and the ranking must agree across
router restarts.
"""

from __future__ import annotations

import hashlib
import json

from ...obs.logctx import sanitize_text

#: explicit client-side affinity pin (e.g. a conversation id)
AFFINITY_HEADER = "x-lfkt-affinity"

#: router → replica migration stamps (serving/fleet/migrate.py): the
#: computed affinity key (the replica records it for graceful drain) and
#: the peer whose radix tree likely still holds this conversation's KV
#: pages (the replica pulls from it before prefilling — pull-on-remap).
#: Router-owned: inbound copies are stripped before forwarding, so a
#: client can never command a replica to pull from an arbitrary address.
AFFINITY_KEY_HEADER = "x-lfkt-affinity-key"
PRIOR_OWNER_HEADER = "x-lfkt-prior-owner"

#: stable-prefix characters folded into a derived key
_PREFIX_CHARS = 512


def _sha(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode("utf-8", "replace"))
        h.update(b"\x00")
    return h.hexdigest()[:32]


def _first_content(messages, role: str) -> str:
    for m in messages:
        if isinstance(m, dict) and m.get("role") == role:
            return str(m.get("content", ""))[:_PREFIX_CHARS]
    return ""


def affinity_key(path: str, headers: dict, body: bytes) -> tuple[str, str]:
    """(key, source) for one request.  ``source`` labels how the key was
    derived (``header`` | ``conversation`` | ``prefix`` | ``opaque``) —
    the router's ``fleet_requests_total`` attribution.  Never raises: an
    unparseable body degrades to the opaque digest."""
    hdr = headers.get(AFFINITY_HEADER, "")
    if hdr:
        # client bytes that ride into the forwarded stamp and the access
        # log: control bytes stripped first
        return "h:" + sanitize_text(hdr, limit=128), "header"
    doc = None
    if body:
        try:
            doc = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            doc = None
    if isinstance(doc, dict):
        if path.startswith("/v1/"):
            user = doc.get("user")
            if isinstance(user, str) and user:
                return "u:" + sanitize_text(user, limit=128), "conversation"
            msgs = doc.get("messages") or []
            sys_c = _first_content(msgs, "system")
            usr_c = _first_content(msgs, "user")
            if sys_c or usr_c:
                return ("p:" + _sha(str(doc.get("model", "")), sys_c,
                                    usr_c), "prefix")
        else:
            bp = doc.get("bot_profile") or {}
            ctx = doc.get("context") or []
            opener = ""
            if ctx and isinstance(ctx[0], dict):
                opener = str(ctx[0].get("message", ""))[:_PREFIX_CHARS]
            name = str(bp.get("name", "")) if isinstance(bp, dict) else ""
            sysp = (str(bp.get("system_prompt", ""))[:_PREFIX_CHARS]
                    if isinstance(bp, dict) else "")
            if name or sysp or opener:
                return "p:" + _sha(name, sysp, opener), "prefix"
    if body:
        return "o:" + hashlib.sha256(body).hexdigest()[:32], "opaque"
    return "o:" + _sha(path), "opaque"


def rendezvous_rank(key: str, peers: list[str]) -> list[str]:
    """Peers ordered by rendezvous score for ``key``, best first.  The
    head is the key's owner; the tail is the spill order when the owner
    is ejected."""
    return sorted(
        peers,
        key=lambda p: hashlib.sha256(f"{key}|{p}".encode()).digest(),
        reverse=True)
