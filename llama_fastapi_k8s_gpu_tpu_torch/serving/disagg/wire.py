"""The disagg page wire format — versioned, geometry-checked, leaf-generic.

The port's copy of the JAX package's wire
(llama_fastapi_k8s_gpu_tpu/serving/disagg/wire.py): the same frames, the
same handshake and the same page payload, byte for byte, so a port tier
and a JAX tier exchange pages.  Pages are torch tensors here: a payload is
each leaf's raw bytes (``Tensor.view(torch.uint8)``), and a received one
is read back with ``torch.frombuffer(...).view(dtype)`` — bf16 included,
with no ``ml_dtypes``.

A finished prefill under ``LFKT_KV_PAGED=1`` is a set of self-contained
pages (parallel/kvpool.py): the int8 four-leaf page carries its scales,
and the bf16 ``{k, v}`` page serializes through the same leaf-generic
path.  serving/disagg/transport.py carries the frames:

frame layout (all integers big-endian)::

    u32  frame length N (bytes after this field; bounded by MAX_FRAME)
    u8   frame type (FRAME_* below)
    u32  header length H
    H    UTF-8 JSON header
    *    raw payload (PAGE frames: concatenated leaf page stacks)

Conversation: the client opens with HELLO carrying the wire schema
version and its pool's page geometry (page_tokens and per-leaf page shape
and dtype — ``KVPool.page_spec()``); the server answers HELLO_OK, or an
ERR with attribution and closes — two pools that cannot exchange pages
bit-exactly refuse at the handshake, never corrupt KV.  Each REQ (token
ids, namespace, absolute deadline) is answered by zero or more PAGE
frames (groups of up to :data:`PAGE_GROUP` pages; payload = every cache
leaf's page stack concatenated in sorted leaf order, raw bytes) and one
DONE (tokens covered, total pages, advisory greedy first token).  Any
malformed, truncated or oversized frame raises :class:`WireError` — the
decode side degrades to local prefill, it never guesses.

The schema is pinned: ``python -m
llama_fastapi_k8s_gpu_tpu_torch.serving.disagg.wire --check-golden``
compares :func:`schema_descriptor` with ``docs/disagg_wire_schema.json``,
the JAX package's golden — bump :data:`WIRE_SCHEMA` on both sides and
regenerate it deliberately.
"""

from __future__ import annotations

import json
import struct

import torch

#: bump on ANY change to the frame layout, header fields, or page payload
#: encoding — a version mismatch refuses at the handshake with attribution
#: (2: REQ carries an optional ``trace`` W3C traceparent so the serving
#: side opens span trees linked to the originating request id)
WIRE_SCHEMA = 2

#: hard bound on one frame (length prefix sanity: a corrupt/hostile length
#: must not allocate gigabytes before the JSON parse even runs)
MAX_FRAME = 1 << 30

#: pages per PAGE frame: bounds per-frame memory on both sides and gives
#: the fault drills a mid-stream grain (a multi-page transfer is several
#: frames, so peer-death/truncation can land BETWEEN pages)
PAGE_GROUP = 4

FRAME_HELLO = 1      # client → server: schema + page geometry
FRAME_HELLO_OK = 2   # server → client: handshake accepted
FRAME_REQ = 3        # client → server: one prefill request
FRAME_PAGE = 4       # server → client: one group of pages
FRAME_DONE = 5       # server → client: request complete
FRAME_ERR = 6        # either direction: refusal/failure with attribution

FRAME_NAMES = {
    FRAME_HELLO: "HELLO", FRAME_HELLO_OK: "HELLO_OK", FRAME_REQ: "REQ",
    FRAME_PAGE: "PAGE", FRAME_DONE: "DONE", FRAME_ERR: "ERR",
}

_HEAD = struct.Struct("!BI")      # type, header length (inside the frame)
_LEN = struct.Struct("!I")        # frame length prefix


class WireError(ValueError):
    """A malformed, truncated, oversized or version-incompatible frame —
    the decode side treats every instance as 'this transfer is void:
    degrade to local prefill', never as data."""


def encode_frame(ftype: int, header: dict, payload: bytes = b"") -> bytes:
    """One wire frame, length prefix included."""
    if ftype not in FRAME_NAMES:
        raise WireError(f"unknown frame type {ftype}")
    h = json.dumps(header, separators=(",", ":")).encode("utf-8")
    n = _HEAD.size + len(h) + len(payload)
    if n > MAX_FRAME:
        raise WireError(f"frame of {n} bytes exceeds MAX_FRAME {MAX_FRAME}")
    return _LEN.pack(n) + _HEAD.pack(ftype, len(h)) + h + payload


def decode_frame(buf) -> tuple[int, dict, bytes]:
    """(ftype, header, payload) from one frame's post-length bytes (bytes,
    or a memoryview whose payload slice is returned without a copy).
    Raises :class:`WireError` on anything that is not an exact, valid
    frame — a truncated read upstream shows up here as a hard error."""
    if len(buf) < _HEAD.size:
        raise WireError(f"truncated frame: {len(buf)} bytes < header")
    ftype, hlen = _HEAD.unpack_from(buf)
    if ftype not in FRAME_NAMES:
        raise WireError(f"unknown frame type {ftype}")
    if _HEAD.size + hlen > len(buf):
        raise WireError(
            f"truncated frame: header claims {hlen} bytes, "
            f"{len(buf) - _HEAD.size} present")
    try:
        header = json.loads(bytes(buf[_HEAD.size:_HEAD.size + hlen]))
    except ValueError as e:
        raise WireError(f"frame header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise WireError("frame header must be a JSON object")
    return ftype, header, buf[_HEAD.size + hlen:]


# ---------------------------------------------------------------------------
# geometry handshake
# ---------------------------------------------------------------------------

def pool_geometry(pool) -> dict:
    """The HELLO geometry block for one KVPool: page size + per-leaf page
    shape/dtype (``KVPool.page_spec()``), plus the wire schema version."""
    return {
        "wire_schema": WIRE_SCHEMA,
        "page_tokens": pool.page_tokens,
        "page_bytes": pool.page_nbytes,
        "leaves": [{"shape": list(shape), "dtype": dtype}
                   for shape, dtype in pool.page_spec()],
    }


def geometry_mismatch(mine: dict, theirs: dict) -> str | None:
    """Attribution message when two geometry blocks cannot exchange pages
    bit-exactly (None = compatible).  Schema version is checked FIRST: a
    newer peer's geometry encoding may not even be comparable."""
    if theirs.get("wire_schema") != mine.get("wire_schema"):
        return (f"wire schema mismatch: peer speaks "
                f"{theirs.get('wire_schema')!r}, this pool speaks "
                f"{mine.get('wire_schema')!r} — upgrade the older tier")
    for field in ("page_tokens", "leaves"):
        if theirs.get(field) != mine.get(field):
            return (f"page geometry mismatch on {field!r}: peer has "
                    f"{theirs.get(field)!r}, this pool has "
                    f"{mine.get(field)!r} — prefill and decode tiers "
                    "must serve the same model/kv_dtype/page_tokens")
    return None


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a geometry dtype string (``KVPool.page_spec``
    names: ``bfloat16``, ``int8``, ``float32`` ...)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise WireError(f"page geometry names an unknown dtype {name!r}")
    return dt


def leaf_nbytes(geometry: dict) -> list[int]:
    """Per-PAGE byte size of each leaf, in leaf order — the payload
    partitioning both sides derive from the handshake geometry alone
    (nothing about sizes ever rides a PAGE frame's header)."""
    out = []
    for leaf in geometry["leaves"]:
        size = _torch_dtype(leaf["dtype"]).itemsize
        for d in leaf["shape"]:
            size *= int(d)
        out.append(size)
    return out


# ---------------------------------------------------------------------------
# page payload codec (leaf-generic, raw bytes — bitwise round trip)
# ---------------------------------------------------------------------------

def encode_pages(leaves: list) -> bytes:
    """PAGE payload for one group: every leaf's page stack (a host tensor,
    leading axis = page), concatenated raw in leaf order, C order.  The
    bytes are viewed, never converted: bit-exact by construction."""
    return b"".join(leaf.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                    for leaf in leaves)


def decode_pages(payload, n_pages: int, geometry: dict) -> list:
    """Rebuild one PAGE group's leaf stacks (host tensors over the payload's
    memory) from the raw payload.  The expected length is fully determined
    by (n_pages, geometry); any mismatch is a :class:`WireError` (a
    truncated or padded payload must never be reshaped into
    plausible-looking KV)."""
    sizes = leaf_nbytes(geometry)
    want = n_pages * sum(sizes)
    if len(payload) != want:
        raise WireError(
            f"page payload is {len(payload)} bytes, geometry demands "
            f"{want} for {n_pages} page(s) — truncated or corrupt frame")
    if want == 0:
        return [torch.empty((0,) + tuple(leaf["shape"]), dtype=_torch_dtype(leaf["dtype"]))
                for leaf in geometry["leaves"]]
    buf = payload
    if isinstance(buf, memoryview) and buf.readonly or isinstance(buf, bytes):
        buf = bytearray(buf)     # torch.frombuffer takes a writable buffer
    raw = torch.frombuffer(buf, dtype=torch.uint8)
    out = []
    off = 0
    for leaf, size in zip(geometry["leaves"], sizes):
        n = n_pages * size
        arr = raw[off:off + n].view(_torch_dtype(leaf["dtype"]))
        out.append(arr.reshape((n_pages,) + tuple(leaf["shape"])))
        off += n
    return out


# ---------------------------------------------------------------------------
# pinned schema descriptor (docs/disagg_wire_schema.json)
# ---------------------------------------------------------------------------

def schema_descriptor() -> dict:
    """The machine-readable wire contract — compared byte-for-byte (as
    canonical JSON) against docs/disagg_wire_schema.json, so a change to
    the format fails until the schema version is bumped and the golden
    regenerated."""
    return {
        "wire_schema": WIRE_SCHEMA,
        "framing": "u32 len | u8 type | u32 hlen | json header | payload",
        "max_frame_bytes": MAX_FRAME,
        "page_group": PAGE_GROUP,
        "frame_types": {name: code for code, name in FRAME_NAMES.items()},
        "headers": {
            "HELLO": ["wire_schema", "page_tokens", "page_bytes", "leaves"],
            "HELLO_OK": ["wire_schema"],
            "REQ": ["rid", "namespace", "ids", "deadline", "trace"],
            "PAGE": ["rid", "seq", "n_pages"],
            "DONE": ["rid", "tokens", "n_pages", "first_token"],
            "ERR": ["rid", "error", "code"],
        },
        "page_payload": "leaf page stacks concatenated in tree-leaf order, "
                        "raw bytes; per-leaf sizes derived from the HELLO "
                        "geometry",
    }


def canonical_schema_json() -> str:
    return json.dumps(schema_descriptor(), indent=1, sort_keys=True) + "\n"


def main(argv=None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(prog="disagg.wire")
    ap.add_argument("--schema", action="store_true",
                    help="print the canonical wire schema descriptor")
    ap.add_argument("--check-golden", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="compare the descriptor against the committed "
                         "golden header (default docs/disagg_wire_schema"
                         ".json); exit 1 on drift")
    args = ap.parse_args(argv)
    if args.check_golden is not None:
        path = args.check_golden
        if not path:
            repo = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
            path = os.path.join(repo, "docs", "disagg_wire_schema.json")
        try:
            with open(path, encoding="utf-8") as f:
                golden = f.read()
        except OSError as e:
            print(f"disagg-wire-schema: golden header unreadable: {e}")
            return 1
        if golden != canonical_schema_json():
            print("disagg-wire-schema: DRIFT — serving/disagg/wire.py no "
                  f"longer matches {path}.\nIf the change is deliberate, "
                  "bump WIRE_SCHEMA and regenerate the golden with:\n  "
                  "python -m llama_fastapi_k8s_gpu_tpu_torch.serving.disagg.wire "
                  f"--schema > {path}")
            return 1
        print(f"disagg-wire-schema: OK (schema {WIRE_SCHEMA})")
        return 0
    print(canonical_schema_json(), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
