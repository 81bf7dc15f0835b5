"""THE wire-surface registry — every trust boundary the fleet exposes,
declared once.

Same single-source-of-truth pattern as the metric catalog
(obs/catalog.py) and the ``LFKT_*`` knob registry (utils/config.py): any
``x-lfkt-*`` HTTP header and any page-wire / migration frame-header
field the package puts on (or reads off) a socket must be declared here
with its direction and **trust class**.  A hole where inbound copies of
the router's internal stamps could command a replica to pull KV pages
from an attacker-chosen address was once fixed by hand — this module
turns that one-off fix into a statically enforced invariant (lfkt-lint
WIRE001-003, lint/wire.py):

- **WIRE001** — an ``x-lfkt-*`` header literal or frame-header field
  used anywhere in the package but not declared here;
- **WIRE002** — a declared ingress point with a CFG path that forwards
  bytes upstream without first stripping every ``internal-stamped``
  header (deleting the router's strip loop fires this);
- **WIRE003** — drift between these declarations and the generated
  docs/WIRESURFACE.md table (pinned byte-for-byte, the OBS002 idiom).
  The port's page wire and fleet headers are the JAX package's, byte for
  byte, so this table equals that package's and the one docs table
  documents both.

Trust classes:

- ``client-settable`` — clients may send it; every consumer must treat
  the value as attacker-controlled (taint source for lint/taint.py);
- ``internal-stamped-must-strip`` — stamped by our own tier on egress;
  inbound copies MUST be stripped at every declared ingress so a client
  can never impersonate the stamp;
- ``peer-only`` — rides the mTLS'd/NetworkPolicy'd intra-fleet wire,
  never a client connection; still parsed defensively (a compromised
  peer is in scope for taint analysis), but no ingress strip applies.

The declarations below are pure literals on purpose: lint/wire.py parses
this file with ``ast`` (never imports it), the same static-read contract
as the metric catalog and the env-knob registry.
"""

from __future__ import annotations

import dataclasses

CLIENT_SETTABLE = "client-settable"
INTERNAL_STAMPED = "internal-stamped-must-strip"
PEER_ONLY = "peer-only"

#: every legal trust class, render order for the docs table
TRUST_CLASSES = (CLIENT_SETTABLE, INTERNAL_STAMPED, PEER_ONLY)


@dataclasses.dataclass(frozen=True)
class WireHeader:
    """One declared ``x-lfkt-*`` HTTP header.  ``direction`` says who
    emits it (``inbound`` = clients, ``internal`` = our own tiers)."""

    name: str
    direction: str
    trust: str
    summary: str


@dataclasses.dataclass(frozen=True)
class WireField:
    """One declared page-wire / migration frame-header field.  ``frames``
    names the frame types that carry it (the wire.py schema descriptor
    is the framing-level source of truth; this row carries the trust
    annotation the schema descriptor lacks)."""

    name: str
    frames: str
    trust: str
    summary: str


@dataclasses.dataclass(frozen=True)
class WireIngress:
    """One declared ingress point: a function that accepts client bytes
    and forwards them upstream.  ``function`` is ``module:qualname``
    inside the package; ``forward`` is the dotted call tail that puts
    bytes on the upstream socket.  lint/wire.py proves (CFG
    must-analysis) that every path from entry to a ``forward`` call
    strips every ``internal-stamped`` header first."""

    function: str
    forward: str
    summary: str


HEADERS: tuple[WireHeader, ...] = (
    WireHeader("x-lfkt-affinity", "inbound", "client-settable",
               "explicit client-side affinity pin (a conversation id); "
               "folded into the rendezvous key, sanitized before it "
               "reaches any log or forwarded header"),
    WireHeader("x-lfkt-affinity-key", "internal", "internal-stamped-must-strip",
               "router -> replica: the computed affinity key, recorded "
               "for graceful drain; inbound copies are stripped so a "
               "client cannot forge drain-manifest rows"),
    WireHeader("x-lfkt-prior-owner", "internal", "internal-stamped-must-strip",
               "router -> replica: the peer whose radix tree likely "
               "holds this conversation's KV pages (pull-on-remap); "
               "inbound copies are stripped so a client cannot command "
               "a KV pull from an arbitrary address"),
)


FIELDS: tuple[WireField, ...] = (
    WireField("rid", "REQ|PAGE|DONE|ERR", "peer-only",
              "per-connection request id correlating frames"),
    WireField("namespace", "REQ", "peer-only",
              "radix namespace (model name) the pages belong to"),
    WireField("ids", "REQ", "peer-only",
              "token ids of the prefix whose pages are requested"),
    WireField("deadline", "REQ", "peer-only",
              "absolute wall deadline; both sides abandon the transfer "
              "past it"),
    WireField("trace", "REQ", "peer-only",
              "W3C traceparent of the originating request (None when "
              "sampled out); the serving side opens a span tree linked "
              "to the same request id — never trusted for anything but "
              "trace correlation"),
    WireField("seq", "PAGE", "peer-only",
              "page-group sequence number within one transfer"),
    WireField("n_pages", "PAGE|DONE", "peer-only",
              "page count in this group / whole transfer"),
    WireField("tokens", "DONE", "peer-only",
              "token count covered by the transferred pages "
              "(cross-checked against n_pages * page_tokens)"),
    WireField("first_token", "DONE", "peer-only",
              "first sampled token from the remote prefill (None on "
              "migration pulls)"),
    WireField("code", "ERR", "peer-only",
              "machine-readable refusal reason (geometry | schema | "
              "deadline | request | export | prefill | protocol)"),
    WireField("error", "ERR", "peer-only",
              "human-readable refusal detail; sanitized before logging "
              "(a peer-supplied string is a log-injection vector)"),
    WireField("wire_schema", "HELLO|HELLO_OK", "peer-only",
              "wire schema version; mismatch refuses the handshake"),
    WireField("page_tokens", "HELLO", "peer-only",
              "tokens per KV page (geometry compatibility check)"),
    WireField("page_bytes", "HELLO", "peer-only",
              "payload bytes per page (geometry compatibility check)"),
    WireField("leaves", "HELLO", "peer-only",
              "per-leaf page shape/dtype list (geometry compatibility "
              "check)"),
    WireField("shape", "HELLO", "peer-only",
              "one leaf's per-page array shape (inside leaves[])"),
    WireField("dtype", "HELLO", "peer-only",
              "one leaf's dtype string (inside leaves[])"),
)


INGRESSES: tuple[WireIngress, ...] = (
    WireIngress("serving.fleet.router:FleetRouter._route",
                "_proxy_attempt",
                "the fleet router's client-facing routing path: raw "
                "request bytes in, proxied verbatim to a replica after "
                "the internal-stamp strip"),
)


def internal_stamped_headers() -> tuple[str, ...]:
    """The header names every declared ingress must strip."""
    return tuple(h.name for h in HEADERS if h.trust == INTERNAL_STAMPED)


def markdown_table() -> str:
    """The docs/WIRESURFACE.md tables — generated, never hand edited
    (lfkt-lint WIRE003 + a tier-1 test pin the docs block to this
    output byte-for-byte)."""
    rows = ["### HTTP headers", "",
            "| header | direction | trust | summary |",
            "|---|---|---|---|"]
    for h in HEADERS:
        rows.append(f"| `{h.name}` | {h.direction} | {h.trust} | "
                    f"{h.summary} |")
    rows += ["", "### Frame-header fields", "",
             "| field | frames | trust | summary |",
             "|---|---|---|---|"]
    for f in FIELDS:
        rows.append(f"| `{f.name}` | {f.frames} | {f.trust} | "
                    f"{f.summary} |")
    rows += ["", "### Ingress points", "",
             "| function | forwards via | summary |",
             "|---|---|---|"]
    for i in INGRESSES:
        rows.append(f"| `{i.function}` | `{i.forward}` | {i.summary} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(markdown_table())
