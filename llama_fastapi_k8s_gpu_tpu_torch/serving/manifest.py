"""The ``LFKT_MODELS`` manifest grammar — N models per serving process.

The port's copy of the JAX package's manifest
(llama_fastapi_k8s_gpu_tpu/serving/manifest.py): the same grammar, the
same override whitelist and the same rejects, word for word.  One GGUF per
process is named by ``LFKT_MODEL_DIR``/``LFKT_MODEL_NAME``; the
multi-model registry (serving/registry.py) loads several from one env
string:

    LFKT_MODELS=name=path[:knob=value[;knob=value...]][,name=path...]

- ``name``  — the serving alias requests route on (``model=`` in
  ``/response`` and ``/v1/chat/completions``; the ``id`` rows of
  ``GET /v1/models``).  ``[A-Za-z0-9._-]+``, unique across the manifest.
- ``path``  — the GGUF file.  Relative paths resolve against
  ``LFKT_MODEL_DIR``.
- overrides — per-model engine knobs after a ``:``, ``;``-separated
  ``knob=value`` pairs drawn from :data:`OVERRIDE_KEYS` (scheduler-level
  knobs like ``LFKT_BATCH_SIZE`` stay process-wide, so every model gets
  the same serving shape).

Example::

    LFKT_MODELS=llama8b=Llama-3-8B.Q4_K_M.gguf:n_ctx=2048;kv_dtype=int8,mistral7b=/models/mistral.gguf

``LFKT_DEFAULT_MODEL`` names the alias served when a request carries no
``model=``; it defaults to the manifest's first entry.
"""

from __future__ import annotations

import dataclasses
import os
import re

#: per-model engine-constructor overrides the manifest may set.  Keys are
#: the Engine kwarg names; values cast the override string.
OVERRIDE_KEYS: dict[str, type] = {
    "n_ctx": int,
    "weight_format": str,
    "kv_dtype": str,
    "attn_impl": str,
    # per-model layer-looping: co-resident models differ in depth and ring
    # geometry, so one may loop while another serves per-layer
    "decode_layer_unroll": int,
    "decode_chunk": int,
    "max_gen_tokens": int,
    "spec_decode": str,
    "spec_draft": int,
}

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One manifest entry: serving alias, GGUF path, engine overrides."""

    name: str
    path: str
    overrides: dict = dataclasses.field(default_factory=dict)

    def resolved_path(self, model_dir: str) -> str:
        """Absolute-or-relative resolution against the model dir (the
        single-model ``LFKT_MODEL_DIR``/``LFKT_MODEL_NAME`` convention).

        Relative paths must stay UNDER the model dir after symlink/..
        resolution: manifests arrive over the network via ``POST
        /admin/models/reload``, so an unconstrained join would let a
        ``../../`` entry read any file the pod can.  Absolute paths remain the
        explicit operator escape hatch — they name the file outright
        rather than smuggling a traversal through the join."""
        if os.path.isabs(self.path):
            return self.path
        joined = os.path.join(model_dir, self.path)
        base = os.path.realpath(model_dir)
        real = os.path.realpath(joined)
        if real != base and not real.startswith(base + os.sep):
            raise ValueError(
                f"model {self.name!r}: path {self.path!r} escapes the "
                f"model dir {model_dir!r} after resolution — relative "
                "manifest paths must stay under LFKT_MODEL_DIR "
                "(docs/MULTIMODEL.md)")
        return joined


def parse_manifest(spec: str) -> list[ModelSpec]:
    """Parse ``LFKT_MODELS`` into validated :class:`ModelSpec` rows.

    Raises ``ValueError`` with attribution (the offending entry, the
    offending key) on every grammar violation — a typo'd manifest must
    fail the pod at startup, not serve a half-fleet silently."""
    out: list[ModelSpec] = []
    seen: set[str] = set()
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        head, sep, tail = entry.partition("=")
        name = head.strip()
        if not sep or not tail:
            raise ValueError(
                f"LFKT_MODELS entry {entry!r}: expected name=path"
                "[:knob=value;...] (docs/MULTIMODEL.md)")
        if not _NAME_RE.match(name):
            raise ValueError(
                f"LFKT_MODELS entry {entry!r}: model name {name!r} must "
                "match [A-Za-z0-9._-]+")
        if name in seen:
            raise ValueError(
                f"LFKT_MODELS entry {entry!r}: duplicate model name "
                f"{name!r}")
        path, osep, otail = tail.partition(":")
        path = path.strip()
        if not path:
            raise ValueError(
                f"LFKT_MODELS entry {entry!r}: empty model path")
        overrides: dict = {}
        if osep:
            for pair in otail.split(";"):
                pair = pair.strip()
                if not pair:
                    continue
                k, psep, v = pair.partition("=")
                k = k.strip()
                if not psep or not v.strip():
                    raise ValueError(
                        f"LFKT_MODELS entry {entry!r}: override {pair!r} "
                        "must be knob=value")
                cast = OVERRIDE_KEYS.get(k)
                if cast is None:
                    raise ValueError(
                        f"LFKT_MODELS entry {entry!r}: unknown override "
                        f"{k!r} (allowed: {', '.join(sorted(OVERRIDE_KEYS))})")
                try:
                    overrides[k] = cast(v.strip())
                except ValueError as e:
                    raise ValueError(
                        f"LFKT_MODELS entry {entry!r}: override {k}={v!r} "
                        f"does not cast to {cast.__name__}") from e
        seen.add(name)
        out.append(ModelSpec(name=name, path=path, overrides=overrides))
    if not out:
        raise ValueError("LFKT_MODELS is set but names no models")
    return out


def pick_default(specs: list[ModelSpec], requested: str = "") -> str:
    """Resolve ``LFKT_DEFAULT_MODEL``: the requested alias (validated
    against the manifest) or the first entry."""
    if requested:
        if not any(s.name == requested for s in specs):
            raise ValueError(
                f"LFKT_DEFAULT_MODEL={requested!r} is not in the "
                f"LFKT_MODELS manifest ({', '.join(s.name for s in specs)})")
        return requested
    return specs[0].name
