"""The fixture's knob registry in the port's form: Settings fields and the
KNOBS table."""

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Settings:
    model_dir: str = "models"
    port: int = 8000
    undocumented_field: int = 0              # CFG002: nowhere in README/docs


def _env(name, default, cast):
    raw = os.environ.get(name)
    return default if raw is None else cast(raw)


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    cast: type
    default: object
    help: str = ""
    serving: bool = False


KNOBS = {k.name: k for k in (
    Knob("LFKT_CACHE_DIR", str, "", "where kernels are cached", serving=True),
    Knob("LFKT_UNPLUMBED", str, "", "a serving knob helm-gpu never sets",
         serving=True),                      # CFG002 + CFG003
)}


def knob(name):
    k = KNOBS[name]
    return _env(name, k.default, k.cast)
