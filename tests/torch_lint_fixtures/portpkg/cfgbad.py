import os

from .utils.config import knob


def raw_read():
    return os.environ.get("LFKT_PORT")       # CFG001: raw env read


def phantom():
    return knob("LFKT_NOT_REGISTERED")       # CFG005: unregistered name


def registered():
    return knob("LFKT_CACHE_DIR")            # fine


def suppressed_read():
    return os.getenv("LFKT_MODEL_DIR")  # lfkt: noqa[CFG001] -- fixture: an audited raw read
