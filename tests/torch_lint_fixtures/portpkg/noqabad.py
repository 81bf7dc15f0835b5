import os


def no_reason():
    return os.getenv("LFKT_PORT")  # lfkt: noqa[CFG001]


def unknown_rule():
    return 1  # lfkt: noqa[JIT001] -- the port has no JIT family
