import ctypes
import threading

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "lfkt_good": [_P, _P, _I, _P],
    "lfkt_fallback": [_P, _P, _I, _P],
    "lfkt_unchecked": [_P, _P, _I, _P],
    "lfkt_guessing": [_P, _P, _I, _P],
    "lfkt_unlisted": [_P, _P, _I, _P],
    "lfkt_shared": [_P, _P, _I, _P],
    "lfkt_query": [_I],
    "lfkt_ghost": [_P],                     # KER001: no csrc definition
}

_lock = threading.Lock()
_lib = None


def library():
    lib = ctypes.CDLL("fixture.so")
    lib.lfkt_error_string.argtypes = [_I]
    return lib


def check(status, name):
    if status != 0:
        raise RuntimeError(name)


def stream_ptr(t):
    return 0
