"""Planted kernel-contract violations, one wrapper each."""

from ._kernels import check, library, stream_ptr


def fallback_kernel_plain(x):
    return x


def fallback_kernel(x):
    if x.device.type == "cpu":
        return fallback_kernel_plain(x)
    try:
        check(library().lfkt_fallback(x.data_ptr(), 0, 1, stream_ptr(x)), "fallback")
    except RuntimeError:                    # KER002: swallows the failure
        return fallback_kernel_plain(x)     # KER002: plain as a fallback
    fallback_kernel.launches += 1
    return x


def unchecked_kernel_plain(x):
    return x


def unchecked_kernel(x):
    if x.device.type == "cpu":
        return unchecked_kernel_plain(x)
    library().lfkt_unchecked(x.data_ptr(), 0, 1, stream_ptr(x))   # KER001: status dropped, uncounted
    return x


def guessing_kernel_plain(x):
    return x


def guessing_kernel(x, fast=True):
    if x.device.type == "cpu" or not fast:  # KER002: more than the device type
        return guessing_kernel_plain(x)
    check(library().lfkt_guessing(x.data_ptr(), 0, 1, stream_ptr(x)), "guessing")
    guessing_kernel.launches += 1
    return x


def unlisted_kernel(x):                     # KER002: no plain version
    check(library().lfkt_unlisted(x.data_ptr(), 0, 1, stream_ptr(x)), "unlisted")
    unlisted_kernel.launches += 1           # KER003: not in KERNELS
    return x


def twin_a_plain(x):
    return x


def twin_a(x):
    if x.device.type == "cpu":
        return twin_a_plain(x)
    check(library().lfkt_shared(x.data_ptr(), 0, 1, stream_ptr(x)), "twin_a")
    twin_a.launches += 1
    return x


def twin_b_plain(x):
    return x


def twin_b(x):                               # KER001: second wrapper of lfkt_shared
    if x.device.type == "cpu":               # KER003: not named by chip_smoke.py
        return twin_b_plain(x)
    check(library().lfkt_shared(x.data_ptr(), 0, 1, stream_ptr(x)), "twin_b")
    twin_b.launches += 1
    return x


def stray(x):
    return library().lfkt_stray(x)           # KER001: unbound symbol


fallback_kernel.launches = 0
guessing_kernel.launches = 0
unchecked_kernel.launches = 0
unlisted_kernel.launches = 0
twin_a.launches = 0
twin_b.launches = 0
