"""The conforming wrapper: plain version in-module, device-type choice,
status checked, launch counted, listed in KERNELS and chip_smoke.py."""

from ._kernels import check, library, stream_ptr


def good_kernel_plain(x):
    return x


def good_kernel(x):
    if x.device.type == "cpu":
        return good_kernel_plain(x)
    y = x.clone()
    check(library().lfkt_good(x.data_ptr(), y.data_ptr(), x.numel(), stream_ptr(x)),
          "good_kernel")
    good_kernel.launches += 1
    return y


def query(n):
    # a query, not a launcher (no stream): no wrapper and no status needed
    return library().lfkt_query(n)


good_kernel.launches = 0
