from ..obs.devtime import register_program
from .good import good_kernel
from .kerbad import fallback_kernel, guessing_kernel, twin_a, twin_b, unchecked_kernel

KERNELS = {
    "good_kernel": good_kernel,
    "fallback_kernel": fallback_kernel,
    "unchecked_kernel": unchecked_kernel,
    "guessing_kernel": guessing_kernel,
    "twin_a": twin_a,
    "twin_b": twin_b,
}

for _name, _fn in KERNELS.items():
    register_program(_name, launches=lambda fn=_fn: fn.launches)
