"""Fixture chip script: names the kernels it holds against their plain
versions (KER003 reads its string literals)."""

HELD = ("good_kernel", "fallback_kernel", "unchecked_kernel", "guessing_kernel",
        "twin_a")
