"""The port's hand-written Hopper kernels and the linear dispatch.

:mod:`.linear` dispatches a layer's matmul onto them by weight format.
Each kernel module pairs a wrapper that launches the CUDA kernel (for CUDA
tensors) with its plain PyTorch version (for CPU tensors) and counts its
launches in ``<wrapper>.launches``:

- :mod:`.dequant` — load-time Q4_K / Q5_K / Q6_K / Q8_0 → bf16
  (``token_embd``);
- :mod:`.q4k` / :mod:`.q5k` / :mod:`.q6k` / :mod:`.q8` — fused Q4_K /
  Q5_K / Q6_K / Q8_0 dequant-matmuls;
- :mod:`.attention` — causal GQA flash attention for prompt passes, over
  the bf16 or the int8 KV ring;
- :mod:`.kvquant` — the int8 KV cache's write-quantize;
- :mod:`.decode_loop` — the layer-looped decode step (K whole layers of a
  decode token per launch, over bf16 or int8 linears).

``torch._int_mm``, which the int8 linear calls on the card (:mod:`.linear`),
is a library call, not a kernel of the port.

The kernels' library is loaded at first use (:mod:`._kernels`): found under
``LFKT_COMPILE_CACHE_DIR`` or the package's ``_build/``, else built from
``csrc/`` (``utils/kernelcache.py``).
"""

from ..obs.devtime import INNER, register_program
from .attention import flash_attention, flash_attention_int8
from .decode_loop import decode_loop_step
from .dequant import dequant_q4_k, dequant_q5_k, dequant_q6_k, dequant_q8_0
from .kvquant import kv_quantize
from .q4k import q4k_matmul
from .q5k import q5k_matmul
from .q6k import q6k_matmul
from .q8 import q8_matmul

#: every kernel wrapper of the serving paths, by the name chip runs report
KERNELS = {
    "dequant_q4_k": dequant_q4_k,
    "q4k_matmul": q4k_matmul,
    "q6k_matmul": q6k_matmul,
    "flash_attention": flash_attention,
    "dequant_q5_k": dequant_q5_k,
    "q5k_matmul": q5k_matmul,
    "dequant_q8_0": dequant_q8_0,
    "q8_matmul": q8_matmul,
    "kv_quantize": kv_quantize,
    "flash_attention_int8": flash_attention_int8,
    "dequant_q6_k": dequant_q6_k,
    "decode_loop": decode_loop_step,
}

# each kernel is an inner program of the compile registry, its launch
# counter its dispatches
for _name, _fn in KERNELS.items():
    register_program(_name, INNER, site=_fn.__module__.split(".", 1)[1],
                     launches=lambda fn=_fn: fn.launches)
del _name, _fn

__all__ = ["KERNELS", "decode_loop_step", "dequant_q4_k", "dequant_q5_k", "dequant_q6_k",
           "dequant_q8_0", "flash_attention", "flash_attention_int8",
           "kv_quantize", "q4k_matmul", "q5k_matmul", "q6k_matmul", "q8_matmul"]
