"""PyTorch/CUDA port of ``llama_fastapi_k8s_gpu_tpu`` for one NVIDIA H100.

The layout mirrors the JAX package: ``gguf/``, ``tokenizer/``, ``models/``,
``ops/`` (hand-written CUDA kernels under ``csrc/``), ``sampling/``,
``engine/``, ``server/``, ``utils/``.  It imports ``torch`` and nothing of
JAX or of the JAX package.  Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""
