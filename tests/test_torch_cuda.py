"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (the CPU hosts have
no card and no ``nvcc``).  On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the GPU image does
not carry; this file imports only the port.)  The first test builds the
kernels from ``csrc/``.  Tolerances: the Q4_K / Q5_K / Q8_0 dequants are
bit-exact; the fused matmuls agree with the plain f32 product to one bf16
step of the output's scale; flash attention to 2·10⁻² max-abs (``__expf``
and another summation order than the plain softmax).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: bytes per block of each format
SIZES = {"q4k": 144, "q5k": 176, "q6k": 210, "q8": 34}


def _blocks(rng, n_out, k_in, size):
    """Random block bytes with finite f16 scale fields."""
    elems = 32 if size == 34 else 256
    blk = rng.integers(0, 256, (n_out * k_in // elems, size), dtype=np.uint8)
    d = rng.uniform(1e-4, 1e-3, (blk.shape[0], 2)).astype(np.float16).view(np.uint8)
    if size in (144, 176):
        blk[:, 0:4] = d.reshape(-1, 4)
    elif size == 34:
        blk[:, 0:2] = d[:, :2]
    else:
        blk[:, 192:208] = rng.integers(1, 32, (blk.shape[0], 16), dtype=np.uint8)
        blk[:, 208:210] = d[:, :2]
    return torch.from_numpy(blk.reshape(n_out, -1))


def _kernel(fmt):
    """(wrapper, plain version) of a fused format."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import q4k, q5k, q6k, q8

    mod = {"q4k": q4k, "q5k": q5k, "q6k": q6k, "q8": q8}[fmt]
    return getattr(mod, f"{fmt}_matmul"), getattr(mod, f"{fmt}_matmul_plain")


def test_dequant_q4_k_bit_exact(cuda):
    from llama_fastapi_k8s_gpu_tpu_torch.ops import dequant

    raw = _blocks(np.random.default_rng(0), 512, 1024, 144).to(cuda)
    before = dequant.dequant_q4_k.launches
    got = dequant.dequant_q4_k(raw)
    want = dequant.dequant_q4_k_plain(raw)
    torch.cuda.synchronize()
    assert dequant.dequant_q4_k.launches == before + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("fmt,n_out,k_in", [("q5k", 512, 1024), ("q5k", 37, 4352),
                                            ("q8", 512, 1024), ("q8", 37, 4128)])
def test_dequant_q5_k_and_q8_0_bit_exact(cuda, fmt, n_out, k_in):
    """Bit for bit the plain version (the codec cast to bf16), at an odd
    number of rows and, for Q8_0, rows of 129 blocks."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import dequant

    kern, plain = ((dequant.dequant_q5_k, dequant.dequant_q5_k_plain) if fmt == "q5k"
                   else (dequant.dequant_q8_0, dequant.dequant_q8_0_plain))
    raw = _blocks(np.random.default_rng(n_out), n_out, k_in, SIZES[fmt]).to(cuda)
    before = kern.launches
    got, want = kern(raw), plain(raw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.shape == (n_out * k_in,)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("fmt", ["q4k", "q6k", "q5k", "q8"])
@pytest.mark.parametrize("n,k", [(256, 2048), (40, 4352)])
@pytest.mark.parametrize("B", [1, 7, 256])
def test_fused_matmul_matches_plain(cuda, fmt, n, k, B):
    kern, plain = _kernel(fmt)
    rng = np.random.default_rng(n + B)
    w = _blocks(rng, n, k, SIZES[fmt]).to(cuda)
    x = torch.from_numpy(rng.standard_normal((B, k), np.float32)).to(cuda, torch.bfloat16)
    before = kern.launches
    got, want = kern(x, w, n, k), plain(x, w, n, k)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max() <= 8e-3 * want.float().abs().max()


@pytest.mark.parametrize("B", [1, 7, 256])
def test_q8_matmul_unaligned_row_stride(cuda, B):
    """K = 4128: a row of 129 Q8_0 blocks is 4386 bytes, so rows start at
    2-byte-aligned addresses only, and the last 256-element chunk holds one
    block."""
    kern, plain = _kernel("q8")
    rng = np.random.default_rng(B)
    w = _blocks(rng, 72, 4128, 34).to(cuda)
    x = torch.from_numpy(rng.standard_normal((B, 4128), np.float32)).to(cuda, torch.bfloat16)
    got, want = kern(x, w, 72, 4128), plain(x, w, 72, 4128)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max() <= 8e-3 * want.float().abs().max()


@pytest.mark.parametrize("S,n_ctx,offsets", [(1, 512, (0, 300, 511)),
                                             (256, 1024, (0, 256, 768)),
                                             (37, 256, (0, 100, 219))])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("H,n_kv,hd", [(32, 8, 128), (8, 8, 64)])
def test_flash_attention_matches_plain(cuda, S, n_ctx, offsets, window, H, n_kv, hd):
    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention

    g = torch.Generator(device=cuda).manual_seed(S + window)
    q = torch.randn(S, H, hd, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(n_kv, n_ctx, hd, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(n_kv, n_ctx, hd, generator=g, device=cuda).to(torch.bfloat16)
    for off in offsets:
        got = attention.flash_attention(q, k, v, off, hd ** -0.5, window)
        want = attention.flash_attention_plain(q, k, v, off, hd ** -0.5, window)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max() <= 2e-2, off


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention, q4k

    q = torch.zeros(4, 6, 96, dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(2, 16, 96, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        attention.flash_attention(q, kv, kv, 0, 0.1)            # head_dim 96
    w = torch.zeros(8, 144, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        q4k.q4k_matmul(torch.zeros(1, 256, device=cuda), w, 8, 256)   # f32 x
