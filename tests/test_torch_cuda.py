"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (the CPU hosts have
no card and no ``nvcc``).  On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the GPU image does
not carry; this file imports only the port.)  The first test builds the
kernels from ``csrc/``.  Tolerances: the Q4_K / Q5_K / Q6_K / Q8_0
dequants and the int8 KV write-quantize are bit-exact; the fused matmuls
agree with the plain f32 product to one bf16 step of the output's scale;
flash attention, over the bf16 and the int8 ring, to 2·10⁻² max-abs
(``__expf`` and another summation order than the plain softmax).
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


@pytest.mark.parametrize("n_out,k_in", [(512, 1024), (37, 4352)])
def test_dequant_q6_k_bit_exact(cuda, n_out, k_in):
    """Odd row counts: the kernel's last block of 8 super-blocks is partial."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import dequant

    raw = _blocks(np.random.default_rng(n_out), n_out, k_in, 210).to(cuda)
    before = dequant.dequant_q6_k.launches
    got, want = dequant.dequant_q6_k(raw), dequant.dequant_q6_k_plain(raw)
    torch.cuda.synchronize()
    assert dequant.dequant_q6_k.launches == before + 1
    assert got.shape == (n_out * k_in,)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("S,pos_offset", [(1, 0), (1, 700), (256, 0), (256, 768), (37, 11)])
@pytest.mark.parametrize("n_kv,hd", [(8, 128), (4, 64)])
def test_kv_quantize_bit_exact(cuda, S, pos_offset, n_kv, hd):
    """Written into a layer's ring in place, bit for bit the plain version's
    ring, with an all-zero row and a half-way row among the inputs and the
    other slots left alone."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import kvquant

    n_ctx = 1024
    g = torch.Generator(device=cuda).manual_seed(S + pos_offset + hd)
    k = (torch.randn(S, n_kv, hd, generator=g, device=cuda) * 4).to(torch.bfloat16)
    v = torch.randn(S, n_kv, hd, generator=g, device=cuda).to(torch.bfloat16)
    k[0, 0] = 0
    v[0, 0] = 0
    v[0, 0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])
    rings = [torch.full((n_kv, n_ctx, hd), 7, dtype=torch.int8, device=cuda) for _ in range(4)]
    scales = [torch.full((n_kv, n_ctx), 0.5, device=cuda) for _ in range(4)]
    before = kvquant.kv_quantize.launches
    kvquant.kv_quantize(k, v, rings[0], rings[1], scales[0], scales[1], pos_offset)
    kvquant.kv_quantize_plain(k, v, rings[2], rings[3], scales[2], scales[3], pos_offset)
    torch.cuda.synchronize()
    assert kvquant.kv_quantize.launches == before + 1
    assert torch.equal(rings[0], rings[2]) and torch.equal(rings[1], rings[3])
    assert torch.equal(scales[0].view(torch.int32), scales[2].view(torch.int32))
    assert torch.equal(scales[1].view(torch.int32), scales[3].view(torch.int32))
    assert rings[1][0, pos_offset, :4].tolist() == [127, 2, -4, 0]


@pytest.mark.parametrize("S,n_ctx,offsets", [(1, 512, (0, 300, 511)),
                                             (256, 1024, (0, 256, 768)),
                                             (37, 256, (0, 100, 219))])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("H,n_kv,hd", [(32, 8, 128), (8, 8, 64)])
def test_flash_attention_int8_matches_plain(cuda, S, n_ctx, offsets, window, H, n_kv, hd):
    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention, kvquant

    g = torch.Generator(device=cuda).manual_seed(S + window + 1)
    q = torch.randn(S, H, hd, generator=g, device=cuda).to(torch.bfloat16)
    kq, ks = kvquant.quantize_kv_plain(torch.randn(n_kv, n_ctx, hd, generator=g, device=cuda))
    vq, vs = kvquant.quantize_kv_plain(torch.randn(n_kv, n_ctx, hd, generator=g, device=cuda))
    for off in offsets:
        before = attention.flash_attention_int8.launches
        got = attention.flash_attention_int8(q, kq, vq, ks, vs, off, hd ** -0.5, window)
        want = attention.flash_attention_int8_plain(q, kq, vq, ks, vs, off, hd ** -0.5, window)
        torch.cuda.synchronize()
        assert attention.flash_attention_int8.launches == before + 1
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max() <= 2e-2, off


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention, q4k

    q = torch.zeros(4, 6, 96, dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(2, 16, 96, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        attention.flash_attention(q, kv, kv, 0, 0.1)            # head_dim 96
    q4 = torch.zeros(4, 4, 64, dtype=torch.bfloat16, device=cuda)
    kv8 = torch.zeros(2, 16, 64, dtype=torch.int8, device=cuda)
    s16 = torch.zeros(2, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                              # bf16 scales
        attention.flash_attention_int8(q4, kv8, kv8, s16, s16, 0, 0.1)
    w = torch.zeros(8, 144, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        q4k.q4k_matmul(torch.zeros(1, 256, device=cuda), w, 8, 256)   # f32 x
