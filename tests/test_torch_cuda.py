"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (the CPU hosts have
no card and no ``nvcc``).  On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the GPU image does
not carry; this file imports only the port.)  The first test builds the
kernels from ``csrc/``.  Tolerances: the Q4_K / Q5_K / Q6_K / Q8_0
dequants (bf16 and f32 outputs), the int8 KV write (RoPE on k, then the
quantize) and the int8 linear through ``torch._int_mm`` are bit-exact; the
fused matmuls agree
with the plain f32 product to one bf16 step of the output's scale; flash
attention, over the bf16 and the int8 ring, to 2·10⁻² max-abs (the kernel
rounds P to bf16 from its running row max, the plain version from the
global one; ``ex2.approx`` and another summation order); the layer-looped
decode kernel's output ``h`` to 2·10⁻² rel-dev from its plain version and
its ring slot to 2·10⁻² rel-dev in bf16, ±1 in int8 with scales within
2·10⁻² (dot products, the rms and the softmax sum in another order, and
an int8 activation code can move by one where its bf16 input moved a
step).  The tensor-core path of the four fused formats (B at or above the
launchers' threshold) agrees element by element with ``torch.matmul`` on
the bf16-dequantized plane — the same arithmetic, summed in another order
— to one bf16 step of each element plus 10⁻⁴ of the output's largest
magnitude.
"""

from __future__ import annotations

import dataclasses
import time

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
#: per format, the smallest B its launcher sends to the tensor cores
#: (csrc/qmma_route.cu; pinned by test_fused_route_by_batch)
TC_MIN_BATCH = {"q4k": 7, "q5k": 7, "q6k": 9, "q8": 9}


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


def _dequant(fmt):
    """(wrapper, plain version) of a format's load-time dequant."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import dequant

    name = {"q4k": "dequant_q4_k", "q5k": "dequant_q5_k", "q6k": "dequant_q6_k",
            "q8": "dequant_q8_0"}[fmt]
    return getattr(dequant, name), getattr(dequant, name + "_plain")


@pytest.mark.parametrize("fmt,n_out,k_in", [("q4k", 37, 4352), ("q5k", 512, 1024),
                                            ("q5k", 37, 4352), ("q8", 512, 1024),
                                            ("q8", 37, 4128)])
def test_dequant_q4_k_q5_k_and_q8_0_bit_exact(cuda, fmt, n_out, k_in):
    """Bit for bit the plain version (the codec cast to bf16), at an odd
    number of rows (629 Q4_K / Q5_K super-blocks: the last CUDA block is
    partial) and, for Q8_0, rows of 129 blocks."""
    kern, plain = _dequant(fmt)
    raw = _blocks(np.random.default_rng(n_out), n_out, k_in, SIZES[fmt]).to(cuda)
    before = kern.launches
    got, want = kern(raw), plain(raw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.shape == (n_out * k_in,)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("fmt", ["q4k", "q6k", "q5k", "q8"])
@pytest.mark.parametrize("n,k", [(256, 2048), (40, 4352)])
@pytest.mark.parametrize("B", sorted({1, 2, 3, 5, 7, 128, 200, 256, *TC_MIN_BATCH.values(),
                                     *(b - 1 for b in TC_MIN_BATCH.values())}))
def test_fused_matmul_matches_plain(cuda, fmt, n, k, B):
    """Every B on both sides of the tensor-core threshold, and the decode
    path's row templates (1, 2, 4 and 8 activation rows, 3 and 5 with rows
    masked); (40, 4352): N not a multiple of any tile, and Q6_K rows of 17
    blocks, 2-byte aligned only."""
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


def test_fused_route_by_batch(cuda):
    """The launchers' route: each fused format takes the tensor cores from
    its TC_MIN_BATCH rows on, except Q8_0 at a K that is not whole
    256-element groups, which keeps the CUDA-core kernel at every B; a
    threshold under one row is refused with an error."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    for fmt, tc_min in TC_MIN_BATCH.items():
        name = f"{fmt}_matmul"
        assert _fused.tc_min_batch(name) == tc_min
        assert _fused.route(name, 1, 4096) == _fused.route(name, tc_min - 1, 4096) == "cuda_core"
        assert _fused.route(name, tc_min, 4096) == _fused.route(name, 256, 4096) == "tc"
    assert _fused.route("q8_matmul", 256, 4128) == "cuda_core"
    with pytest.raises(RuntimeError):
        _fused.tc_config("q5k_matmul", 0)
    assert _fused.tc_min_batch("q5k_matmul") == TC_MIN_BATCH["q5k"]


@pytest.mark.parametrize("fmt", ["q5k", "q6k", "q4k", "q8"])
def test_fused_matmul_8b_shape(cuda, fmt):
    """ffn_gate/up of Llama-3-8B, 14336 x 4096, at a 256-token prompt slice."""
    kern, plain = _kernel(fmt)
    rng = np.random.default_rng(14336)
    w = _blocks(rng, 14336, 4096, SIZES[fmt]).to(cuda)
    x = torch.from_numpy(rng.standard_normal((256, 4096), np.float32)).to(cuda, torch.bfloat16)
    got, want = kern(x, w, 14336, 4096), plain(x, w, 14336, 4096)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max() <= 8e-3 * want.float().abs().max()


def _matches_bf16_plane(fmt, x, w, n, k) -> bool:
    """The kernel's result element by element against ``torch.matmul`` on
    the f32 codec's plane rounded to bf16: within one bf16 step of each
    element plus 10⁻⁴ of the largest."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import dequant

    deq = {"q4k": dequant.dequant_q4_k_f32, "q5k": dequant.dequant_q5_k_f32,
           "q6k": dequant.dequant_q6_k_f32, "q8": dequant.dequant_q8_0_f32}[fmt]
    kern, _ = _kernel(fmt)
    got = kern(x, w, n, k).float()
    want = torch.matmul(x, deq(w.reshape(-1)).reshape(n, k).to(torch.bfloat16).t()).float()
    torch.cuda.synchronize()
    step = torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
    return bool(((got - want).abs() <= step + 1e-4 * want.abs().max()).all())


@pytest.mark.parametrize("fmt", ["q5k", "q6k", "q4k", "q8"])
@pytest.mark.parametrize("n,k", [(256, 2048), (40, 4352), (1024, 4096)])
@pytest.mark.parametrize("B", ["threshold", 128, 256])
def test_tensor_core_path_matches_bf16_plane(cuda, fmt, n, k, B):
    """The tensor-core path is the library's arithmetic: each weight the
    f32 codec's value rounded to bf16 once, f32 sums, a bf16 result —
    against ``torch.matmul`` on that plane, element by element, from the
    format's threshold on."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    B = TC_MIN_BATCH[fmt] if B == "threshold" else B
    rng = np.random.default_rng(n * B)
    w = _blocks(rng, n, k, SIZES[fmt]).to(cuda)
    x = torch.from_numpy(rng.standard_normal((B, k), np.float32)).to(cuda, torch.bfloat16)
    assert _fused.route(f"{fmt}_matmul", B, k) == "tc"
    assert _matches_bf16_plane(fmt, x, w, n, k)


@pytest.mark.parametrize("fmt,offset", [("q4k", 8), ("q5k", 8), ("q6k", 2), ("q8", 2)])
@pytest.mark.parametrize("B", ["threshold", 256])
def test_tensor_core_path_weight_base_aligned_to_the_wrapper_minimum(cuda, fmt, offset, B):
    """A weight whose base is only as aligned as the wrapper demands (8
    bytes for Q4_K / Q5_K, 2 for Q6_K / Q8_0): the template copies its
    rows as 16-bit words, with the same result."""
    B = TC_MIN_BATCH[fmt] if B == "threshold" else B
    n, k = 72, 2048
    rng = np.random.default_rng(offset + B)
    w0 = _blocks(rng, n, k, SIZES[fmt]).to(cuda)
    buf = torch.zeros(w0.numel() + offset, dtype=torch.uint8, device=cuda)
    w = buf[offset:].view(n, -1)
    w.copy_(w0)
    assert w.data_ptr() % 16 == offset
    x = torch.from_numpy(rng.standard_normal((B, k), np.float32)).to(cuda, torch.bfloat16)
    assert _matches_bf16_plane(fmt, x, w, n, k)


#: the 8B shapes of the decode path (chip_smoke.py's MATMUL_SHAPES)
_QK = [(4096, 4096), (1024, 4096), (14336, 4096)]
_ALL = [*_QK, (4096, 14336), (128256, 4096)]
DECODE_SHAPES = {"q4k": _QK, "q5k": _QK, "q6k": _ALL, "q8": _ALL}


@pytest.mark.parametrize("fmt,n,k", [(fmt, n, k) for fmt, shapes in DECODE_SHAPES.items()
                                     for n, k in shapes])
def test_decode_path_8b_shapes(cuda, fmt, n, k):
    """A decode token (B=1) at every 8B shape of the four formats: the
    launches that split K over a block's warps (1024 and 4096 rows) and
    those that give each warp whole rows (14336 and 128256)."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    kern, plain = _kernel(fmt)
    rng = np.random.default_rng(n + k)
    w = _blocks(rng, n, k, SIZES[fmt]).to(cuda)
    x = torch.from_numpy(rng.standard_normal((1, k), np.float32)).to(cuda, torch.bfloat16)
    assert _fused.route(f"{fmt}_matmul", 1, k) == "cuda_core"
    got, want = kern(x, w, n, k), plain(x, w, n, k)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max() <= 8e-3 * want.float().abs().max()


@pytest.mark.parametrize("fmt,w_offset,x_offset", [
    ("q4k", 8, 0), ("q5k", 8, 0), ("q6k", 2, 0), ("q8", 2, 0),
    ("q4k", 0, 2), ("q5k", 0, 2), ("q6k", 0, 2), ("q8", 0, 2)])
@pytest.mark.parametrize("B", [1, "below"])
def test_decode_path_base_aligned_to_the_wrapper_minimum(cuda, fmt, w_offset, x_offset, B):
    """The decode path with a weight whose base is only as aligned as the
    wrapper demands (8 bytes for Q4_K / Q5_K, 2 for Q6_K / Q8_0), or with x
    2-byte aligned: the narrow loads, with the same result as the plain
    version, at one row and at the most rows the path takes ("below": one
    under the format's tensor-core threshold)."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    B = TC_MIN_BATCH[fmt] - 1 if B == "below" else B
    kern, plain = _kernel(fmt)
    n, k = 72, 2048
    rng = np.random.default_rng(w_offset + x_offset + B)
    w0 = _blocks(rng, n, k, SIZES[fmt]).to(cuda)
    buf = torch.zeros(w0.numel() + w_offset, dtype=torch.uint8, device=cuda)
    w = buf[w_offset:].view(n, -1)
    w.copy_(w0)
    x0 = torch.from_numpy(rng.standard_normal((B, k), np.float32)).to(cuda, torch.bfloat16)
    xbuf = torch.zeros(x0.numel() + x_offset // 2, dtype=torch.bfloat16, device=cuda)
    x = xbuf[x_offset // 2:].view(B, k)
    x.copy_(x0)
    assert (w.data_ptr() % 16, x.data_ptr() % 16) == (w_offset, x_offset)
    assert _fused.route(f"{fmt}_matmul", B, k) == "cuda_core"
    got, want = kern(x, w, n, k), plain(x, w, n, k)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max() <= 8e-3 * want.float().abs().max()


@pytest.mark.parametrize("fmt", ["q4k", "q5k", "q6k", "q8"])
@pytest.mark.parametrize("B", ["below", "threshold"])
def test_decode_path_agrees_with_tensor_core_path_at_the_threshold(cuda, fmt, B):
    """One B on each side of the format's threshold, at an 8B shape: the
    decode path and the tensor-core path (each forced in turn) on the same
    inputs agree within 8·10⁻³ of the output's largest magnitude."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    name, tc_min = f"{fmt}_matmul", TC_MIN_BATCH[fmt]
    B = tc_min - 1 if B == "below" else tc_min
    kern, _ = _kernel(fmt)
    n, k = 1024, 4096
    rng = np.random.default_rng(B)
    w = _blocks(rng, n, k, SIZES[fmt]).to(cuda)
    x = torch.from_numpy(rng.standard_normal((B, k), np.float32)).to(cuda, torch.bfloat16)
    got = {}
    try:
        for path, min_batch in (("cuda_core", 1 << 30), ("tc", 1)):
            _fused.tc_config(name, min_batch)
            assert _fused.route(name, B, k) == path
            got[path] = kern(x, w, n, k).float()
    finally:
        _fused.tc_config(name, tc_min)
    torch.cuda.synchronize()
    scale = got["tc"].abs().max()
    assert (got["cuda_core"] - got["tc"]).abs().max() <= 8e-3 * scale


@pytest.mark.parametrize("fmt", ["q4k", "q5k", "q6k", "q8"])
@pytest.mark.parametrize("B", ["threshold", 128])
def test_tensor_core_path_takes_x_at_an_odd_element_offset(cuda, fmt, B):
    """x a contiguous view at an odd bf16 offset of a larger buffer (2 bytes
    past a 16-byte boundary): the wrapper hands the tensor cores, which copy
    x in 16-byte units, an aligned copy, and the result is the plain
    version's."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    B = TC_MIN_BATCH[fmt] if B == "threshold" else B
    kern, plain = _kernel(fmt)
    n, k = 256, 2048
    rng = np.random.default_rng(B + 1)
    w = _blocks(rng, n, k, SIZES[fmt]).to(cuda)
    x0 = torch.from_numpy(rng.standard_normal((B, k), np.float32)).to(cuda, torch.bfloat16)
    buf = torch.zeros(1 + B * k, dtype=torch.bfloat16, device=cuda)
    x = buf[1:].view(B, k)
    x.copy_(x0)
    assert x.data_ptr() % 16 == 2
    assert _fused.route(f"{fmt}_matmul", B, k) == "tc"
    before = kern.launches
    got, want = kern(x, w, n, k), plain(x0, w, n, k)
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


#: the kernel's tile edges: one query; a 256-token slice; 37 and 17 tokens
#: (partial 64-row tiles) whose last key is not a multiple of 64; the
#: follow-up suffix of 86 tokens at 745 (the served shape, and a small grid)
FLASH_SPANS = [(1, 512, (0, 300, 511)), (256, 1024, (0, 256, 768)),
               (37, 256, (0, 100, 219)), (17, 256, (0, 130, 239)),
               (86, 1024, (745,))]
#: GQA groups 4, 1, 2, 8 and 16 (the window of 100 ends inside a 64-key tile)
FLASH_HEADS = [(32, 8, 128), (8, 8, 64), (16, 8, 128), (64, 8, 128), (32, 2, 64)]


@pytest.mark.parametrize("S,n_ctx,offsets", FLASH_SPANS)
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("H,n_kv,hd", FLASH_HEADS)
def test_flash_attention_matches_plain(cuda, S, n_ctx, offsets, window, H, n_kv, hd):
    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention

    g = torch.Generator(device=cuda).manual_seed(S + window)
    q = torch.randn(S, H, hd, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(n_kv, n_ctx, hd, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(n_kv, n_ctx, hd, generator=g, device=cuda).to(torch.bfloat16)
    for off in offsets:
        before = attention.flash_attention.launches
        got = attention.flash_attention(q, k, v, off, hd ** -0.5, window)
        want = attention.flash_attention_plain(q, k, v, off, hd ** -0.5, window)
        torch.cuda.synchronize()
        assert attention.flash_attention.launches == before + 1
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max() <= 2e-2, off


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_out,k_in", [(4096, 4096), (1024, 4096), (14336, 4096),
                                        (4096, 14336), (128256, 4096)])
@pytest.mark.parametrize("fmt", ["q4k", "q5k", "q8"])
def test_dequant_load_shapes_bit_exact(cuda, fmt, n_out, k_in, out):
    """The Q4_K, Q5_K and Q8_0 dequants at every shape an 8B load hands
    them (a layer's linears, token_embd and the output head), into bf16
    and f32, every header byte random: bit for bit the plain version."""
    kern, plain = _dequant(fmt)
    raw = _blocks(np.random.default_rng(n_out + k_in), n_out, k_in, SIZES[fmt]).to(cuda)
    before = kern.launches
    got, want = kern(raw, out), plain(raw, out)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.shape == (n_out * k_in,) and got.dtype == out
    bits = torch.int16 if out == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("fmt,off", [("q4k", 8), ("q5k", 8), ("q6k", 1), ("q8", 1)])
def test_dequant_refuses_a_misaligned_raw_tensor(cuda, fmt, off):
    """Raw bytes off the kernel's load alignment (16 bytes for Q4_K and
    Q5_K, 2 for Q6_K and Q8_0) raise, with no copy and no launch."""
    kern, _ = _dequant(fmt)
    size = SIZES[fmt]
    buf = _blocks(np.random.default_rng(0), 8, 1024, size).to(cuda).reshape(-1)
    raw = torch.empty(buf.numel() + off, dtype=torch.uint8, device=cuda)[off:]
    raw.copy_(buf)
    assert raw.is_contiguous() and raw.data_ptr() % 16 == off
    before = kern.launches
    with pytest.raises(ValueError, match="aligned"):
        kern(raw)
    assert kern.launches == before


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


@pytest.mark.parametrize("S,pos_offset", [(1, 0), (1, 700), (256, 0), (256, 256), (256, 768),
                                          (37, 11), (1, 255), (1, 1023)])
@pytest.mark.parametrize("n_kv,hd", [(8, 128), (4, 64)])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_kv_quantize_bit_exact(cuda, S, pos_offset, n_kv, hd, theta):
    """The un-rotated k and the pass's RoPE table in, written into a
    layer's ring in place: bit for bit the plain version's ring (the plain
    rotation, then the plain quantize), with an all-zero row and a half-way
    row among the inputs and the other slots left alone."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import kvquant
    from llama_fastapi_k8s_gpu_tpu_torch.ops.rope import rope_cos_sin

    n_ctx = 1024
    g = torch.Generator(device=cuda).manual_seed(S + pos_offset + hd)
    k = (torch.randn(S, n_kv, hd, generator=g, device=cuda) * 4).to(torch.bfloat16)
    v = torch.randn(S, n_kv, hd, generator=g, device=cuda).to(torch.bfloat16)
    k[0, 0] = 0
    v[0, 0] = 0
    v[0, 0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])
    positions = pos_offset + torch.arange(S, device=cuda)
    cos, sin = rope_cos_sin(positions, hd, theta)
    rings = [torch.full((n_kv, n_ctx, hd), 7, dtype=torch.int8, device=cuda) for _ in range(4)]
    scales = [torch.full((n_kv, n_ctx), 0.5, device=cuda) for _ in range(4)]
    before = kvquant.kv_quantize.launches
    kvquant.kv_quantize(k, v, cos, sin, positions, rings[0], rings[1], scales[0], scales[1])
    kvquant.kv_quantize_plain(k, v, cos, sin, positions, rings[2], rings[3], scales[2],
                              scales[3])
    torch.cuda.synchronize()
    assert kvquant.kv_quantize.launches == before + 1
    assert torch.equal(rings[0], rings[2]) and torch.equal(rings[1], rings[3])
    assert torch.equal(scales[0].view(torch.int32), scales[2].view(torch.int32))
    assert torch.equal(scales[1].view(torch.int32), scales[3].view(torch.int32))
    assert rings[1][0, pos_offset, :4].tolist() == [127, 2, -4, 0]
    assert not rings[0][0, pos_offset].any() and scales[0][0, pos_offset] == 0


@pytest.mark.parametrize("S,n_ctx,offsets", FLASH_SPANS)
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("H,n_kv,hd", FLASH_HEADS)
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
    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention, kvquant, q4k

    q = torch.zeros(4, 6, 96, dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(2, 16, 96, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        attention.flash_attention(q, kv, kv, 0, 0.1)            # head_dim 96
    kv64 = torch.zeros(2, 16, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                              # group 3 ∤ 64 rows
        attention.flash_attention(torch.zeros(4, 6, 64, dtype=torch.bfloat16, device=cuda),
                                  kv64, kv64, 0, 0.1)
    q4 = torch.zeros(4, 4, 64, dtype=torch.bfloat16, device=cuda)
    kv8 = torch.zeros(2, 16, 64, dtype=torch.int8, device=cuda)
    s16 = torch.zeros(2, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                              # bf16 scales
        attention.flash_attention_int8(q4, kv8, kv8, s16, s16, 0, 0.1)
    w = torch.zeros(8, 144, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        q4k.q4k_matmul(torch.zeros(1, 256, device=cuda), w, 8, 256)   # f32 x
    k96 = torch.zeros(1, 2, 96, dtype=torch.bfloat16, device=cuda)
    ring = torch.zeros(2, 16, 96, dtype=torch.int8, device=cuda)
    sc, table = torch.zeros(2, 16, device=cuda), torch.zeros(1, 48, device=cuda)
    at = torch.zeros(1, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kvquant.kv_quantize(k96, k96, table, table, at, ring, ring, sc, sc)


@pytest.mark.parametrize("gtype", ["Q4_K", "Q5_K", "Q6_K", "Q8_0"])
def test_dequant_f32_output_bit_exact(cuda, gtype):
    from llama_fastapi_k8s_gpu_tpu_torch.ops import dequant

    size = {"Q4_K": 144, "Q5_K": 176, "Q6_K": 210, "Q8_0": 34}[gtype]
    raw = _blocks(np.random.default_rng(3), 37, 4352, size).to(cuda)
    fn = getattr(dequant, f"dequant_{gtype.lower()}")
    plain = getattr(dequant, f"dequant_{gtype.lower()}_plain")
    before = fn.launches
    got = fn(raw, torch.float32)
    want = plain(raw, torch.float32)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("B", [1, 17, 256])
def test_int8_linear_through_int_mm_bit_exact(cuda, B):
    """The int8 linear on the card (``torch._int_mm``, rows padded to 17)
    against its CPU result (an int32 ``matmul``)."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops.linear import linear, make_linear_int8

    g = torch.Generator().manual_seed(B)
    w = torch.randn(1024, 4096, generator=g) * 4096 ** -0.5
    x = (torch.randn(B, 4096, generator=g) * 3).to(torch.bfloat16)
    lin = make_linear_int8(w)
    want = linear(x, lin)
    got = linear(x.to(cuda), make_linear_int8(w.to(cuda)))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def _loop_case(cuda, w_int8: bool, kv_int8: bool, window: int, pos: int = 100,
               n_kv: int = 2, n_heads: int = 4, n_ctx: int = 128, cfg=None):
    """A model of random weights — by default dim 256, 4 layers, ``n_heads``
    query heads of 256 / n_heads over ``n_kv`` KV heads — and a ring filled
    with random K/V up to ``pos``."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import init_cache
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import synth_params
    from llama_fastapi_k8s_gpu_tpu_torch.ops import kvquant

    if cfg is None:
        cfg = ModelConfig(vocab_size=64, dim=256, n_layers=4, n_heads=n_heads, n_kv_heads=n_kv,
                          ffn_dim=512, n_ctx=n_ctx)
    cfg = dataclasses.replace(cfg, sliding_window=window, kv_dtype="int8" if kv_int8 else "bf16")
    params = synth_params(cfg, "int8" if w_int8 else "bf16", seed=5, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    cache = init_cache(cfg, cuda)
    shape = (cfg.n_layers, cfg.n_kv_heads, pos, cfg.head_dim)
    for name in ("k", "v"):
        x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
        if kv_int8:
            cache[name + "_q"][:, :, :pos], cache[name + "_s"][:, :, :pos] = \
                kvquant.quantize_kv_plain(x)
        else:
            cache[name][:, :, :pos] = x
    h = torch.randn(1, cfg.dim, generator=g, device=cuda).to(torch.bfloat16)
    return cfg, params, cache, h


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _check_loop_launch(cfg, params, cache, h, pos, layer0, K, w_int8):
    """One kernel launch of layers [layer0, layer0 + K) at slot ``pos``
    against the plain looped step, each on its own copy of ``cache``: h
    within 2e-2 rel-dev, the slot written within 2e-2 (int8 codes within
    one), nothing else moved.  Returns the kernel's copy."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import LOOP_LINEARS
    from llama_fastapi_k8s_gpu_tpu_torch.ops import decode_loop

    fmts = dict.fromkeys(LOOP_LINEARS, "int8" if w_int8 else "bf16")
    got_cache = {k: v.clone() for k, v in cache.items()}
    want_cache = {k: v.clone() for k, v in cache.items()}
    at = torch.tensor([pos], device=h.device)
    before = decode_loop.decode_loop_step.launches
    got = decode_loop.decode_loop_step(params, got_cache, h, at, layer0, cfg, fmts, K)
    want = decode_loop.decode_loop_plain(params, want_cache, h, at, layer0, cfg, fmts, K)
    torch.cuda.synchronize()
    where = (pos, layer0, K)
    assert decode_loop.decode_loop_step.launches == before + 1
    assert torch.isfinite(got).all() and _rel(got, want) <= 2e-2, where
    layers = slice(layer0, layer0 + K)
    if cfg.kv_dtype == "int8":
        for name in ("k", "v"):
            q, s = got_cache[name + "_q"], got_cache[name + "_s"]
            wq, ws = want_cache[name + "_q"], want_cache[name + "_s"]
            assert (q[layers, :, pos].int() - wq[layers, :, pos].int()).abs().max() <= 1, where
            assert _rel(s[layers, :, pos], ws[layers, :, pos]) <= 2e-2, where
    else:
        for name in ("k", "v"):
            assert _rel(got_cache[name][layers, :, pos],
                        want_cache[name][layers, :, pos]) <= 2e-2, where
    # no slot of a layer outside the launch, or of another position, moved
    for name, leaf in got_cache.items():
        assert torch.equal(leaf[:layer0], cache[name][:layer0]), (name, where)
        assert torch.equal(leaf[layer0 + K:], cache[name][layer0 + K:]), (name, where)
        assert torch.equal(leaf[:, :, :pos], cache[name][:, :, :pos]), (name, where)
    return got_cache


#: ring slots of the small loop cases: the first and the last, and both
#: sides of the attention's key-chunk edges (aligned multiples of 8 at this
#: size, where every item has a block of its own)
LOOP_SLOTS = (0, 7, 8, 9, 15, 16, 17, 63, 64, 65, 126)


@pytest.mark.parametrize("w_int8", [False, True])
@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("window", [0, 16])
def test_decode_loop_matches_plain(cuda, w_int8, kv_int8, window):
    """The four kernel variants against the plain looped step: K = 1, 2
    and 4 layers ending at the last layer at slot 100; then, at GQA groups
    4, 2 and 1, one layer at every slot of LOOP_SLOTS (window 16: its edge
    falls inside a chunk) and a second launch at the next slot on the
    caches the first left — the per-head arrival counters are back at zero,
    or its combine would come early or never."""
    cfg, params, cache, h = _loop_case(cuda, w_int8, kv_int8, window)
    for K in (1, 2, 4):
        _check_loop_launch(cfg, params, cache, h, 100, cfg.n_layers - K, K, w_int8)
    for n_kv in (1, 2, 4):
        for pos in LOOP_SLOTS:
            cfg, params, cache, h = _loop_case(cuda, w_int8, kv_int8, window, pos, n_kv)
            got = _check_loop_launch(cfg, params, cache, h, pos, cfg.n_layers - 1, 1, w_int8)
            _check_loop_launch(cfg, params, got, h, pos + 1, cfg.n_layers - 1, 1, w_int8)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("pos,window", [(4095, 0), (2047, 0), (4095, 1000)])
def test_decode_loop_items_wrap_the_grid(cuda, kv_int8, pos, window):
    """A 4096-slot ring over 8 KV heads of 32 (group 1): up to 64-slot
    chunks and more attention items than blocks, so blocks take several
    items each (and a window's keys start mid-ring)."""
    cfg, params, cache, h = _loop_case(cuda, False, kv_int8, window, pos, n_kv=8, n_heads=8,
                                       n_ctx=4096)
    _check_loop_launch(cfg, params, cache, h, pos, cfg.n_layers - 1, 1, False)


@pytest.mark.parametrize("w_int8", [False, True])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_loop_8b_width_last_slot(cuda, w_int8, kv_int8):
    """One Llama-3-8B-width layer (32 query heads over 8 KV heads of 128)
    at the last slot of a 1024-slot ring, 1023 keys filled."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import LLAMA3_8B

    cfg8 = dataclasses.replace(LLAMA3_8B, n_layers=1, vocab_size=256, n_ctx=1024)
    cfg, params, cache, h = _loop_case(cuda, w_int8, kv_int8, 0, 1023, cfg=cfg8)
    _check_loop_launch(cfg, params, cache, h, 1023, 0, 1, w_int8)


@pytest.mark.parametrize("n_kv,hd", [(8, 128), (4, 64)])
def test_kv_quantize_reads_its_slot_from_device_memory(cuda, n_kv, hd):
    """One launch captured in a CUDA graph at slot 0, replayed after the
    slot tensor is set to 255, 700 and 1023: each replay writes the slot the
    tensor holds, bit for bit the plain version's ring."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import kvquant
    from llama_fastapi_k8s_gpu_tpu_torch.ops.rope import rope_cos_sin

    n_ctx = 1024
    g = torch.Generator(device=cuda).manual_seed(hd)
    k = (torch.randn(1, n_kv, hd, generator=g, device=cuda) * 4).to(torch.bfloat16)
    v = torch.randn(1, n_kv, hd, generator=g, device=cuda).to(torch.bfloat16)
    at = torch.zeros(1, dtype=torch.int64, device=cuda)
    rings = [torch.full((n_kv, n_ctx, hd), 7, dtype=torch.int8, device=cuda) for _ in range(4)]
    scales = [torch.full((n_kv, n_ctx), 0.5, device=cuda) for _ in range(4)]

    def write():
        cos, sin = rope_cos_sin(at, hd, 500000.0)
        kvquant.kv_quantize(k, v, cos, sin, at, rings[0], rings[1], scales[0], scales[1])

    write()                                        # builds; slot 0 written
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        write()
    for slot in (0, 255, 700, 1023):
        at.fill_(slot)
        graph.replay()
        cos, sin = rope_cos_sin(at, hd, 500000.0)
        kvquant.kv_quantize_plain(k, v, cos, sin, at, rings[2], rings[3], scales[2], scales[3])
        torch.cuda.synchronize()
        assert torch.equal(rings[0], rings[2]) and torch.equal(rings[1], rings[3]), slot
        assert torch.equal(scales[0].view(torch.int32), scales[2].view(torch.int32)), slot
        assert torch.equal(scales[1].view(torch.int32), scales[3].view(torch.int32)), slot
    assert (scales[0][:, [0, 255, 700, 1023]] != 0.5).all()


@pytest.mark.parametrize("w_int8", [False, True])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_loop_reads_its_slot_from_device_memory(cuda, w_int8, kv_int8):
    """One Llama-3-8B-width layer over a 1024-slot ring filled to 1023: a
    launch captured in a CUDA graph at slot 0, replayed with the slot tensor
    at 0, 255, 700 and 1023 (the ring restored before each), against the
    plain looped step at that slot as :func:`_check_loop_launch` holds it."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import LLAMA3_8B
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import LOOP_LINEARS
    from llama_fastapi_k8s_gpu_tpu_torch.ops import decode_loop

    cfg8 = dataclasses.replace(LLAMA3_8B, n_layers=1, vocab_size=256, n_ctx=1024)
    cfg, params, base, h = _loop_case(cuda, w_int8, kv_int8, 0, 1023, cfg=cfg8)
    fmts = dict.fromkeys(LOOP_LINEARS, "int8" if w_int8 else "bf16")
    at = torch.zeros(1, dtype=torch.int64, device=cuda)
    cache = {k: v.clone() for k, v in base.items()}
    out = {}

    def launch():
        out["h"] = decode_loop.decode_loop_step(params, cache, h, at, 0, cfg, fmts, 1)

    launch()                                        # builds; the scratch exists
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    for slot in (0, 255, 700, 1023):
        for k, v in base.items():
            cache[k].copy_(v)
        at.fill_(slot)
        graph.replay()
        want_cache = {k: v.clone() for k, v in base.items()}
        want = decode_loop.decode_loop_plain(params, want_cache, h, torch.tensor([slot], device=cuda),
                                             0, cfg, fmts, 1)
        torch.cuda.synchronize()
        assert torch.isfinite(out["h"]).all() and _rel(out["h"], want) <= 2e-2, slot
        if kv_int8:
            for name in ("k", "v"):
                q, wq = cache[name + "_q"][:, :, slot], want_cache[name + "_q"][:, :, slot]
                assert (q.int() - wq.int()).abs().max() <= 1, slot
                assert _rel(cache[name + "_s"][:, :, slot],
                            want_cache[name + "_s"][:, :, slot]) <= 2e-2, slot
        else:
            for name in ("k", "v"):
                assert _rel(cache[name][:, :, slot], want_cache[name][:, :, slot]) <= 2e-2, slot
        for name, leaf in cache.items():      # no other slot moved
            assert torch.equal(leaf[:, :, :slot], base[name][:, :, :slot]), (name, slot)
            assert torch.equal(leaf[:, :, slot + 1:], base[name][:, :, slot + 1:]), (name, slot)


def _tiny_decode(cuda, fmt, kv_dtype, unroll):
    """A model of random weights (dim 256, 2 layers, 4 query heads of 64
    over 2 KV heads, vocab 512, a 256-slot ring) on the card."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import synth_params

    cfg = ModelConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      ffn_dim=512, n_ctx=256, kv_dtype=kv_dtype, decode_layer_unroll=unroll)
    return cfg, synth_params(cfg, fmt, seed=11, device=cuda)


def _replay_against_eager(cuda, cfg, params, graphs, ids, seed, sp, chunks=2):
    """One request through ``graphs`` (its ring prefilled with ``ids``, the
    first sample, ``chunks`` chunks of 8 replays) against the eager step on
    a clone of the prefilled ring from the same seed: tokens, the state and
    every cache leaf bit-identical.  Returns the tokens."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import (
        decode_step,
        first_sample,
        generate_chunk,
        init_state,
    )
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import sampling_tensors

    cache = graphs._state["cache"]
    with torch.inference_mode():
        logits = forward(params, cfg, torch.tensor(ids, device=cuda), 0, cache)
        ring = {k: v.clone() for k, v in cache.items()}
        st = graphs.knobs(sampling_tensors(sp, cuda))
        state = graphs.state(ids, seed)
        got = [int(first_sample(logits, state, st, top_k=sp.top_k))]
        for _ in range(chunks):
            got += generate_chunk(params, cfg, state, st, 8, top_k=sp.top_k).tolist()
        eager = init_state(ring, ids, seed, cuda)
        est = sampling_tensors(sp, cuda)
        want = [int(first_sample(logits, eager, est, top_k=sp.top_k))]
        want += [int(decode_step(params, cfg, eager, est, top_k=sp.top_k))
                 for _ in range(8 * chunks)]
    torch.cuda.synchronize()
    assert got == want
    for k in ("pos", "wpos", "window", "token"):
        assert torch.equal(state[k], eager[k]), k
    for k in cache:
        assert torch.equal(cache[k], ring[k]), k
    return got


@pytest.mark.parametrize("fmt,kv_dtype,unroll", [("bf16", "bf16", 0), ("bf16", "int8", 0),
                                                 ("int8", "int8", -1), ("bf16", "bf16", 1)])
def test_graph_replay_matches_the_eager_step(cuda, fmt, kv_dtype, unroll):
    """Greedy, then sampled at the default settings, then a second request
    with another seed and other knobs through the same graph, then one with
    another ``top_k`` (captured mid-request): replay equals the eager step
    bit for bit each time, and the kernels' counters grow by their
    per-replay increment times the replays."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import DecodeGraphs
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import init_cache
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams

    cfg, params = _tiny_decode(cuda, fmt, kv_dtype, unroll)
    graphs = DecodeGraphs(params, cfg, init_cache(cfg, cuda))
    graphs.capture(40)
    step = graphs.step_launches(40)
    per_token = cfg.n_layers // (cfg.n_layers if unroll < 0 else unroll) if unroll else 0
    assert step == ({"decode_loop": per_token} if unroll
                    else {"kv_quantize": cfg.n_layers} if kv_dtype == "int8" else {})
    ids = list(range(3, 40))
    greedy = _replay_against_eager(cuda, cfg, params, graphs, ids, 1,
                                   SamplingParams(temperature=0.0))
    assert len(set(greedy)) > 1
    before = {name: fn.launches for name, fn in KERNELS.items()}
    _replay_against_eager(cuda, cfg, params, graphs, ids, 7, SamplingParams(), chunks=1)
    for name, n in step.items():      # 8 replays, 8 eager steps and the prompt pass
        prompt = cfg.n_layers if name == "kv_quantize" else 0
        assert KERNELS[name].launches - before[name] == 8 * n + 8 * n + prompt
    other = SamplingParams(temperature=0.7, top_p=0.8, min_p=0.1, repeat_penalty=1.3,
                           frequency_penalty=0.2, presence_penalty=0.1)
    _replay_against_eager(cuda, cfg, params, graphs, ids[::-1], 99, other)
    assert graphs.keys == [40]
    _replay_against_eager(cuda, cfg, params, graphs, ids, 5,
                          dataclasses.replace(other, top_k=12))
    assert graphs.keys == [40, 12] and graphs.replays == 16 + 8 + 16 + 16
    graphs.close()


def _served_engine(cuda, tmp_path, kv_dtype):
    """An engine as the server runs it on the card, warmed up (its decode
    step captured): a GGUF of random Q8_0 weights written by
    ``chip_smoke.write_gguf`` (dim 256, 2 layers, 4 query heads of 64 over
    2 KV heads, vocab 512), served as bf16 over a 256-slot ring."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      ffn_dim=512, n_ctx=256)
    path = str(tmp_path / "tiny-q8_0.gguf")
    chip_smoke.write_gguf(cfg, path, "q8_0")
    eng = Engine(path, n_ctx=256, max_gen_tokens=48, prefill_buckets=(64, 128, 256),
                 kv_dtype=kv_dtype, device=cuda)
    eng.warmup()
    return eng


SERVED_MSGS = [{"role": "user", "content": "tell me about the sea, please"}]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_stream_closed_after_two_chunks_frees_the_engine(cuda, tmp_path, kv_dtype):
    """A greedy stream closed after its second chunk (what a client's
    disconnect does to it) leaves the engine free, and the next greedy
    reply equals the one from before, byte for byte."""
    eng = _served_engine(cuda, tmp_path, kv_dtype)
    want = eng.create_chat_completion(SERVED_MSGS, temperature=0.0, max_tokens=40)
    it = eng.create_chat_completion(SERVED_MSGS, stream=True, temperature=0.0,
                                    max_tokens=40)
    role, first = next(it), next(it)
    it.close()
    assert role["choices"][0]["delta"] == {"role": "assistant"}
    assert want["choices"][0]["message"]["content"].startswith(
        first["choices"][0]["delta"]["content"])
    assert eng.heartbeat.busy_count() == 0 and not eng._lock.locked()
    again = eng.create_chat_completion(SERVED_MSGS, temperature=0.0, max_tokens=40)
    assert again["choices"] == want["choices"]
    eng.close()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_recover_zeroes_the_ring_in_place_under_graphs(cuda, tmp_path, kv_dtype):
    """A ``decode_step`` fault, then ``recover()``: the ring is zero, every
    leaf keeps its storage (the captured graphs hold those addresses), the
    graphs are kept, and the next greedy reply — replays over the ring the
    prefill writes — equals the one from before the fault."""
    from llama_fastapi_k8s_gpu_tpu_torch.utils.faults import FAULTS, FaultError

    eng = _served_engine(cuda, tmp_path, kv_dtype)
    graphs = eng._graphs
    ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}
    want = eng.create_chat_completion(SERVED_MSGS, temperature=0.0, max_tokens=40)
    FAULTS.arm("decode_step:error:times=1")
    try:
        with pytest.raises(FaultError):
            eng.create_chat_completion(SERVED_MSGS, temperature=0.0, max_tokens=40)
    finally:
        FAULTS.disarm()
    assert eng.heartbeat.errors_total == 1 and eng.heartbeat.busy_count() == 0
    assert eng.recover() is True and eng.failure() is None
    assert all(not bool(v.any()) for v in eng._cache.values())
    assert {k: v.data_ptr() for k, v in eng._cache.items()} == ptrs
    assert eng._graphs is graphs
    again = eng.create_chat_completion(SERVED_MSGS, temperature=0.0, max_tokens=40)
    assert again["choices"] == want["choices"]
    assert graphs.replays > 0
    eng.close()


def test_read_of_a_chunk_returns_before_the_next_chunk_ends(cuda, tmp_path):
    """The decode loop queues chunk k+1 before it reads chunk k: the read
    waits for chunk k's copy alone.  A ~0.5 s spin queued on the stream
    between the two chunks holds chunk k+1 back; chunk k's tokens come
    back well before it, and equal a plain read of them."""
    eng = _served_engine(cuda, tmp_path, "bf16")
    ctx = eng._start(SERVED_MSGS, eng_sampling(), None)
    first = eng._decode_chunk(ctx, 8)
    torch.cuda.synchronize()
    want = first[0].tolist()
    ctx = eng._start(SERVED_MSGS, eng_sampling(), None)
    first = eng._decode_chunk(ctx, 8)
    torch.cuda._sleep(1_000_000_000)         # ~0.5 s at the H100's ~2 GHz
    second = eng._decode_chunk(ctx, 8)
    t0 = time.time()
    got = eng._read_chunk(first)
    waited = time.time() - t0
    assert got == want
    assert not second[1].query(), "chunk k+1 ended before chunk k's read returned"
    assert waited < 0.25
    eng._read_chunk(second)
    eng._prefix_ids = []
    eng.close()


def eng_sampling():
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams

    return SamplingParams(temperature=0.0)


def test_a_capture_is_one_compile_and_a_chunk_one_dispatch(cuda, tmp_path):
    """On the compile registry a graph capture is one compile of
    ``decode_chunk`` (signature ``top_k=<k>``, its seconds), a chunk of
    replays one dispatch, and each kernel's launches its wrapper's
    counter."""
    from llama_fastapi_k8s_gpu_tpu_torch.obs.devtime import DEVTIME
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    def progs():
        return {p["name"]: p for p in DEVTIME.snapshot()["programs"]}

    before = progs().get("decode_chunk", {"compiles": 0, "dispatches": 0})
    cursor, _ = DEVTIME.events_since(0)
    eng = _served_engine(cuda, tmp_path, "bf16")
    warm = progs()["decode_chunk"]
    assert warm["compiles"] - before["compiles"] == 1
    _, events = DEVTIME.events_since(cursor)
    events = [e for e in events if e["program"] == "decode_chunk"]
    assert [e["signature"] for e in events] == ["top_k=40"]
    assert abs(events[0]["wall_s"] - eng._graphs.captures[40]) < 1e-5
    chunks = []
    queue_chunk = eng._decode_chunk
    eng._decode_chunk = lambda ctx, n: chunks.append(n) or queue_chunk(ctx, n)
    eng.create_chat_completion(SERVED_MSGS, temperature=0.0, max_tokens=33)
    after = progs()["decode_chunk"]
    assert after["compiles"] == warm["compiles"]
    assert after["dispatches"] - warm["dispatches"] == len(chunks) > 0
    eng.create_chat_completion(SERVED_MSGS, temperature=0.0, top_k=7, max_tokens=9)
    assert progs()["decode_chunk"]["compiles"] == warm["compiles"] + 1
    assert {n: p["dispatches"] for n, p in progs().items() if n in KERNELS} == \
        {n: fn.launches for n, fn in KERNELS.items()}
    eng.close()


def test_memory_ground_truth_is_the_cuda_allocator(cuda, tmp_path):
    """``/debug/memory``'s ledger on the card: the allocator's live bytes,
    the card's memory as the limit, the engine's weights and ring rows,
    and a residual that is not negative."""
    import gc

    from llama_fastapi_k8s_gpu_tpu_torch.obs.memledger import MEMLEDGER

    gc.collect()                  # the engines of earlier tests leave the ledger
    eng = _served_engine(cuda, tmp_path, "bf16")
    doc = MEMLEDGER.snapshot()
    rows = {(r["component"], r["model"]): r["bytes"] for r in doc["components"]}
    assert rows[("weights", eng.model_name)] == eng.weight_bytes
    assert rows[("kv_ring", eng.model_name)] == eng.kv_cache_bytes
    truth = doc["ground_truth"]
    assert truth["source"] == "torch.cuda.memory_stats"
    assert truth["bytes"] == torch.cuda.memory_allocated()
    assert truth["limit"] == torch.cuda.mem_get_info()[1]
    assert doc["residual_bytes"] >= 0 and doc["headroom"]["bytes"] > 0
    eng.close()


def test_a_profile_holds_cuda_kernel_events(cuda, tmp_path, monkeypatch):
    """``capture_profile`` during a generation writes a Chrome trace with
    CUDA kernel events and graph launches; a second capture meanwhile is
    refused."""
    import re
    import threading

    from llama_fastapi_k8s_gpu_tpu_torch.utils.tracing import ProfileBusy, capture_profile

    eng = _served_engine(cuda, tmp_path, "bf16")
    monkeypatch.setenv("LFKT_PROFILE_DIR", str(tmp_path / "prof"))
    box = {}
    th = threading.Thread(target=lambda: box.update(doc=capture_profile(0.5)))
    th.start()
    time.sleep(0.1)
    with pytest.raises(ProfileBusy):
        capture_profile(0.1)
    while th.is_alive():
        eng.create_chat_completion(SERVED_MSGS, stream=False, temperature=0.0, max_tokens=9)
    th.join()
    doc = box["doc"]
    assert doc["ok"], doc
    text = open(doc["trace"]).read()
    assert re.search(r'"cat":\s*"kernel"', text)
    assert re.search(r'"name":\s*"cudaGraphLaunch', text)
    eng.close()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("offset", [4096, 4352])
def test_flash_attention_mistral_window_over_an_8192_ring(cuda, int8, offset):
    """Mistral-7B's window of 4096 over an 8192-slot ring at full width (32
    query heads over 8 KV heads of 128): 256-query slices at 4096 and 4352,
    whose first keys fall behind the window in whole 64-key tiles, over
    the bf16 and the int8 ring, against the plain versions."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention, kvquant

    g = torch.Generator(device=cuda).manual_seed(offset + int8)
    S, n_ctx, hd, window = 256, 8192, 128, 4096
    q = torch.randn(S, 32, hd, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(8, n_ctx, hd, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(8, n_ctx, hd, generator=g, device=cuda).to(torch.bfloat16)
    if int8:
        (kq, ks), (vq, vs) = kvquant.quantize_kv_plain(k), kvquant.quantize_kv_plain(v)
        got = attention.flash_attention_int8(q, kq, vq, ks, vs, offset, hd ** -0.5, window)
        want = attention.flash_attention_int8_plain(q, kq, vq, ks, vs, offset, hd ** -0.5,
                                                    window)
        full = attention.flash_attention_int8_plain(q, kq, vq, ks, vs, offset, hd ** -0.5, 0)
    else:
        got = attention.flash_attention(q, k, v, offset, hd ** -0.5, window)
        want = attention.flash_attention_plain(q, k, v, offset, hd ** -0.5, window)
        full = attention.flash_attention_plain(q, k, v, offset, hd ** -0.5, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max() <= 2e-2
    # the window bites: the kernel's output is nearer the windowed plain
    # version than the one over every key
    assert (got.float() - want.float()).norm() < (got.float() - full.float()).norm()


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("pos", [4100, 8191])
def test_decode_loop_mistral_window_past_4096(cuda, kv_int8, pos):
    """The looped kernel over one Mistral-7B-width layer (32 query heads
    over 8 KV heads of 128) at slots 4100 and 8191 of an 8192-slot ring
    with window 4096: the split attention's chunk range starts mid-ring."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import MISTRAL_7B

    cfg7 = dataclasses.replace(MISTRAL_7B, n_layers=1, vocab_size=256, n_ctx=8192)
    cfg, params, cache, h = _loop_case(cuda, kv_int8, kv_int8, 4096, pos, cfg=cfg7)
    _check_loop_launch(cfg, params, cache, h, pos, 0, 1, kv_int8)


@pytest.mark.parametrize("gtype", ["BF16", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K",
                                   "IQ4_NL", "IQ4_XS", "F16"])
def test_host_codec_types_expand_on_the_card_bit_exact(cuda, gtype, tmp_path):
    """A 1024×4096 linear of each type without a kernel: the plane the load
    puts on the card (``_expand``, bf16 and f32) equals the codec's numpy
    output cast to bf16, bit for bit (BF16 by a view of its raw words)."""
    from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import _expand

    rng = np.random.default_rng(3)
    path = str(tmp_path / "t.gguf")
    w = GGUFWriter(path)
    w.add_metadata("general.architecture", "llama")
    w.add_tensor("w.weight", (rng.standard_normal((1024, 4096)) * 0.02).astype(np.float32),
                 GGMLType[gtype])
    w.write()
    t = GGUFFile(path)["w.weight"]
    # the codec's output as the load takes it: f32 (the Q3_K codec's own
    # arithmetic runs in f64, as the reference's does)
    host = torch.from_numpy(np.asarray(t.astype_f32(), np.float32))
    want = host.to(torch.bfloat16)
    got = _expand(t, cuda, torch.bfloat16)
    assert got.device.type == "cuda" and got.shape == (1024, 4096)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    got32 = _expand(t, cuda, torch.float32).cpu()
    if gtype == "BF16":
        assert torch.equal(got32, want.float())
    else:
        assert torch.equal(got32.view(torch.int32), host.view(torch.int32))
