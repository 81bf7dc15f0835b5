"""Port kernels' plain versions against the JAX package's kernels.

On the CPU each port wrapper runs its plain PyTorch version, which is what
the CUDA kernel is held to on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Here the plain versions meet the reference: the fused
Q4_K/Q5_K/Q6_K/Q8_0 matmuls against the Pallas kernels in interpret mode —
for Q5_K under both of its TPU layouts (``pre``, the default, and ``cur``)
and for Q6_K under ``pre`` too, each layout a kernel body of its own — the flash
attention, over the bf16 and the int8 ring, against the Pallas flash kernel
(interpret) and the XLA score-matrix path, the int8 KV write (RoPE on k,
then the quantize) and the Q6_K dequant against theirs bit for bit, and the
model's small f32 ops exactly.

Tolerances:
- fused matmuls, rel-dev ‖y−y_ref‖/‖y_ref‖ ≤ 5·10⁻³ — the reference's own
  fused-matmul gate — against the exact product of the codec's weights;
  against the reference kernel, the gate plus that kernel's own distance
  from the exact product (it folds the scales, mins and sub-block sums of
  x to bf16; the port keeps them in f32);
- flash attention, max-abs ≤ 2·10⁻² against the Pallas kernel and the XLA
  score-matrix path, and ≤ 4·10⁻³ against the Pallas kernel alone: the
  plain versions round the probabilities (times ``vs`` on the int8 ring)
  to bf16 before P·V as that kernel does, from the global row max where it
  uses its running max;
- the KV write (RoPE on k, then the quantize) and the Q6_K dequant:
  bit-identical;
- the int8 linear: ``make_linear_int8`` (q and s) and the product itself
  bit-identical to the reference's (the int32 accumulation is exact, and
  the activation quantize and the f32 rescale round at the same steps);
- the dequants' f32 outputs: bit-identical to the codecs';
- rms_norm and RoPE in f32, within 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_fastapi_k8s_gpu_tpu.gguf.quants import dequantize as j_dequantize
from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.models.llama import rms_norm as j_rms_norm
from llama_fastapi_k8s_gpu_tpu.models.llama import rope_interleaved as j_rope
from llama_fastapi_k8s_gpu_tpu.models.llama import xla_attention as j_xla_attention
from llama_fastapi_k8s_gpu_tpu.ops.linear import linear as j_linear
from llama_fastapi_k8s_gpu_tpu.ops.linear import make_linear_int8 as j_make_linear_int8
from llama_fastapi_k8s_gpu_tpu.ops.linear import (
    make_linear_q4k,
    make_linear_q5k,
    make_linear_q6k,
    make_linear_q8,
)
from llama_fastapi_k8s_gpu_tpu.ops.pallas.attention import flash_attention as j_flash
from llama_fastapi_k8s_gpu_tpu.ops.pallas.dequant import dequant_q6_k_device
from llama_fastapi_k8s_gpu_tpu.ops.pallas.kvquant import quantize_kv_pallas, quantize_kv_xla
from llama_fastapi_k8s_gpu_tpu.ops.pallas.qmatmul import q4k_matmul as j_q4k_matmul
from llama_fastapi_k8s_gpu_tpu.ops.pallas.q5matmul import q5k_matmul as j_q5k_matmul
from llama_fastapi_k8s_gpu_tpu.ops.pallas.q6matmul import q6k_matmul as j_q6k_matmul
from llama_fastapi_k8s_gpu_tpu.ops.pallas.q8matmul import q8_matmul as j_q8_matmul
from llama_fastapi_k8s_gpu_tpu_torch.gguf.quants import (
    quant_q4_k,
    quant_q5_k,
    quant_q6_k,
    quant_q8_0,
)
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import rms_norm, rope_interleaved
from llama_fastapi_k8s_gpu_tpu_torch.ops import dequant
from llama_fastapi_k8s_gpu_tpu_torch.ops.linear import Linear, linear, make_linear_int8
from llama_fastapi_k8s_gpu_tpu_torch.ops.attention import flash_attention, flash_attention_int8
from llama_fastapi_k8s_gpu_tpu_torch.ops.dequant import dequant_q6_k
from llama_fastapi_k8s_gpu_tpu_torch.ops.kvquant import kv_quantize, quantize_kv_plain
from llama_fastapi_k8s_gpu_tpu_torch.ops.q4k import q4k_matmul
from llama_fastapi_k8s_gpu_tpu_torch.ops.q5k import q5k_matmul
from llama_fastapi_k8s_gpu_tpu_torch.ops.q6k import q6k_matmul
from llama_fastapi_k8s_gpu_tpu_torch.ops.q8 import q8_matmul
from llama_fastapi_k8s_gpu_tpu_torch.ops.rope import rope_cos_sin

torch.set_num_threads(1)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)


#: per format: the port's wrapper, its quantizer, the GGML type, and the
#: reference's weight maker and fused matmul
FORMATS = {
    "q4k": (q4k_matmul, quant_q4_k, JGGMLType.Q4_K, make_linear_q4k, j_q4k_matmul),
    "q5k": (q5k_matmul, quant_q5_k, JGGMLType.Q5_K, make_linear_q5k, j_q5k_matmul),
    "q6k": (q6k_matmul, quant_q6_k, JGGMLType.Q6_K, make_linear_q6k, j_q6k_matmul),
    "q8": (q8_matmul, quant_q8_0, JGGMLType.Q8_0, make_linear_q8, j_q8_matmul),
}


@pytest.fixture(scope="module")
def fused_weights():
    """(fmt, n, k) → (raw GGUF blocks, f32 weights) from one seed."""
    rng = np.random.default_rng(0)
    out = {}
    for n, k in ((256, 2048), (256, 4096)):
        w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
        for fmt, (_, quant, *_) in FORMATS.items():
            out[(fmt, n, k)] = (quant(w.reshape(-1)), w)
    return out


def _check_fused(fused_weights, fmt, n, k, B, layout=None):
    """The port's fused matmul against the exact product of the codec's
    weights and against the reference kernel (interpret mode) on the
    weights the reference prepared, in ``layout`` where given."""
    port, _, gtype, make, jfn = FORMATS[fmt]
    raw, w = fused_weights[(fmt, n, k)]
    x = np.random.default_rng(B).standard_normal((B, k)).astype(np.float32)
    xb = _bf16(x)
    got = port(xb, torch.from_numpy(raw).reshape(n, -1), n, k).float().numpy()
    assert got.shape == (B, n)
    jw = make(w)
    if layout is not None:
        assert layout in jw, sorted(jw)
    ref = np.asarray(jfn(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jw,
                         interpret=True)).astype(np.float32)
    wq = j_dequantize(raw, gtype, n * k).reshape(n, k)
    exact = xb.float().numpy() @ wq.T
    # the gate, against the exact product of the numpy codec's weights
    assert _rel(got, exact) <= 5e-3
    # and against the reference kernel: no farther from it than the gate
    # plus the reference's own distance from the exact product (its bf16
    # folding puts it 0.45-0.81% away at these shapes, above the gate)
    assert _rel(got, ref) <= _rel(ref, exact) + 5e-3


@pytest.mark.parametrize("fmt", ["q4k", "q6k", "q5k", "q8"])
@pytest.mark.parametrize("n,k", [(256, 2048), (256, 4096)])
@pytest.mark.parametrize("B", [1, 3, 17, 256])
def test_fused_matmul_matches_reference_kernel(fused_weights, fmt, n, k, B):
    """Under each format's default layout (Q5_K: ``pre``, whose body is
    ``_q5k_pre_kernel``; Q6_K: ``cur``); B = 3: a decode step of a few
    rows, whose kernel masks rows of its 4-row template."""
    _check_fused(fused_weights, fmt, n, k, B,
                 layout={"q5k": "q5p", "q6k": "q4"}.get(fmt))


@pytest.mark.parametrize("fmt,env,layout", [
    ("q5k", ("LFKT_Q5K_KERNEL", "cur"), "q5s"),    # _q5k_matmul_kernel
    ("q6k", ("LFKT_Q6K_KERNEL", "pre"), "q6p"),    # _q6k_pre_kernel
])
@pytest.mark.parametrize("n,k", [(256, 2048), (256, 4096)])
def test_fused_matmul_matches_reference_layout_variant(fused_weights, monkeypatch,
                                                       fmt, env, layout, n, k):
    """The reference's other layout of the same function (another Pallas
    kernel body) against the same port kernel, which decodes the blocks
    themselves and has no layout of its own."""
    monkeypatch.setenv(*env)
    _check_fused(fused_weights, fmt, n, k, 17, layout=layout)


@pytest.mark.parametrize("fmt", ["q5k", "q6k", "q4k", "q8"])
@pytest.mark.parametrize("n,k", [(256, 2048), (256, 4096)])
@pytest.mark.parametrize("B", [17, 128, 256])
def test_bf16_weight_product_within_gate(fused_weights, fmt, n, k, B):
    """The arithmetic of the fused matmuls' tensor-core path
    (csrc/qmma.cuh): every weight the codec's f32 value rounded to bf16
    once (for Q8_0, d·q), x · Wᵀ summed in f32, the result rounded to
    bf16.  Held to the exact product of the codec's weights within the
    5·10⁻³ gate, and to the reference kernel (interpret mode) within the
    gate plus that kernel's own distance from the exact product."""
    _, _, gtype, make, jfn = FORMATS[fmt]
    raw, w = fused_weights[(fmt, n, k)]
    deq = {"q4k": dequant.dequant_q4_k_f32, "q5k": dequant.dequant_q5_k_f32,
           "q6k": dequant.dequant_q6_k_f32, "q8": dequant.dequant_q8_0_f32}[fmt]
    wq = j_dequantize(raw, gtype, n * k).reshape(n, k)
    wf = deq(torch.from_numpy(raw)).reshape(n, k)
    assert np.array_equal(wf.numpy(), wq)          # the port's codec is the reference's
    xb = _bf16(np.random.default_rng(B).standard_normal((B, k)).astype(np.float32))
    got = torch.matmul(xb.float(), wf.to(torch.bfloat16).float().t()).to(torch.bfloat16)
    got = got.float().numpy()
    exact = xb.float().numpy() @ wq.T
    ref = np.asarray(jfn(jnp.asarray(xb.float().numpy(), jnp.bfloat16), make(w),
                         interpret=True)).astype(np.float32)
    assert _rel(got, exact) <= 5e-3
    assert _rel(got, ref) <= _rel(ref, exact) + 5e-3


def test_q8_matmul_unaligned_row_stride():
    """K = 4128 (129 Q8_0 blocks, 4386-byte rows): fusable for Q8_0, not a
    whole 256-element chunk — the CUDA kernel's partial last chunk; the
    plain version against the exact product of the codec's weights."""
    n, k = 40, 4128
    rng = np.random.default_rng(4128)
    w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
    raw = quant_q8_0(w.reshape(-1))
    xb = _bf16(rng.standard_normal((5, k)).astype(np.float32))
    got = q8_matmul(xb, torch.from_numpy(raw).reshape(n, -1), n, k).float().numpy()
    exact = xb.float().numpy() @ j_dequantize(raw, JGGMLType.Q8_0, n * k).reshape(n, k).T
    assert got.shape == (5, n)
    assert _rel(got, exact) <= 5e-3


@pytest.mark.parametrize("offset", [0, 1, 3, 7, 8])
def test_aligned_rows_copies_only_an_x_off_a_16_byte_boundary(offset):
    """The fused wrapper's x for the tensor cores: a contiguous view at an
    odd bf16 offset of a larger buffer comes back 16-byte aligned with the
    same values; a view on a 16-byte boundary (offsets 0 and 8) comes back
    as itself, with no copy."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    B, k = 3, 256
    buf = torch.arange(offset + B * k, dtype=torch.float32).to(torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    x = buf[offset:offset + B * k].view(B, k)
    got = _fused.aligned_rows(x, 16)
    assert got.data_ptr() % 16 == 0 and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, x)
    if offset % 8 == 0:
        assert got is x
    else:
        assert got.data_ptr() != x.data_ptr()


def test_linear_dispatch_and_shape_checks(fused_weights):
    raw, _ = fused_weights[("q4k", 256, 2048)]
    w = torch.from_numpy(raw).reshape(256, -1)
    lin = Linear("q4k", w, 256, 2048)
    x = torch.zeros(3, 5, 2048, dtype=torch.bfloat16)
    assert lin(x).shape == (3, 5, 256)
    with pytest.raises(ValueError):
        q4k_matmul(x, w, 256, 4096)
    with pytest.raises(ValueError):
        q6k_matmul(x, w, 256, 2048)
    with pytest.raises(ValueError):
        q5k_matmul(x, w, 256, 2048)
    with pytest.raises(ValueError):
        q8_matmul(x, w, 256, 2048)
    with pytest.raises(ValueError):
        Linear("int8", w, 256, 2048)
    raw8, _ = fused_weights[("q8", 256, 2048)]
    assert Linear("q8", torch.from_numpy(raw8).reshape(256, -1), 256, 2048)(x).shape \
        == (3, 5, 256)


def _attn_inputs(S, n_ctx, H=8, n_kv=2, hd=128, seed=0):
    """Queries and a full random ring: slots past the queries' positions
    hold stale keys that only the causal mask hides."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    k = rng.standard_normal((n_kv, n_ctx, hd)).astype(np.float32)
    v = rng.standard_normal((n_kv, n_ctx, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S,offsets", [(1, (0, 64, 511)), (64, (0, 64, 448)),
                                       (256, (0, 64, 256))])
@pytest.mark.parametrize("window", [0, 128])
def test_flash_attention_matches_reference(S, offsets, window):
    n_ctx, H, n_kv, hd = 512, 8, 2, 128
    q, k, v = _attn_inputs(S, n_ctx, H, n_kv, hd, seed=S + window)
    qb, kb, vb = _bf16(q), _bf16(k), _bf16(v)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qb, kb, vb))
    cfg = JModelConfig(vocab_size=1, dim=H * hd, n_layers=1, n_heads=H,
                       n_kv_heads=n_kv, ffn_dim=1, n_ctx=n_ctx,
                       sliding_window=window)
    for off in offsets:
        got = flash_attention(qb, kb, vb, off, hd ** -0.5, window).float().numpy()
        ref_flash = np.asarray(j_flash(jq, jk, jv, jnp.int32(off), sm_scale=hd ** -0.5,
                                       sliding_window=window, interpret=True),
                               np.float32)
        pos = jnp.arange(off, off + S, dtype=jnp.int32)
        ref_xla = np.asarray(j_xla_attention(jq, jk, jv, None, None, pos, cfg,
                                             jnp.bfloat16), np.float32)
        assert np.isfinite(got).all()
        assert np.abs(got - ref_flash).max() <= 2e-2, (off, window)
        assert np.abs(got.reshape(S, -1) - ref_xla).max() <= 2e-2, (off, window)


def test_flash_attention_rejects_out_of_ring_positions():
    q, k, v = (_bf16(t) for t in _attn_inputs(4, 16, 4, 1, 64))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, 13, 0.125)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 4, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    ref = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    pos = np.array([0, 1, 5, 100, 1000, 4000, 8191], np.int32)
    for theta in (10000.0, 500000.0, 1e6):
        got = rope_interleaved(torch.from_numpy(x), torch.from_numpy(pos).long(),
                               theta).numpy()
        ref = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos), theta))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _kv_inputs(seed: int) -> np.ndarray:
    """(n_kv, S, hd) bf16-valued K/V slabs: random rows at mixed scales, an
    all-zero row, and a row whose scaled values sit exactly half-way
    between two integers (max 127 → s = 1: 2.5 → 2, -3.5 → -4, 0.5 → 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 37, 128)) * rng.uniform(1e-3, 1e2, (4, 37, 1))
    x[1, 3] = 0.0
    x[2, 5] = 0.0
    x[2, 5, :4] = (127.0, 2.5, -3.5, 0.5)
    return _bf16(x).float().numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_matches_reference_bit_for_bit(seed):
    """The plain quantize against the reference's XLA formulation: int8
    values and f32 scales bit-identical, the zero row stored as zeros and
    the half-way row rounded to even.  Against the Pallas kernel (interpret
    mode), bit-identical on every row where that kernel's scale is the
    IEEE ``max/127``: it folds the division into a multiply by ``1/127``,
    so some scales sit one ulp off, with values within ±1 — its own
    agreement with the XLA path (tests/test_kv_quant.py)."""
    x = _kv_inputs(seed)
    jx = jnp.asarray(x, jnp.bfloat16)
    q, s = quantize_kv_plain(torch.from_numpy(x).to(torch.bfloat16))
    q, s = q.numpy(), s.numpy()
    q0, s0 = (np.asarray(a) for a in quantize_kv_xla(jx))
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert np.array_equal(q, q0) and np.array_equal(s.view(np.int32), s0.view(np.int32))
    assert not q[1, 3].any() and s[1, 3] == 0.0
    assert s[2, 5] == 1.0 and list(q[2, 5, :4]) == [127, 2, -4, 0]
    q1, s1 = (np.asarray(a) for a in quantize_kv_pallas(jx, interpret=True))
    same = s1 == s
    assert same.mean() > 0.5
    assert np.array_equal(q[same], q1[same])
    assert np.abs(s.view(np.int32)[~same] - s1.view(np.int32)[~same]).max(initial=0) <= 1
    assert np.abs(q.astype(np.int32) - q1).max() <= 1


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("S,pos_offset", [(1, 0), (1, 700), (37, 20), (256, 256)])
def test_kv_quantize_writes_the_reference_ring_slots(S, pos_offset, theta, hd):
    """The int8 KV write (the kernel's function, on the CPU its plain
    version) takes the un-rotated k and the pass's RoPE table: the ring
    equals the reference's ``rope_interleaved`` on k, ``quantize_kv_xla`` of
    the head-major slabs and its ``dynamic_update_slice``s, bit for bit,
    and the other slots are left alone."""
    n_kv, n_ctx = 2, 1024
    rng = np.random.default_rng(S + pos_offset + hd)
    k = _bf16(rng.standard_normal((S, n_kv, hd)) * 3.0)
    v = _bf16(rng.standard_normal((S, n_kv, hd)))
    positions = pos_offset + torch.arange(S)
    cos, sin = rope_cos_sin(positions, hd, theta)
    rings = [torch.full((n_kv, n_ctx, hd), 7, dtype=torch.int8) for _ in range(2)]
    scales = [torch.full((n_kv, n_ctx), 0.5) for _ in range(2)]
    kv_quantize(k, v, cos, sin, positions, *rings, *scales)
    jk = j_rope(jnp.asarray(k.float().numpy(), jnp.bfloat16),
                jnp.asarray(positions.numpy(), jnp.int32), theta)
    jv = jnp.asarray(v.float().numpy(), jnp.bfloat16)
    for x, ring, sc in ((jk, rings[0], scales[0]), (jv, rings[1], scales[1])):
        jq, js = quantize_kv_xla(x.transpose(1, 0, 2))
        want_q = np.full((n_kv, n_ctx, hd), 7, np.int8)
        want_s = np.full((n_kv, n_ctx), 0.5, np.float32)
        want_q[:, pos_offset:pos_offset + S] = np.asarray(jq)
        want_s[:, pos_offset:pos_offset + S] = np.asarray(js)
        assert np.array_equal(ring.numpy(), want_q)
        assert np.array_equal(sc.numpy().view(np.int32), want_s.view(np.int32))
    with pytest.raises(ValueError, match="positions"):
        kv_quantize(k, v, cos, sin, torch.arange(S + 1), *rings, *scales)
    with pytest.raises(ValueError, match="positions"):
        kv_quantize(k, v, cos, sin, positions.int(), *rings, *scales)
    with pytest.raises(ValueError, match="table"):
        kv_quantize(k, v, cos[:, :-1], sin[:, :-1], positions, *rings, *scales)


@pytest.mark.parametrize("S,offsets", [(1, (0, 64, 511)), (64, (0, 64, 448)),
                                       (256, (0, 64, 256))])
@pytest.mark.parametrize("window", [0, 128])
def test_flash_attention_int8_matches_reference(S, offsets, window):
    """Over an int8 ring quantized by the reference: the port's int8 flash
    (its plain version) against the Pallas flash kernel with ``k_scale``/
    ``v_scale`` (interpret) and against the XLA score-matrix path with the
    scales folded in, max |Δ| ≤ 2·10⁻²."""
    n_ctx, H, n_kv, hd = 512, 8, 2, 128
    q, k, v = _attn_inputs(S, n_ctx, H, n_kv, hd, seed=S + window)
    qb = _bf16(q)
    jq = jnp.asarray(qb.float().numpy(), jnp.bfloat16)
    jkq, jks = quantize_kv_xla(jnp.asarray(_bf16(k).float().numpy(), jnp.bfloat16))
    jvq, jvs = quantize_kv_xla(jnp.asarray(_bf16(v).float().numpy(), jnp.bfloat16))
    kq, ks, vq, vs = (torch.from_numpy(np.array(a)) for a in (jkq, jks, jvq, jvs))
    cfg = JModelConfig(vocab_size=1, dim=H * hd, n_layers=1, n_heads=H,
                       n_kv_heads=n_kv, ffn_dim=1, n_ctx=n_ctx,
                       sliding_window=window, kv_dtype="int8")
    for off in offsets:
        got = flash_attention_int8(qb, kq, vq, ks, vs, off, hd ** -0.5,
                                   window).float().numpy()
        ref_flash = np.asarray(j_flash(jq, jkq, jvq, jnp.int32(off), sm_scale=hd ** -0.5,
                                       sliding_window=window, k_scale=jks, v_scale=jvs,
                                       interpret=True), np.float32)
        pos = jnp.arange(off, off + S, dtype=jnp.int32)
        ref_xla = np.asarray(j_xla_attention(jq, jkq, jvq, jks, jvs, pos, cfg,
                                             jnp.bfloat16), np.float32)
        assert np.isfinite(got).all()
        assert np.abs(got - ref_flash).max() <= 2e-2, (off, window)
        assert np.abs(got.reshape(S, -1) - ref_xla).max() <= 2e-2, (off, window)


@pytest.mark.parametrize("S,offsets", [(1, (0, 64, 511)), (64, (0, 64, 448)),
                                       (256, (0, 64, 256))])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("ring", ["bf16", "int8"])
def test_flash_plain_rounds_p_as_the_reference(S, offsets, window, ring):
    """The plain versions (what the CUDA kernel is held to) compute the
    Pallas kernel's arithmetic: f32 scores and softmax state, the
    unnormalised probabilities (times ``vs`` on the int8 ring) rounded to
    bf16 before P·V.  Against that kernel in interpret mode, max |Δ| ≤
    4·10⁻³, five times tighter than the gate above; measured here ≤
    1.96·10⁻³ over this grid on both rings (one or two bf16 steps at the
    outputs' scale, from the reference's running max), where plain
    versions that kept P in f32 were up to 1.56·10⁻² off."""
    n_ctx, H, n_kv, hd = 512, 8, 2, 128
    q, k, v = _attn_inputs(S, n_ctx, H, n_kv, hd, seed=S + window)
    qb = _bf16(q)
    jq = jnp.asarray(qb.float().numpy(), jnp.bfloat16)
    jk, jv = (jnp.asarray(_bf16(t).float().numpy(), jnp.bfloat16) for t in (k, v))
    if ring == "int8":
        (jk, jks), (jv, jvs) = quantize_kv_xla(jk), quantize_kv_xla(jv)
        scales = {"k_scale": jks, "v_scale": jvs}
        kq, ks, vq, vs = (torch.from_numpy(np.array(a)) for a in (jk, jks, jv, jvs))
    else:
        scales = {}
        kb, vb = (torch.from_numpy(np.asarray(t, np.float32)).to(torch.bfloat16)
                  for t in (jk, jv))
    for off in offsets:
        if ring == "int8":
            got = flash_attention_int8(qb, kq, vq, ks, vs, off, hd ** -0.5, window)
        else:
            got = flash_attention(qb, kb, vb, off, hd ** -0.5, window)
        ref = np.asarray(j_flash(jq, jk, jv, jnp.int32(off), sm_scale=hd ** -0.5,
                                 sliding_window=window, interpret=True, **scales),
                         np.float32)
        assert np.abs(got.float().numpy() - ref).max() <= 4e-3, (off, window)


def test_dequant_q6_k_matches_reference_kernel():
    """150 blocks: the reference splits them into 256 rows for its Pallas
    kernel (interpret) and a 44-row tail for numpy.  The plain version is
    bit-identical to both parts cast to bf16, and to the codec."""
    nb = 150
    rng = np.random.default_rng(6)
    w = (rng.standard_normal(nb * 256) * 0.05).astype(np.float32)
    raw = quant_q6_k(w)
    got = dequant_q6_k(torch.from_numpy(raw))
    ref = np.array(jnp.asarray(dequant_q6_k_device(raw, nb * 256, interpret=True),
                               jnp.bfloat16).astype(jnp.float32))
    codec = torch.from_numpy(j_dequantize(raw, JGGMLType.Q6_K, nb * 256)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (nb * 256,)
    assert torch.equal(got.view(torch.int16), _bf16(ref).view(torch.int16))
    assert torch.equal(got.view(torch.int16), codec.view(torch.int16))
    with pytest.raises(ValueError):
        dequant_q6_k(torch.from_numpy(raw[:-1]))


def _int8_weights(rng, n=96, k=256):
    """(n, k) f32 weights with an all-zero row and a row of one value."""
    w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
    w[3] = 0.0
    w[5] = 0.25
    return w


def test_make_linear_int8_bit_identical_to_reference():
    w = _int8_weights(np.random.default_rng(11))
    ref = j_make_linear_int8(w)
    got = make_linear_int8(torch.from_numpy(w))
    assert got.kind == "int8" and (got.n_out, got.k_in) == w.shape
    assert got.weight.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert np.array_equal(got.weight.numpy(), np.asarray(ref["q"]))
    assert np.array_equal(got.scale.numpy().view(np.int32),
                          np.asarray(ref["s"]).view(np.int32))
    assert got.scale[3] == 1.0 and not got.weight[3].any()


@pytest.mark.parametrize("B", [1, 17, 256])
def test_int8_linear_bit_identical_to_reference(B):
    """The same x through both int8 linears, an all-zero row of x included."""
    rng = np.random.default_rng(B)
    w = _int8_weights(rng)
    x = rng.standard_normal((B, w.shape[1])).astype(np.float32) * 3.0
    x[0] = 0.0
    xb = _bf16(x)
    got = linear(xb, make_linear_int8(torch.from_numpy(w)))
    ref = j_linear(jnp.asarray(xb.float().numpy(), jnp.bfloat16), j_make_linear_int8(w))
    assert got.dtype == torch.bfloat16 and got.shape == (B, w.shape[0])
    assert torch.equal(got.view(torch.int16),
                       _bf16(np.asarray(ref.astype(jnp.float32))).view(torch.int16))


@pytest.mark.parametrize("gtype", ["Q4_K", "Q5_K", "Q6_K", "Q8_0"])
def test_dequant_f32_output_bit_identical_to_codec(gtype):
    """Each dequant's f32 output (the int8 load's input) against the JAX
    package's codec, bit for bit; its bf16 output is that value rounded."""
    n = 40 * 256
    w = (np.random.default_rng(12).standard_normal(n) * 0.05).astype(np.float32)
    quant = {"Q4_K": quant_q4_k, "Q5_K": quant_q5_k, "Q6_K": quant_q6_k,
             "Q8_0": quant_q8_0}[gtype]
    raw = torch.from_numpy(quant(w))
    fn = getattr(dequant, f"dequant_{gtype.lower()}")
    got = fn(raw, torch.float32)
    codec = j_dequantize(raw.numpy(), JGGMLType[gtype], n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert np.array_equal(got.numpy().view(np.int32), codec.view(np.int32))
    assert torch.equal(fn(raw).view(torch.int16), got.to(torch.bfloat16).view(torch.int16))
    with pytest.raises(ValueError, match="dtype"):
        fn(raw, torch.float16)
