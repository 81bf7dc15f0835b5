"""Port GGUF container and codecs against the JAX package's.

Integer and format work must be bit-identical: the reader's header,
metadata and tensor bytes, the writer's file bytes, the numpy codecs of
all fifteen types (both directions; valid blocks and random bytes), and
the plain Q4_K / Q5_K / Q8_0 → bf16 dequants (what the CUDA kernels are
held to on the card) against the reference codec followed by its bf16 cast
and against the reference's Pallas kernels in interpret mode.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.gguf import GGUFFile as JGGUFFile
from llama_fastapi_k8s_gpu_tpu.gguf import GGUFWriter as JGGUFWriter
from llama_fastapi_k8s_gpu_tpu.gguf import quants as jq
from llama_fastapi_k8s_gpu_tpu.ops.pallas.dequant import (
    dequant_q4_k_device,
    dequant_q5_k_device,
    dequant_q8_0_device,
)
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter, quants
from llama_fastapi_k8s_gpu_tpu_torch.ops.dequant import dequant_q4_k, dequant_q5_k, dequant_q8_0

torch.set_num_threads(1)


#: byte offsets of each block size's f16 scale fields (Q8_0 34, Q4_0 and
#: IQ4_NL 18, Q4_1 20, Q5_0 22, Q5_1 24, Q2_K 84, Q3_K 110, IQ4_XS 136,
#: Q4_K 144, Q5_K 176, Q6_K 210)
_F16_AT = {34: (0,), 18: (0,), 20: (0, 2), 22: (0,), 24: (0, 2), 84: (80, 82),
           110: (108,), 136: (0,), 144: (0, 2), 176: (0, 2), 210: (208,)}

#: (GGML type, block bytes, elements a block) of every type the codecs take
#: beyond F32/F16
_BLOCKS = [("Q4_K", 144, 256), ("Q6_K", 210, 256), ("Q5_K", 176, 256), ("Q8_0", 34, 32),
           ("BF16", 2, 1), ("Q4_0", 18, 32), ("Q4_1", 20, 32), ("Q5_0", 22, 32),
           ("Q5_1", 24, 32), ("Q2_K", 84, 256), ("Q3_K", 110, 256), ("IQ4_NL", 18, 32),
           ("IQ4_XS", 136, 256)]


def _rand_blocks(rng, nb: int, size: int, valid: bool) -> np.ndarray:
    """Random block bytes of ``size`` bytes a block (``_F16_AT``; 2 is a
    BF16 word); ``valid`` pins the f16 scale fields (a BF16 word) to finite
    values (the garbage variant decodes to inf/NaN, also defined)."""
    blk = rng.integers(0, 256, (nb, size), dtype=np.uint8)
    if valid and size == 2:
        words = rng.standard_normal(nb).astype(np.float32).view(np.uint32) >> 16
        blk = words.astype(np.uint16).view(np.uint8).reshape(nb, 2)
    elif valid:
        d = rng.uniform(1e-4, 1e-2, (nb, 2)).astype(np.float16).view(np.uint8)
        for k, off in enumerate(_F16_AT[size]):
            blk[:, off:off + 2] = d[:, 2 * k:2 * k + 2]
    return blk.reshape(-1)


def test_reader_matches_reference(tmp_path):
    path = str(tmp_path / "tiny.gguf")
    write_tiny_llama_gguf(path, quant=JGGMLType.Q4_K, ffn_quant=JGGMLType.Q6_K)
    ref, got = JGGUFFile(path), GGUFFile(path)
    assert (got.version, got.alignment, got.data_offset) == \
        (ref.version, ref.alignment, ref.data_offset)
    assert got.metadata == ref.metadata
    assert list(got.tensors) == list(ref.tensors)
    for name, rt in ref.tensors.items():
        gt = got[name]
        assert (gt.shape, int(gt.ggml_type), gt.offset, gt.nbytes) == \
            (rt.shape, int(rt.ggml_type), rt.offset, rt.nbytes)
        assert np.array_equal(np.asarray(gt.raw()), np.asarray(rt.raw()))


def test_writer_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "a.weight": (rng.standard_normal((8, 256)).astype(np.float32), "Q4_K"),
        "b.weight": (rng.standard_normal((4, 512)).astype(np.float32), "Q6_K"),
        "c.weight": (rng.standard_normal((3, 5)).astype(np.float32), "F16"),
        "n.weight": (rng.standard_normal(7).astype(np.float32), "F32"),
    }
    meta = {"general.architecture": "llama", "llama.block_count": 2,
            "llama.rope.freq_base": 500000.0, "tokenizer.ggml.tokens": ["a", "b"],
            "tokenizer.ggml.token_type": [1, 3], "flag": True, "neg": -5}
    files = []
    for W, T, name in ((JGGUFWriter, JGGMLType, "ref"), (GGUFWriter, GGMLType, "port")):
        p = str(tmp_path / f"{name}.gguf")
        w = W(p)
        for k, v in meta.items():
            w.add_metadata(k, v)
        for n, (a, t) in arrays.items():
            w.add_tensor(n, a, T[t])
        w.add_raw_tensor("r.weight", (256, 1), T["Q4_K"],
                         _rand_blocks(np.random.default_rng(1), 1, 144, True))
        w.write()
        files.append(open(p, "rb").read())
    assert files[0] == files[1]


@pytest.mark.parametrize("gtype", ["F32", "F16", "Q4_K", "Q6_K", "Q5_K", "Q8_0", "BF16",
                                   "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K",
                                   "IQ4_NL", "IQ4_XS"])
def test_codecs_bit_identical(gtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 0.05).astype(np.float32)
    raw = jq.quantize(x, JGGMLType[gtype])
    assert np.array_equal(quants.quantize(x, GGMLType[gtype]), raw)
    assert np.array_equal(quants.dequantize(raw, GGMLType[gtype], x.size),
                          jq.dequantize(raw, JGGMLType[gtype], x.size))


@pytest.mark.parametrize("gtype,size", [(t, size) for t, size, _ in _BLOCKS])
@pytest.mark.parametrize("valid", [True, False])
def test_dequantize_random_blocks(gtype, size, valid):
    rng = np.random.default_rng(size + valid)
    raw = _rand_blocks(rng, 64, size, valid)
    n = 64 * dict((t, e) for t, _, e in _BLOCKS)[gtype]
    assert np.array_equal(quants.dequantize(raw, GGMLType[gtype], n),
                          jq.dequantize(raw, JGGMLType[gtype], n), equal_nan=True)


@pytest.mark.parametrize("gtype", ["Q8_1", "Q8_K", "I8", "I16", "I32", "I64", "F64"])
def test_dequantize_and_quantize_raise_where_the_reference_does(gtype):
    """Outside the fifteen types, each codec table refuses a type exactly
    where the reference's does."""
    for ours, ref, T in ((quants.DEQUANT, jq.DEQUANT, GGMLType),
                         (quants.QUANT, jq.QUANT, JGGMLType)):
        assert T[gtype] not in ours and JGGMLType[gtype] not in ref
    assert set(map(int, quants.DEQUANT)) == set(map(int, jq.DEQUANT))
    assert set(map(int, quants.QUANT)) == set(map(int, jq.QUANT))


@pytest.mark.parametrize("helper", ["q5_high_bits", "q3k_scales", "nearest_iq4nl"])
def test_new_codec_helpers_bit_identical(helper):
    """The helpers of the new codecs, on random inputs: Q5_0/Q5_1's fifth
    bits and packer, Q3_K's scale unpack and pack, IQ4's nearest value."""
    rng = np.random.default_rng(11)
    if helper == "q5_high_bits":
        qh = rng.integers(0, 256, (50, 4), dtype=np.uint8)
        for a, b in zip(quants._q5_high_bits(qh), jq._q5_high_bits(qh)):
            assert np.array_equal(a, b)
        q = rng.integers(0, 32, (50, 32), dtype=np.uint8)
        d = rng.integers(0, 256, (50, 2), dtype=np.uint8)
        assert np.array_equal(quants._pack_q5(q, d, d), jq._pack_q5(q, d, d))
        assert np.array_equal(quants._pack_q5(q, d, None), jq._pack_q5(q, d, None))
    elif helper == "q3k_scales":
        sb = rng.integers(0, 256, (50, 12), dtype=np.uint8)
        assert np.array_equal(quants._q3k_unpack_scales(sb), jq._q3k_unpack_scales(sb))
        sc = rng.integers(0, 64, (50, 16), dtype=np.uint8)
        assert np.array_equal(quants._q3k_pack_scales(sc), jq._q3k_pack_scales(sc))
    else:
        x = (rng.standard_normal(4096) * 80).astype(np.float32)
        assert np.array_equal(quants._nearest_iq4nl(x), jq._nearest_iq4nl(x))
        assert np.array_equal(quants.KVALUES_IQ4NL, jq.KVALUES_IQ4NL)


def test_unpack_scale_min_k4():
    s = np.random.default_rng(4).integers(0, 256, (100, 12), dtype=np.uint8)
    for a, b in zip(quants.unpack_scale_min_k4(s), jq.unpack_scale_min_k4(s)):
        assert np.array_equal(a, b)


def test_unsupported_type_raises():
    """Q8_K (a llama.cpp intermediate, never a file's tensor type) is
    decoded by neither package: both refuse it in both directions."""
    for deq, T in ((quants.dequantize, GGMLType), (jq.dequantize, JGGMLType)):
        with pytest.raises(NotImplementedError):
            deq(np.zeros(292, np.uint8), T.Q8_K, 256)
    for q, T in ((quants.quantize, GGMLType), (jq.quantize, JGGMLType)):
        with pytest.raises(NotImplementedError):
            q(np.zeros(256, np.float32), T.Q8_K)


@pytest.mark.parametrize("nb", [1, 300])
def test_plain_dequant_q4_k_bit_identical_to_reference_bf16(nb):
    """The kernel's plain version: flat Q4_K bytes → bf16, bit for bit the
    numpy codec cast to bf16 (the cast the JAX load path applies) and the
    reference's Pallas kernel in interpret mode."""
    raw = _rand_blocks(np.random.default_rng(nb), nb, 144, True)
    n = nb * 256
    got = dequant_q4_k(torch.from_numpy(raw)).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(jq.dequantize(raw, JGGMLType.Q4_K, n),
                                  jnp.bfloat16)).view(np.int16)
    assert got.shape == (n,)
    assert np.array_equal(got, want)
    pallas = np.asarray(dequant_q4_k_device(raw, n, jnp.bfloat16, interpret=True))
    assert np.array_equal(got, pallas.view(np.int16))


# the reference's Pallas tile is 256 rows (ops/pallas/dequant.py _TILE) and
# its codec decodes the tail: Q5_K, one row per super-block, 300 = 256 + 44;
# Q8_0, four blocks a row, 1101 = 4·256 + 4·19 + 1
@pytest.mark.parametrize("gtype,nb", [("Q5_K", 1), ("Q5_K", 300), ("Q8_0", 3),
                                      ("Q8_0", 1101)])
def test_plain_dequant_q5_k_and_q8_0_bit_identical_to_reference_bf16(gtype, nb):
    """As the Q4_K case: flat bytes → bf16, bit for bit the numpy codec cast
    to bf16 and the reference's Pallas kernel in interpret mode, over a
    tail that is not a whole Pallas tile."""
    size, elems, port, pallas_fn = {
        "Q5_K": (176, 256, dequant_q5_k, dequant_q5_k_device),
        "Q8_0": (34, 32, dequant_q8_0, dequant_q8_0_device)}[gtype]
    raw = _rand_blocks(np.random.default_rng(nb), nb, size, True)
    n = nb * elems
    got = port(torch.from_numpy(raw)).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(jq.dequantize(raw, JGGMLType[gtype], n),
                                  jnp.bfloat16)).view(np.int16)
    assert got.shape == (n,)
    assert np.array_equal(got, want)
    pallas = np.asarray(pallas_fn(raw, n, jnp.bfloat16, interpret=True))
    assert np.array_equal(got, pallas.view(np.int16))


def test_dequant_q4_k_rejects_partial_blocks():
    with pytest.raises(ValueError):
        dequant_q4_k(torch.zeros(100, dtype=torch.uint8))
    with pytest.raises(ValueError):
        dequant_q5_k(torch.zeros(144, dtype=torch.uint8))
    with pytest.raises(ValueError):
        dequant_q8_0(torch.zeros(35, dtype=torch.uint8))
