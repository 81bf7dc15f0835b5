"""Files in every tensor type the reference decodes without a kernel,
loaded by the port against the JAX package.

For F16 and each of BF16, Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, IQ4_NL and
IQ4_XS, a tiny Llama file written by the JAX writer (dim 256 and ffn 512,
whole super-blocks for the K-quants and IQ4_XS) with every linear in that
type:

- the port's ``bf16`` load equals the JAX package's bf16 load bit for bit,
  leaf for leaf, through ``from_jax_params``' layout (the host codec's f32
  cast to bf16; BF16 by a view of its raw words);
- ``forward`` logits agree within the model tests' 1e-2 rel-dev;
- the ``int8`` load equals the JAX int8 load (``on_device=False``) bit for
  bit: the same codec f32, requantized per row;
- under ``q4k`` no linear fuses (no fused kernel takes these types).

A ``token_embd`` of each type expands to the codec's values in bf16, and a
file whose names mix the new types with K-quants serves those names bf16
under ``q4k``, as the port's fusing rule says.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.gguf import GGUFFile as JGGUFFile
from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.models.llama import forward as j_forward
from llama_fastapi_k8s_gpu_tpu.models.llama import init_cache as j_init_cache
from llama_fastapi_k8s_gpu_tpu.models.params import load_params as j_load_params
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward, init_cache
from llama_fastapi_k8s_gpu_tpu_torch.models.params import (
    LOOP_LINEARS,
    from_jax_params,
    load_params,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")

#: the types the host codec decodes for the load (no kernel), and F16
TYPES = ["F16", "BF16", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "IQ4_NL", "IQ4_XS"]
JCFG = JModelConfig(vocab_size=263, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                    ffn_dim=512, n_ctx=64)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's raw bits (bf16 as int16, f32 as int32)."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", params=TYPES)
def typed(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("types") / f"{request.param}.gguf")
    jcfg = write_tiny_llama_gguf(path, cfg=JCFG, quant=JGGMLType[request.param])
    gf = GGUFFile(path)
    assert {gf[f"blk.0.{n}.weight"].ggml_type for n in ("attn_q", "ffn_down")} == \
        {GGMLType[request.param]}
    return request.param, path, jcfg, ModelConfig.from_gguf(gf, n_ctx=jcfg.n_ctx)


def test_bf16_load_bit_identical_to_reference(typed):
    gtype, path, jcfg, cfg = typed
    ref = from_jax_params(_numpy_tree(
        j_load_params(JGGUFFile(path), jcfg, fmt="bf16", on_device=False)), cfg, device="cpu")
    got = load_params(GGUFFile(path), cfg, "bf16", device="cpu")
    assert set(got.formats().values()) == {"bf16"}
    pairs = [(got.tok_emb, ref.tok_emb), (got.out_norm, ref.out_norm),
             (got.output.weight, ref.output.weight)]
    for a, b in zip(got.layers, ref.layers):
        pairs += [(a.attn_norm, b.attn_norm), (a.ffn_norm, b.ffn_norm)]
        pairs += [(getattr(a, n).weight, getattr(b, n).weight) for n in LOOP_LINEARS]
    for mine, theirs in pairs:
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        assert np.array_equal(_bits(mine), _bits(theirs)), gtype


def test_logits_within_the_model_tolerance(typed):
    gtype, path, jcfg, cfg = typed
    jparams = j_load_params(JGGUFFile(path), jcfg, fmt="bf16", on_device=False)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 24)
    ref, _ = j_forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jnp.int32(0),
                       j_init_cache(jcfg), return_all=True)
    params = load_params(GGUFFile(path), cfg, "bf16", device="cpu")
    with torch.inference_mode():
        got = forward(params, cfg, torch.from_numpy(toks), 0, init_cache(cfg, CPU),
                      return_all=True).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, np.asarray(ref)) <= 1e-2, gtype


def test_int8_load_bit_identical_to_reference(typed):
    gtype, path, jcfg, cfg = typed
    ref = j_load_params(JGGUFFile(path), jcfg, fmt="int8", on_device=False)
    got = load_params(GGUFFile(path), cfg, "int8", device="cpu")
    assert set(got.formats().values()) == {"int8"}

    def same(t: torch.Tensor, a) -> bool:
        a = np.asarray(jnp.asarray(a).astype(jnp.float32))
        return np.array_equal(t.float().numpy().view(np.int32), a.view(np.int32))

    for i, layer in enumerate(got.layers):
        for name in LOOP_LINEARS:
            lin = getattr(layer, name)
            leaf = ref["layers"][name]
            assert lin.weight.dtype == torch.int8, (gtype, name)
            assert same(lin.weight, leaf["q"][i]) and same(lin.scale, leaf["s"][i]), \
                (gtype, i, name)
    assert same(got.tok_emb, ref["tok_emb"])


def test_q4k_format_fuses_none_of_them(typed):
    """No fused kernel takes these types: under ``q4k`` every linear of the
    file serves bf16 (the F16 head too), with the bf16 load's bits."""
    gtype, path, _, cfg = typed
    got = load_params(GGUFFile(path), cfg, "q4k", device="cpu")
    assert set(got.formats().values()) == {"bf16"}, gtype
    plain = load_params(GGUFFile(path), cfg, "bf16", device="cpu")
    assert torch.equal(got.layers[1].w_down.weight.view(torch.int16),
                       plain.layers[1].w_down.weight.view(torch.int16))


def _write(path: str, cfg: ModelConfig, types, seed: int = 0) -> None:
    """A Llama GGUF of ``cfg``'s shapes with ``types(name, layer)`` for each
    weight (``layer`` None for token_embd and output)."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    for k, v in {"general.architecture": "llama", "llama.block_count": cfg.n_layers,
                 "llama.embedding_length": cfg.dim,
                 "llama.feed_forward_length": cfg.ffn_dim,
                 "llama.attention.head_count": cfg.n_heads,
                 "llama.attention.head_count_kv": cfg.n_kv_heads,
                 "llama.vocab_size": cfg.vocab_size}.items():
        w.add_metadata(k, v)

    def t(name, shape, gtype):
        w.add_tensor(name, rng.standard_normal(shape).astype(np.float32)
                     * shape[-1] ** -0.5, gtype)

    kv = cfg.n_kv_heads * cfg.head_dim
    shapes = {"attn_q": (cfg.dim, cfg.dim), "attn_k": (kv, cfg.dim),
              "attn_v": (kv, cfg.dim), "attn_output": (cfg.dim, cfg.dim),
              "ffn_gate": (cfg.ffn_dim, cfg.dim), "ffn_up": (cfg.ffn_dim, cfg.dim),
              "ffn_down": (cfg.dim, cfg.ffn_dim)}
    t("token_embd.weight", (cfg.vocab_size, cfg.dim), types("token_embd", None))
    for i in range(cfg.n_layers):
        for n, shape in shapes.items():
            t(f"blk.{i}.{n}.weight", shape, types(n, i))
        t(f"blk.{i}.attn_norm.weight", (cfg.dim,), GGMLType.F32)
        t(f"blk.{i}.ffn_norm.weight", (cfg.dim,), GGMLType.F32)
    t("output_norm.weight", (cfg.dim,), GGMLType.F32)
    t("output.weight", (cfg.vocab_size, cfg.dim), types("output", None))
    w.write()


CFG = ModelConfig(vocab_size=24, dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
                  ffn_dim=512, n_ctx=16)


@pytest.mark.parametrize("gtype", TYPES[1:])
def test_token_embd_expands_to_the_codec(tmp_path, gtype):
    """``token_embd`` in each new type expands to the codec's values in
    bf16, bit for bit (BF16 by a view of its raw words)."""
    path = str(tmp_path / "emb.gguf")
    _write(path, CFG, lambda n, i: GGMLType[gtype] if n == "token_embd" else GGMLType.F16)
    gf = GGUFFile(path)
    params = load_params(gf, CFG, "bf16", device="cpu")
    want = torch.from_numpy(np.asarray(gf["token_embd.weight"].astype_f32(), np.float32)
                            ).to(torch.bfloat16)
    assert params.tok_emb.dtype == torch.bfloat16 and params.tok_emb.shape == (24, 256)
    assert torch.equal(params.tok_emb.view(torch.int16), want.view(torch.int16))


def test_names_mixing_new_types_take_bf16_under_q4k(tmp_path):
    """attn_q mixes Q4_K with Q3_K, ffn_down Q6_K with IQ4_XS, attn_v is
    Q4_0 in every layer, output is Q2_K: each takes bf16 under ``q4k``;
    the uniform K-quant names keep their fused kinds."""
    mixed = {"attn_q": [GGMLType.Q4_K, GGMLType.Q3_K],
             "ffn_down": [GGMLType.Q6_K, GGMLType.IQ4_XS],
             "attn_v": [GGMLType.Q4_0, GGMLType.Q4_0]}
    path = str(tmp_path / "mixed.gguf")

    def types(n, i):
        if i is None:
            return GGMLType.Q2_K if n == "output" else GGMLType.BF16
        return mixed.get(n, [GGMLType.Q4_K] * 2)[i]

    _write(path, CFG, types)
    gf = GGUFFile(path)
    params = load_params(gf, CFG, "q4k", device="cpu")
    assert params.formats() == {"wq": "bf16", "wk": "q4k", "wv": "bf16", "wo": "q4k",
                                "w_gate": "q4k", "w_up": "q4k", "w_down": "bf16",
                                "output": "bf16"}
    for i, t in enumerate(mixed["ffn_down"]):
        want = torch.from_numpy(np.asarray(gf[f"blk.{i}.ffn_down.weight"].astype_f32(),
                                           np.float32))
        assert torch.equal(params.layers[i].w_down.weight.view(torch.int16),
                           want.to(torch.bfloat16).view(torch.int16)), t
    with torch.inference_mode():
        lg = forward(params, CFG, torch.arange(8), 0, init_cache(CFG, CPU))
    assert torch.isfinite(lg).all()
