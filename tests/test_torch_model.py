"""The port's model against the JAX reference's on the same weights.

- tiny Llama, bf16 weights: the JAX param pytree crosses over through
  ``from_jax_params``; ``forward`` logits agree to rel-dev ≤ 1e-2 (bf16
  activations rounded at the same steps, sums in another order) and 16
  greedy decode tokens are identical — over the bf16 KV ring, and over the
  int8 ring against the reference's int8 ring (never against bf16: the
  reference's own int8-vs-bf16 greedy run parts at one seed, ROADMAP C.3);
- one Q4_K + Q6_K, one Q5_K + Q6_K, one Q8_0 and one Q6_K file at dim 2048
  (1 layer, 16 heads of 128, ffn 2048), loaded by both: the reference's
  fused Pallas path (interpret) with its flash kernel against the port's
  fused + flash plain path, logits rel-dev ≤ 2·10⁻², and the port within
  5·10⁻³ of the reference's exact bf16 load (the Q6_K file with the int8
  KV cache on all three);
- the int8 cache's layout, dtypes and byte count against the reference's;
- which names fuse, and as what, in files that mix types per layer, against
  the reference's rule; ``token_embd`` of each type with a dequant kernel
  against the codec;
- ``load_params(fmt="int8")`` leaf for leaf against the reference's int8
  load (``on_device=False``: its numpy codecs and requantizer), bit for
  bit — the port expands the blocks through its dequant kernels' f32
  output (on the CPU, their plain versions) and requantizes with torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.gguf import GGUFFile as JGGUFFile
from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.models.llama import cache_nbytes as j_cache_nbytes
from llama_fastapi_k8s_gpu_tpu.models.llama import decode_step as j_decode_step
from llama_fastapi_k8s_gpu_tpu.models.llama import forward as j_forward
from llama_fastapi_k8s_gpu_tpu.models.llama import init_cache as j_init_cache
from llama_fastapi_k8s_gpu_tpu.models.params import load_params as j_load_params
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter, quants
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import (
    cache_nbytes,
    decode_step,
    forward,
    init_cache,
)
from llama_fastapi_k8s_gpu_tpu_torch.models.params import from_jax_params, load_params

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree, jnp.float32))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("model") / "tiny.gguf")
    jcfg = write_tiny_llama_gguf(path)
    jparams = j_load_params(JGGUFFile(path), jcfg, fmt="bf16", on_device=False)
    cfg = ModelConfig.from_gguf(GGUFFile(path), n_ctx=jcfg.n_ctx)
    return jcfg, jparams, cfg, from_jax_params(_numpy_tree(jparams), cfg, device="cpu")


@pytest.mark.parametrize("window", [0, 8])
def test_forward_logits_match(tiny, window):
    jcfg, jparams, cfg, params = tiny
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    cfg = dataclasses.replace(cfg, sliding_window=window)
    toks = np.random.default_rng(window).integers(0, cfg.vocab_size, 24)
    ref, _ = j_forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jnp.int32(0),
                       j_init_cache(jcfg), return_all=True)
    with torch.inference_mode():
        got = forward(params, cfg, torch.from_numpy(toks), 0, init_cache(cfg, CPU),
                      return_all=True)
    assert got.shape == (24, cfg.vocab_size)
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-2


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match_int8_kv(tiny, impl):
    """The int8 KV ring on both sides: the score-matrix path with the
    scales folded in, and the flash path (the reference's Pallas kernel in
    interpret mode against the port's int8 flash plain version)."""
    jcfg, jparams, cfg, params = tiny
    jcfg = dataclasses.replace(jcfg, kv_dtype="int8",
                               attn_impl={"xla": "xla", "flash": "pallas"}[impl])
    cfg = dataclasses.replace(cfg, kv_dtype="int8", attn_impl=impl)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, 24)
    ref, _ = j_forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jnp.int32(0),
                       j_init_cache(jcfg), return_all=True)
    with torch.inference_mode():
        got = forward(params, cfg, torch.from_numpy(toks), 0, init_cache(cfg, CPU),
                      return_all=True)
    assert got.shape == (24, cfg.vocab_size)
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-2


def test_int8_cache_layout_and_bytes_match_reference(tiny):
    jcfg, _, cfg, _ = tiny
    for kv_dtype in ("bf16", "int8"):
        jc = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
        c = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        jcache, cache = j_init_cache(jc), init_cache(c, CPU)
        assert set(cache) == set(jcache)
        for name, leaf in cache.items():
            assert tuple(leaf.shape) == jcache[name].shape, name
            assert str(leaf.dtype).split(".")[-1] == str(jcache[name].dtype), name
            assert not leaf.any()
        live = sum(t.numel() * t.element_size() for t in cache.values())
        assert cache_nbytes(c) == j_cache_nbytes(jc) == live, kv_dtype
    with pytest.raises(ValueError, match="kv_dtype"):
        init_cache(dataclasses.replace(cfg, kv_dtype="fp8"), CPU)


def _greedy_16_identical(tiny, kv_dtype: str) -> None:
    """Prefill 12 tokens, then 16 greedy steps on both sides.  A flip is
    allowed only where the reference's own top-2 margin is under the
    logits tolerance — and then the run is a finding for ROADMAP, not a
    silent pass; no flip occurs on this model."""
    jcfg, jparams, cfg, params = tiny
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 12)
    jcache = j_init_cache(jcfg)
    jl, jcache = j_forward(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                           jnp.int32(0), jcache)
    cache = init_cache(cfg, CPU)
    with torch.inference_mode():
        tl = forward(params, cfg, torch.from_numpy(prompt), 0, cache)
    j_step = jax.jit(j_decode_step, static_argnums=1)
    j_tokens, t_tokens = [], []
    for step in range(16):
        jl_np = np.asarray(jl)
        jt, tt = int(jl_np.argmax()), int(tl.argmax())
        if jt != tt:
            top2 = np.sort(jl_np)[-2:]
            margin = (top2[1] - top2[0]) / np.abs(jl_np).max()
            pytest.fail(f"greedy flip at step {step}: top-2 margin {margin:.2e} "
                        f"(under the 1e-2 tolerance: {margin < 1e-2})")
        j_tokens.append(jt)
        t_tokens.append(tt)
        pos = len(prompt) + step
        jl, jcache = j_step(jparams, jcfg, jnp.int32(jt), jnp.int32(pos), jcache)
        with torch.inference_mode():
            tl = decode_step(params, cfg, torch.tensor(tt), pos, cache)
    assert t_tokens == j_tokens


def test_greedy_decode_16_tokens_identical(tiny):
    _greedy_16_identical(tiny, "bf16")


def test_greedy_decode_16_tokens_identical_int8_kv(tiny):
    """The int8 ring on both sides: the write-quantize of every step and
    the scale-folded decode attention."""
    _greedy_16_identical(tiny, "int8")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_rope_table_computed_once_per_forward(tiny, monkeypatch, kv_dtype):
    """The per-layer path computes a pass's RoPE table once, in
    ``forward``, and every layer rotates from it (over the int8 ring the KV
    write rotates k from it too): a prompt pass and a decode step of the
    two-layer tiny model call ``rope_cos_sin`` once each."""
    import llama_fastapi_k8s_gpu_tpu_torch.models.llama as llama

    _, _, cfg, params = tiny
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    assert cfg.n_layers == 2
    calls = []
    table = llama.rope_cos_sin

    def counted(*args):
        calls.append(args[0].shape[0])
        return table(*args)

    monkeypatch.setattr(llama, "rope_cos_sin", counted)
    cache = init_cache(cfg, CPU)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, 12))
    with torch.inference_mode():
        forward(params, cfg, toks, 0, cache)
        assert calls == [12]
        lg = decode_step(params, cfg, torch.tensor(5), 12, cache)
    assert calls == [12, 1] and torch.isfinite(lg).all()


def _fused_file_matches_reference(tmp_path, quant, ffn_quant, formats,
                                  kv_dtype="bf16"):
    """A dim-2048 file with ``quant`` attention and ``ffn_quant`` FFN
    linears: the port's fused + flash forward against the reference's
    (``fmt="q4k"``, Pallas in interpret mode) and its exact bf16 load, all
    three over a ``kv_dtype`` KV ring."""
    jcfg = JModelConfig(vocab_size=263, dim=2048, n_layers=1, n_heads=16,
                        n_kv_heads=4, ffn_dim=2048, n_ctx=256)
    path = str(tmp_path / "fused.gguf")
    jcfg = write_tiny_llama_gguf(path, cfg=jcfg, quant=quant, ffn_quant=ffn_quant)
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    jgf = JGGUFFile(path)
    jcfg_p = dataclasses.replace(jcfg, attn_impl="pallas")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, 64)
    jtok = jnp.asarray(toks, jnp.int32)
    ref, _ = j_forward(j_load_params(jgf, jcfg_p, fmt="q4k", on_device=False),
                       jcfg_p, jtok, jnp.int32(0), j_init_cache(jcfg_p),
                       return_all=True)
    exact, _ = j_forward(j_load_params(jgf, jcfg, fmt="bf16", on_device=False),
                         jcfg, jtok, jnp.int32(0), j_init_cache(jcfg), return_all=True)

    gf = GGUFFile(path)
    cfg = dataclasses.replace(ModelConfig.from_gguf(gf, n_ctx=256), attn_impl="flash",
                              kv_dtype=kv_dtype)
    params = load_params(gf, cfg, "q4k", device="cpu")
    assert params.formats() == formats
    with torch.inference_mode():
        got = forward(params, cfg, torch.from_numpy(toks), 0, init_cache(cfg, CPU),
                      return_all=True).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, np.asarray(ref)) <= 2e-2
    assert _rel(got, np.asarray(exact)) <= 5e-3


def test_q4km_fused_flash_path_matches_reference(tmp_path):
    _fused_file_matches_reference(
        tmp_path, JGGMLType.Q4_K, JGGMLType.Q6_K,
        {"wq": "q4k", "wk": "q4k", "wv": "q4k", "wo": "q4k", "w_gate": "q6k",
         "w_up": "q6k", "w_down": "q6k", "output": "bf16"})


@pytest.mark.parametrize("layout", ["q5km", "q8_0"])
def test_q5km_and_q8_0_fused_flash_path_matches_reference(tmp_path, layout):
    """Q5_K (+ Q6_K FFN) and Q8_0 files, every linear fused; the reference
    runs its default Q5_K layout (``pre``) and its Q8_0 kernel."""
    if layout == "q5km":
        quant, ffn_quant = JGGMLType.Q5_K, JGGMLType.Q6_K
        formats = {"wq": "q5k", "wk": "q5k", "wv": "q5k", "wo": "q5k",
                   "w_gate": "q6k", "w_up": "q6k", "w_down": "q6k"}
    else:
        quant, ffn_quant = JGGMLType.Q8_0, None
        formats = dict.fromkeys(("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
                                "q8")
    _fused_file_matches_reference(tmp_path, quant, ffn_quant,
                                  {**formats, "output": "bf16"})


def test_q6k_file_int8_kv_fused_flash_path_matches_reference(tmp_path):
    """Every linear Q6_K, the int8 KV cache: the reference's fused Q6_K
    kernel and int8 flash (interpret) against the port's fused Q6_K and
    int8 flash plain versions."""
    _fused_file_matches_reference(
        tmp_path, JGGMLType.Q6_K, None,
        {**dict.fromkeys(("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"), "q6k"),
         "output": "bf16"}, kv_dtype="int8")


def _write_file(path: str, cfg: ModelConfig, types, seed: int = 0) -> None:
    """A Llama GGUF of ``cfg``'s shapes, random weights from ``seed``;
    ``types(name, layer)`` gives each linear's GGML type (``layer`` is None
    for token_embd and output)."""
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

    kv_dim = cfg.n_kv_heads * cfg.head_dim
    shapes = {"attn_q": (cfg.dim, cfg.dim), "attn_k": (kv_dim, cfg.dim),
              "attn_v": (kv_dim, cfg.dim), "attn_output": (cfg.dim, cfg.dim),
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


#: the reference's fused layouts, by the key of their value plane
_J_KINDS = {"qs": "q4k", "q5p": "q5k", "q5s": "q5k", "q4": "q6k", "q6p": "q6k",
            "q8": "q8"}


def test_mixed_names_fuse_as_the_reference_decides(tmp_path):
    """A name mixing Q4_K and Q5_K promotes to Q5_K, requantized with the
    Q5_K quantizer; a name mixing Q8_0 with a K-quant does not fuse (int8 in
    the reference, bf16 in the port until its int8 format lands); uniform
    names keep their type.  Each name fuses as the reference's load does."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import _fused_names

    cfg = ModelConfig(vocab_size=16, dim=2048, n_layers=2, n_heads=16, n_kv_heads=4,
                      ffn_dim=2048, n_ctx=16)
    mixed = {"ffn_down": [GGMLType.Q4_K, GGMLType.Q5_K],
             "attn_v": [GGMLType.Q8_0, GGMLType.Q4_K],
             "attn_k": [GGMLType.Q8_0, GGMLType.Q8_0]}
    path = str(tmp_path / "mixed.gguf")
    _write_file(path, cfg, lambda n, i: GGMLType.F16 if i is None
                else mixed.get(n, [GGMLType.Q4_K] * 2)[i])
    gf = GGUFFile(path)
    names = _fused_names(gf, cfg)
    assert names["ffn_down"] == GGMLType.Q5_K and "attn_v" not in names
    params = load_params(gf, cfg, "q4k", device="cpu")
    formats = params.formats()
    assert formats == {"wq": "q4k", "wk": "q8", "wv": "bf16", "wo": "q4k",
                       "w_gate": "q4k", "w_up": "q4k", "w_down": "q5k",
                       "output": "bf16"}
    src = gf["blk.0.ffn_down.weight"].astype_f32()
    assert np.array_equal(params.layers[0].w_down.weight.numpy().reshape(-1),
                          quants.quant_q5_k(src.reshape(-1)))
    jcfg = JModelConfig(vocab_size=16, dim=2048, n_layers=2, n_heads=16,
                        n_kv_heads=4, ffn_dim=2048, n_ctx=16)
    jlayers = j_load_params(JGGUFFile(path), jcfg, fmt="q4k", on_device=False)["layers"]
    for name, kind in formats.items():
        if name == "output":
            continue
        keys = set(jlayers[name]) & set(_J_KINDS)
        jkind = _J_KINDS[keys.pop()] if keys else "bf16"
        assert jkind == kind, (name, sorted(jlayers[name]))


@pytest.mark.parametrize("gtype", ["Q4_K", "Q5_K", "Q6_K", "Q8_0"])
def test_token_embd_dequant_matches_codec(tmp_path, gtype):
    """``token_embd`` in each type with a dequant kernel expands (on the
    CPU: through the kernel's plain version) to the codec's values in
    bf16, bit for bit."""
    cfg = ModelConfig(vocab_size=24, dim=512, n_layers=1, n_heads=4, n_kv_heads=4,
                      ffn_dim=256, n_ctx=16)
    path = str(tmp_path / "emb.gguf")
    _write_file(path, cfg, lambda n, i: GGMLType[gtype] if n == "token_embd"
                else GGMLType.F16)
    gf = GGUFFile(path)
    params = load_params(gf, cfg, "bf16", device="cpu")
    te = gf["token_embd.weight"]
    want = torch.from_numpy(te.astype_f32()).reshape(24, 512).to(torch.bfloat16)
    assert params.tok_emb.dtype == torch.bfloat16
    assert torch.equal(params.tok_emb.view(torch.int16), want.view(torch.int16))


def test_from_jax_params_refuses_fused_layouts(tiny):
    jcfg, jparams, cfg, _ = tiny
    tree = _numpy_tree(jparams)
    tree["layers"]["wq"] = {"qs": np.zeros(1), "sm": np.zeros(1)}
    with pytest.raises(ValueError, match="wq"):
        from_jax_params(tree, cfg, device="cpu")


def test_mixed_k_quant_name_promotes_to_q6k(tmp_path):
    """A name whose layers mix Q4_K and Q6_K (llama.cpp's Q4_K_M recipe for
    attn_v / ffn_down) serves fused as Q6_K: the Q4_K layers are
    requantized onto the finer grid, and a non-fusable name takes bf16."""
    from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGMLType, GGUFWriter
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import _fused_names

    path = str(tmp_path / "mixed.gguf")
    cfg = ModelConfig(vocab_size=16, dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
                      ffn_dim=256, n_ctx=16)
    rng = np.random.default_rng(0)
    w = GGUFWriter(path)
    for k, v in {"general.architecture": "llama", "llama.block_count": 2,
                 "llama.embedding_length": 256, "llama.feed_forward_length": 256,
                 "llama.attention.head_count": 2, "llama.vocab_size": 16}.items():
        w.add_metadata(k, v)

    def t(name, shape, gtype):
        w.add_tensor(name, rng.standard_normal(shape).astype(np.float32) * 0.05, gtype)

    t("token_embd.weight", (16, 256), GGMLType.F16)
    for i in range(2):
        for n in ("attn_q", "attn_k", "attn_output", "ffn_gate", "ffn_up"):
            t(f"blk.{i}.{n}.weight", (256, 256), GGMLType.Q4_K)
        t(f"blk.{i}.attn_v.weight", (256, 256), GGMLType.F16)
        t(f"blk.{i}.ffn_down.weight", (256, 256), [GGMLType.Q4_K, GGMLType.Q6_K][i])
        t(f"blk.{i}.attn_norm.weight", (256,), GGMLType.F32)
        t(f"blk.{i}.ffn_norm.weight", (256,), GGMLType.F32)
    t("output_norm.weight", (256,), GGMLType.F32)
    t("output.weight", (16, 256), GGMLType.Q6_K)
    w.write()
    gf = GGUFFile(path)
    assert _fused_names(gf, cfg)["ffn_down"] == GGMLType.Q6_K
    params = load_params(gf, cfg, "q4k", device="cpu")
    assert params.formats()["w_down"] == "q6k"
    assert params.formats()["wv"] == "bf16"
    assert params.formats()["output"] == "q6k"
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32)).to(torch.bfloat16)
    src = gf["blk.0.ffn_down.weight"].astype_f32()
    got = params.layers[0].w_down(x).float().numpy()
    assert _rel(got, x.float().numpy() @ src.T) <= 2e-2


@pytest.mark.parametrize("layout", ["q4k_q6k", "q8_0"])
def test_load_params_int8_matches_reference_leaf_for_leaf(tmp_path, layout):
    """A dim-256 Q4_K (+ Q6_K FFN) file and the reference's default tiny
    Q8_0 file: every int8 linear's ``q`` and ``s``, the norms and the
    embedding are the reference's bits."""
    path = str(tmp_path / "int8.gguf")
    if layout == "q8_0":
        jcfg = write_tiny_llama_gguf(path)
    else:
        jcfg = write_tiny_llama_gguf(
            path, cfg=JModelConfig(vocab_size=263, dim=256, n_layers=2, n_heads=2,
                                   n_kv_heads=1, ffn_dim=512, n_ctx=64),
            quant=JGGMLType.Q4_K, ffn_quant=JGGMLType.Q6_K)
    ref = j_load_params(JGGUFFile(path), jcfg, fmt="int8", on_device=False)
    cfg = ModelConfig.from_gguf(GGUFFile(path), n_ctx=jcfg.n_ctx)
    got = load_params(GGUFFile(path), cfg, "int8", device="cpu")
    assert set(got.formats().values()) == {"int8"}

    def same(t: torch.Tensor, a) -> bool:
        a = np.asarray(jnp.asarray(a).astype(jnp.float32))
        return np.array_equal(t.float().numpy().view(np.int32), a.view(np.int32))

    def same_linear(lin, leaf) -> bool:
        return (lin.weight.dtype == torch.int8 and lin.scale.dtype == torch.float32
                and same(lin.weight, leaf["q"]) and same(lin.scale, leaf["s"]))

    assert got.tok_emb.dtype == torch.bfloat16 and same(got.tok_emb, ref["tok_emb"])
    assert same(got.out_norm, ref["out_norm"])
    assert same_linear(got.output, ref["output"])
    for i, layer in enumerate(got.layers):
        for name in ("attn_norm", "ffn_norm"):
            assert same(getattr(layer, name), ref["layers"][name][i]), (i, name)
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            leaf = {k: v[i] for k, v in ref["layers"][name].items()}
            assert same_linear(getattr(layer, name), leaf), (i, name)
