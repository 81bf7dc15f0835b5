"""The port's decode step over a device-resident state, on the CPU.

- **Parity with the reference.**  The tiny Llama (bf16 ring, then int8
  ring) and the tiny Mistral (sliding window 16): a 12-token prompt, the
  first sample, then two chunks of 8 through the port's
  ``generate_chunk`` and the JAX package's ``generate_chunk_jit`` at
  temperature 0 (the default penalties on, so the window matters).
  Greedy tokens, ``pos``, ``wpos`` and ``window`` are identical, with one
  exception stated in :func:`_compare_tokens`: the reference's own tie at
  the bf16-rounding scale.  Cache leaves: bf16 within 10⁻² rel-dev (the
  logits tolerance of tests/test_torch_model.py) and two bf16 steps of the
  leaf's largest magnitude an element — the two sides round the same
  steps to bf16 and sum in another order; int8 codes within one (a code
  moves where a bf16 input of its row moved a step: about a third of the
  written rows here; with equal inputs the write is bit-exact,
  tests/test_torch_ops.py), scales and the dequantized ring within 10⁻².
- **A proxy for CUDA-graph capture.**  The step's aten ops, recorded by a
  ``TorchDispatchMode`` at positions 5 and 900 of a 1024-slot ring: the
  same ops with the same shapes and the same non-tensor arguments, no
  host read (``aten._local_scalar_dense``, or ``aten.item`` as inference
  mode records ``.item()``) and no tensor made from a host value
  (``aten.lift_fresh``: a copy to the card, which a capture refuses).  Each kernel wrapper counts
  as one op (its arguments recorded; its plain version, which the card
  does not run, is not).
- **The kernels' plain versions take the slot as a tensor**:
  ``kv_quantize_plain`` writes the ring the slice assignment wrote, and
  ``decode_loop_plain`` the ring of the per-layer forward at the host
  slot, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax
import jax.numpy as jnp

from llama_fastapi_k8s_gpu_tpu.gguf import GGUFFile as JGGUFFile
from llama_fastapi_k8s_gpu_tpu.models.generate import generate_chunk_jit as j_generate_chunk_jit
from llama_fastapi_k8s_gpu_tpu.models.generate import sample_jit as j_sample_jit
from llama_fastapi_k8s_gpu_tpu.models.llama import decode_step as j_decode_step
from llama_fastapi_k8s_gpu_tpu.models.llama import forward as j_forward
from llama_fastapi_k8s_gpu_tpu.models.llama import init_cache as j_init_cache
from llama_fastapi_k8s_gpu_tpu.models.params import load_params as j_load_params
from llama_fastapi_k8s_gpu_tpu.sampling.sample import SamplingParams as JSamplingParams
from llama_fastapi_k8s_gpu_tpu.sampling.sample import apply_penalties as j_apply_penalties
from llama_fastapi_k8s_gpu_tpu.sampling.sample import sampling_tensors as j_sampling_tensors
from llama_fastapi_k8s_gpu_tpu.sampling.sample import seed_window as j_seed_window
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf, write_tiny_mistral_gguf
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGUFFile
from llama_fastapi_k8s_gpu_tpu_torch.models import llama
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.generate import (
    decode_step,
    first_sample,
    generate_chunk,
    init_state,
)
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward, init_cache
from llama_fastapi_k8s_gpu_tpu_torch.models.params import (
    LOOP_LINEARS,
    from_jax_params,
    load_params,
)
from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS, decode_loop, linear
from llama_fastapi_k8s_gpu_tpu_torch.ops.kvquant import kv_quantize_plain, quantize_kv_plain
from llama_fastapi_k8s_gpu_tpu_torch.ops.rope import rope_cos_sin, rope_rotate
from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams, sampling_tensors

torch.set_num_threads(1)
CPU = torch.device("cpu")
#: prompt tokens, then the first sample and two chunks of 8
PROMPT, CHUNK, CHUNKS = 12, 8, 2


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree, jnp.float32))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The tiny file of an architecture, loaded by both sides (once)."""
    loaded = {}

    def load(arch: str):
        if arch not in loaded:
            path = str(tmp_path_factory.mktemp("gen") / f"{arch}.gguf")
            writer = write_tiny_llama_gguf if arch == "llama" else write_tiny_mistral_gguf
            jcfg = writer(path)
            jparams = j_load_params(JGGUFFile(path), jcfg, fmt="bf16", on_device=False)
            cfg = ModelConfig.from_gguf(GGUFFile(path), n_ctx=jcfg.n_ctx)
            assert cfg.sliding_window == jcfg.sliding_window == (16 if arch == "mistral" else 0)
            loaded[arch] = (jcfg, jparams, cfg,
                            from_jax_params(_numpy_tree(jparams), cfg, device="cpu"))
        return loaded[arch]

    return load


def _bf16_step(x: float) -> float:
    """One bf16 step (ulp) at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _compare_tokens(got: list, want: list, jparams, jcfg, prompt) -> int:
    """The index up to which the greedy streams agree (their length when
    they agree).  They may part only at a tie of the reference: where the
    reference's penalized logit of the port's token lies within one bf16
    step of its best (at temperature 0 the reference breaks an exact tie
    by the lower id, and the port's logits differ from it by bf16 steps).
    Then only what precedes the parting is compared further."""
    if got == want:
        return len(want)
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    lg, cache = j_forward(jparams, jcfg, jnp.asarray(prompt, jnp.int32), jnp.int32(0),
                          j_init_cache(jcfg))
    for step, tok in enumerate(want[:i]):
        lg, cache = j_decode_step(jparams, jcfg, jnp.int32(tok), jnp.int32(len(prompt) + step),
                                  cache)
    jw, _ = j_seed_window(list(prompt) + want[:i])
    pen = np.asarray(j_apply_penalties(lg, jw, j_sampling_tensors(JSamplingParams(
        temperature=0.0))))
    assert pen.argmax() == want[i]
    gap = pen[want[i]] - pen[got[i]]
    assert gap <= _bf16_step(pen[want[i]]), (
        f"greedy tokens part at {i}: {got[i]} against the reference's {want[i]}, "
        f"{gap} below its best (more than one bf16 step)")
    return i


def _close_bf16(got: torch.Tensor, want: np.ndarray, name: str) -> None:
    g = got.float().numpy()
    rel = np.linalg.norm(g - want) / np.linalg.norm(want)
    assert rel <= 1e-2, (name, rel)
    assert np.abs(g - want).max() <= 2 * _bf16_step(np.abs(want).max()), name


@pytest.mark.parametrize("arch,kv_dtype", [("llama", "bf16"), ("llama", "int8"),
                                           ("mistral", "bf16")])
def test_chunks_match_generate_chunk_jit(models, arch, kv_dtype):
    jcfg, jparams, cfg, params = models(arch)
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, PROMPT)

    # the reference: prompt pass, first sample, two jitted chunks
    jl, jcache = j_forward(jparams, jcfg, jnp.asarray(prompt, jnp.int32), jnp.int32(0),
                           j_init_cache(jcfg))
    jst = j_sampling_tensors(JSamplingParams(temperature=0.0))
    jw, jwpos = j_seed_window(prompt.tolist())
    tok, jw, jwpos, key = j_sample_jit(jl, jw, jwpos, jax.random.PRNGKey(0), jst, jcfg,
                                       top_k=40)
    jstate = {"cache": jcache, "pos": jnp.int32(PROMPT), "token": tok, "window": jw,
              "wpos": jwpos, "key": key}
    want = [int(tok)]
    for _ in range(CHUNKS):
        jstate, toks = j_generate_chunk_jit(jparams, jcfg, jstate, jst, n_steps=CHUNK, top_k=40)
        want += np.asarray(toks).tolist()

    # the port: the same over its device-state step
    cache = init_cache(cfg, CPU)
    with torch.inference_mode():
        lg = forward(params, cfg, torch.from_numpy(prompt), 0, cache)
    st = sampling_tensors(SamplingParams(temperature=0.0), CPU)
    state = init_state(cache, prompt.tolist(), 0, CPU)
    got = [int(first_sample(lg, state, st))]
    for _ in range(CHUNKS):
        got += generate_chunk(params, cfg, state, st, CHUNK).tolist()

    agree = _compare_tokens(got, want, jparams, jcfg, prompt)
    n_fed = 1 + CHUNKS * CHUNK - 1            # the last token is sampled, not fed
    assert int(state["pos"]) == int(jstate["pos"]) == state["slot"] == PROMPT + n_fed
    assert int(state["wpos"]) == int(jstate["wpos"]) == PROMPT + n_fed + 1
    window, jwindow = state["window"].numpy(), np.asarray(jstate["window"])
    last = (PROMPT + n_fed) % 64                # the last sample's window slot
    if agree < len(want):
        assert agree == len(want) - 1, "the streams part before the last token"
        window, jwindow = np.delete(window, last), np.delete(jwindow, last)
    assert window.tolist() == jwindow.tolist()
    assert state["out"][PROMPT:PROMPT + n_fed].tolist() == got[1:]

    fed = slice(0, PROMPT + min(agree, n_fed))  # the slots both sides wrote alike
    assert set(cache) == set(jstate["cache"])
    for name, leaf in cache.items():
        ref = np.asarray(jnp.asarray(jstate["cache"][name], jnp.float32))[:, :, fed]
        leaf = leaf[:, :, fed]
        if name in ("k", "v"):
            _close_bf16(leaf, ref, name)
        elif name in ("k_q", "v_q"):
            diff = np.abs(leaf.numpy().astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1, name
            s = cache[name[0] + "_s"][:, :, fed].numpy()
            js = np.asarray(jstate["cache"][name[0] + "_s"])[:, :, fed]
            deq, jdeq = leaf.numpy() * s[..., None], ref * js[..., None]
            assert np.linalg.norm(deq - jdeq) <= 1e-2 * np.linalg.norm(jdeq), name
        else:
            assert np.linalg.norm(leaf.numpy() - ref) <= 1e-2 * np.linalg.norm(ref), name


# ---------------------------------------------------------------------------
# a proxy for CUDA-graph capture
# ---------------------------------------------------------------------------

#: ops that read a device value on the host (``.item()`` records as
#: ``aten.item`` under inference mode, as ``_local_scalar_dense`` outside it),
#: and ``lift_fresh``: a tensor made from a host value inside the step,
#: which on the card is a host-to-device copy that a capture refuses
HOST_READS = ("aten._local_scalar_dense", "aten.item", "aten.is_nonzero", "aten.equal",
              "aten.lift_fresh")


def _arg(a):
    """A recorded argument: a tensor by shape and dtype; a number or a
    string by value; a module, a config or a dict of tensors by its type."""
    if isinstance(a, torch.Tensor):
        return ("T", tuple(a.shape), str(a.dtype))
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype, torch.device)):
        return a
    if isinstance(a, (list, tuple)):
        return tuple(_arg(x) for x in a)
    return type(a).__name__


class _Recorder(TorchDispatchMode):
    """Every aten op run under it, as (name, arguments); a kernel wrapper
    as one op, its plain version (the CPU's stand-in for the launch) not
    recorded."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self._inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._inside:
            self.ops.append((str(func), tuple(_arg(a) for a in tree_leaves((args, kwargs)))))
        return func(*args, **kwargs)

    @contextlib.contextmanager
    def kernel(self, name, args, kwargs):
        self.ops.append((f"kernel:{name}", tuple(_arg(a) for a in (*args, *kwargs.values()))))
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1


def _wrap_kernels(monkeypatch, rec: _Recorder) -> None:
    """Route the step's kernel wrappers through ``rec``: the fused linears
    (``ops.linear``'s table), the int8 KV write (looked up in
    ``models.llama`` at each call) and the looped decode (looked up in
    ``ops.decode_loop``)."""
    def wrapped(name, fn):
        def call(*args, **kwargs):
            with rec.kernel(name, args, kwargs):
                return fn(*args, **kwargs)
        return call

    names = {fn: name for name, fn in KERNELS.items()}
    for kind, fn in list(linear._FUSED.items()):
        monkeypatch.setitem(linear._FUSED, kind, wrapped(names[fn], fn))
    monkeypatch.setattr(llama, "kv_quantize", wrapped("kv_quantize", llama.kv_quantize))
    monkeypatch.setattr(decode_loop, "decode_loop_step",
                        wrapped("decode_loop", decode_loop.decode_loop_step))


def _step_ops(params, cfg, pos: int, rec_factory, top_k: int = 40) -> list:
    """The ops of one decode step at ring slot ``pos``, after one step
    elsewhere (the caches the first step fills: RoPE frequencies, the loop
    plan)."""
    state = init_state(init_cache(cfg, CPU), [i % cfg.vocab_size for i in range(pos)], 3, CPU)
    st = sampling_tensors(SamplingParams(temperature=0.8), CPU)
    decode_step(params, cfg, init_state(init_cache(cfg, CPU), [1, 2], 3, CPU), st, top_k)
    rec = rec_factory()
    with rec:
        decode_step(params, cfg, state, st, top_k)
    assert int(state["pos"]) == pos + 1
    return rec.ops


@pytest.mark.parametrize("fmt,kv_dtype,unroll", [
    ("bf16", "bf16", 0),
    ("bf16", "int8", 0),       # the int8 KV write kernel
    ("q4k", "bf16", 0),        # the fused Q8_0 matmul kernel (q8)
    ("int8", "int8", -1),      # the layer-looped kernel, one launch a token
    ("bf16", "bf16", 2),       # ... one layer a launch, over the bf16 ring
])
def test_step_has_the_same_ops_at_every_position(tmp_path, monkeypatch, fmt, kv_dtype,
                                                 unroll):
    path = str(tmp_path / "tiny.gguf")
    write_tiny_llama_gguf(path)                   # Q8_0 linears
    cfg = ModelConfig.from_gguf(GGUFFile(path), n_ctx=1024)
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype, decode_layer_unroll=unroll)
    params = load_params(GGUFFile(path), cfg, fmt, CPU)
    recs = []

    def factory():
        rec = _Recorder()
        _wrap_kernels(monkeypatch, rec)
        recs.append(rec)
        return rec

    at_5 = _step_ops(params, cfg, 5, factory)
    monkeypatch.undo()
    at_900 = _step_ops(params, cfg, 900, factory)
    names = [op for op, _ in at_5]
    reads = [op for op in names if op.startswith(HOST_READS)]
    assert not reads, f"host reads or host values in the step: {reads}"
    assert at_5 == at_900
    kernels = {op for op in names if op.startswith("kernel:")}
    want = {"bf16": set(), "int8": {"kernel:kv_quantize"}}[kv_dtype] if not unroll else \
        {"kernel:decode_loop"}
    if fmt == "q4k":
        want = want | {"kernel:q8_matmul"}
    assert kernels == want


# ---------------------------------------------------------------------------
# the kernels' plain versions take the slot as a tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,first", [(1, 0), (1, 700), (1, 1023), (37, 20)])
def test_kv_quantize_plain_takes_the_slots_as_a_tensor(S, first):
    """The ring the slice assignment ``ring[:, first:first + S] = q`` wrote,
    bit for bit, and no other slot touched."""
    n_kv, hd, n_ctx = 2, 64, 1024
    rng = np.random.default_rng(S + first)
    k, v = (torch.from_numpy(rng.standard_normal((S, n_kv, hd), dtype=np.float32) * s
                             ).bfloat16() for s in (3.0, 1.0))
    positions = first + torch.arange(S)
    cos, sin = rope_cos_sin(positions, hd, 500000.0)
    rings = [torch.full((n_kv, n_ctx, hd), 7, dtype=torch.int8) for _ in range(2)]
    scales = [torch.full((n_kv, n_ctx), 0.5) for _ in range(2)]
    kv_quantize_plain(k, v, cos, sin, positions, *rings, *scales)
    for x, ring, sc in ((rope_rotate(k, cos, sin), rings[0], scales[0]),
                        (v, rings[1], scales[1])):
        q, s = quantize_kv_plain(x.transpose(0, 1))
        want_q = torch.full((n_kv, n_ctx, hd), 7, dtype=torch.int8)
        want_s = torch.full((n_kv, n_ctx), 0.5)
        want_q[:, first:first + S] = q
        want_s[:, first:first + S] = s
        assert torch.equal(ring, want_q)
        assert torch.equal(sc.view(torch.int32), want_s.view(torch.int32))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("pos", [0, 37, 127])
def test_decode_loop_plain_takes_the_slot_as_a_tensor(kv_dtype, pos):
    """The layer stack of one token at ``tensor([pos])`` writes the ring
    and returns the h that the per-layer forward at the host slot ``pos``
    gives, bit for bit."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import synth_params

    cfg = ModelConfig(vocab_size=64, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                      ffn_dim=256, n_ctx=128, kv_dtype=kv_dtype)
    params = synth_params(cfg, "bf16", seed=1, device=CPU)
    fmts = dict.fromkeys(LOOP_LINEARS, "bf16")
    cache = init_cache(cfg, CPU)
    with torch.inference_mode():
        forward(params, cfg, torch.arange(pos + 1) % 64, 0, cache)   # fill slots 0..pos
        a = {k: v.clone() for k, v in cache.items()}
        b = {k: v.clone() for k, v in cache.items()}
        h = params.tok_emb[torch.tensor([9])].to(torch.bfloat16)
        got = decode_loop.decode_loop_plain(params, a, h, torch.tensor([pos]), 0, cfg, fmts,
                                            cfg.n_layers)
        want = h
        rope = rope_cos_sin(torch.tensor([pos]), cfg.head_dim, cfg.rope_theta)
        for i, layer in enumerate(params.layers):
            want = llama._layer(want, layer, i, b, torch.tensor([pos]), pos, cfg, rope)
    assert torch.equal(got, want)
    for name in a:
        assert torch.equal(a[name], b[name]), name
