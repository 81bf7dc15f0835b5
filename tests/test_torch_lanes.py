"""The port's lane programs (parallel/batched.py) on the CPU.

- **Parity with the reference's lane programs.**  Three lanes at different
  prompt lengths through the port's ``batched_prefill`` and the JAX
  package's ``batched_prefill_jit`` (logits within the model tests' 10⁻²
  rel-dev), then each lane's first sample and two chunks of 8 through
  ``generate_chunk_lanes`` and ``batched_generate_chunk_perlane_jit``
  (per-lane knobs: greedy with different penalties and ``top_k``) or
  ``batched_generate_chunk_jit`` (one shared set): on the tiny Llama over
  the bf16 and the int8 ring, and on the tiny Mistral past its 16-slot
  window.  Tokens, ``pos``, ``wpos`` and ``window`` identical up to a
  lane's parting, which must be a tie of the reference's own penalized
  logits (its best and both tokens within one bf16 step: the reference's
  lane program and its one-sequence decode part at such ties too); ring
  leaves of the slots fed before it within ``tests/test_torch_generate.py``'s
  tolerance: bf16 within 10⁻² rel-dev and two bf16 steps of the leaf's
  largest magnitude; int8 scales and the dequantized ring within 10⁻²,
  codes within one on every row whose scale equals the reference's (a
  row whose max moved a bf16 step is on another grid, where a code can
  move by two).
- **The lane sample chain** equals the one-sequence chain row by row.
- **A proxy for CUDA-graph capture**: the lane step's ops at two sets of
  lane slots are the same, with no host read (``tests/test_torch_generate.py``'s
  recorder).
- **Lanes stay apart**: a lane parked at slot n_ctx-1 (and one past the
  ring) steps without error and writes only its last slot; a step with one
  lane's inputs changed leaves the other lanes' logits, tokens and rings
  bit-identical.
- **Kernel 10's plain lane write** equals B serial writes; the one-ring
  call is unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_fastapi_k8s_gpu_tpu.gguf import GGUFFile as JGGUFFile
from llama_fastapi_k8s_gpu_tpu.models.generate import sample_jit as j_sample_jit
from llama_fastapi_k8s_gpu_tpu.models.llama import decode_step as j_decode_step
from llama_fastapi_k8s_gpu_tpu.models.llama import forward as j_forward
from llama_fastapi_k8s_gpu_tpu.models.llama import init_cache as j_init_cache
from llama_fastapi_k8s_gpu_tpu.models.params import load_params as j_load_params
from llama_fastapi_k8s_gpu_tpu.parallel.batched import (
    batched_generate_chunk_jit as j_chunk_shared,
)
from llama_fastapi_k8s_gpu_tpu.parallel.batched import (
    batched_generate_chunk_perlane_jit as j_chunk_perlane,
)
from llama_fastapi_k8s_gpu_tpu.parallel.batched import batched_prefill_jit as j_batched_prefill
from llama_fastapi_k8s_gpu_tpu.parallel.batched import init_batched_state as j_init_batched
from llama_fastapi_k8s_gpu_tpu.sampling.sample import SamplingParams as JSamplingParams
from llama_fastapi_k8s_gpu_tpu.sampling.sample import apply_penalties as j_apply_penalties
from llama_fastapi_k8s_gpu_tpu.sampling.sample import sampling_tensors as j_sampling_tensors
from llama_fastapi_k8s_gpu_tpu.sampling.sample import seed_window as j_seed_window
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf, write_tiny_mistral_gguf
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGUFFile
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward_lanes, init_lane_cache
from llama_fastapi_k8s_gpu_tpu_torch.models.params import from_jax_params, load_params
from llama_fastapi_k8s_gpu_tpu_torch.ops import kvquant
from llama_fastapi_k8s_gpu_tpu_torch.ops.rope import rope_cos_sin
from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import (
    batched_prefill,
    generate_chunk_lanes,
    init_batched_state,
    lane_step,
    state_nbytes,
)
from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import (
    SamplingParams,
    apply_penalties,
    apply_penalties_lanes,
    candidates,
    candidates_lanes,
    lane_tensors,
    sample_chain,
    sample_chain_lanes,
    sampling_tensors,
    seed_window,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
#: the three lanes' prompt lengths (the Mistral ones past its 16-slot window)
LENGTHS = (12, 20, 7)
CHUNK, CHUNKS = 8, 2
#: per-lane knobs of the per-lane chunk: greedy, the penalties apart
LANE_SPS = (JSamplingParams(temperature=0.0),
            JSamplingParams(temperature=0.0, repeat_penalty=1.3, frequency_penalty=0.2,
                            presence_penalty=0.1, top_k=5),
            JSamplingParams(temperature=0.0, repeat_penalty=1.0, frequency_penalty=0.0,
                            presence_penalty=0.0, top_k=0))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _port_sp(sp: JSamplingParams) -> SamplingParams:
    return SamplingParams(**dataclasses.asdict(sp))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The tiny file of an architecture, loaded by both sides (once)."""
    loaded = {}

    def load(arch: str):
        if arch not in loaded:
            path = str(tmp_path_factory.mktemp("lanes") / f"{arch}.gguf")
            writer = write_tiny_llama_gguf if arch == "llama" else write_tiny_mistral_gguf
            jcfg = writer(path)
            jparams = j_load_params(JGGUFFile(path), jcfg, fmt="bf16", on_device=False)
            cfg = ModelConfig.from_gguf(GGUFFile(path), n_ctx=jcfg.n_ctx)
            loaded[arch] = (jcfg, jparams, cfg,
                            from_jax_params(_numpy_tree(jparams), cfg, device="cpu"))
        return loaded[arch]

    return load


def _bf16_step(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _agree(got: list, want: list, jparams, jcfg, prompt, jsp) -> int:
    """How far one lane's greedy streams agree (their length when they do).
    They may part only at a tie of the reference: the reference's penalized
    logit (under the lane's knobs) of the port's token within one bf16 step
    of its best."""
    if got == want:
        return len(want)
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    lg, cache = j_forward(jparams, jcfg, jnp.asarray(prompt, jnp.int32), jnp.int32(0),
                          j_init_cache(jcfg))
    for step, tok in enumerate(want[:i]):
        lg, cache = j_decode_step(jparams, jcfg, jnp.int32(tok),
                                  jnp.int32(len(prompt) + step), cache)
    jw, _ = j_seed_window(list(prompt) + want[:i])
    pen = np.asarray(j_apply_penalties(lg, jw, j_sampling_tensors(jsp)))
    best = pen.max()
    step = _bf16_step(best)
    assert best - pen[want[i]] <= step and best - pen[got[i]] <= step, (
        f"greedy tokens part at {i}: {got[i]} against the reference's {want[i]}, "
        f"{best - pen[got[i]]} and {best - pen[want[i]]} below the best (one bf16 step: "
        f"{step})")
    return i


def _close_bf16(got: torch.Tensor, want: np.ndarray, name: str) -> None:
    g = got.float().numpy()
    rel = np.linalg.norm(g - want) / np.linalg.norm(want)
    assert rel <= 1e-2, (name, rel)
    assert np.abs(g - want).max() <= 2 * _bf16_step(np.abs(want).max()), name


def _prompts(cfg) -> list:
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in LENGTHS]


@pytest.mark.parametrize("arch,kv_dtype,knobs", [("llama", "bf16", "perlane"),
                                                 ("llama", "int8", "perlane"),
                                                 ("mistral", "bf16", "perlane"),
                                                 ("llama", "bf16", "shared")])
def test_lane_chunks_match_the_reference_lane_programs(models, arch, kv_dtype, knobs):
    jcfg, jparams, cfg, params = models(arch)
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    prompts = _prompts(cfg)
    B, S = len(prompts), max(LENGTHS)
    sps = LANE_SPS if knobs == "perlane" else (JSamplingParams(temperature=0.0),) * B
    padded = np.zeros((B, S), np.int64)
    for b, p in enumerate(prompts):
        padded[b, :len(p)] = p

    # the reference: batched prefill, each lane's first sample, two chunks
    jstate = j_init_batched(jcfg, B)
    jlogits, jcache = j_batched_prefill(jparams, jcfg, jnp.asarray(padded, jnp.int32),
                                        jnp.asarray(LENGTHS, jnp.int32), jstate["cache"])
    jsts = [j_sampling_tensors(sp) for sp in sps]
    firsts, windows, wposes = [], [], []
    for b, p in enumerate(prompts):
        jw, jwp = j_seed_window(p)
        tok, jw, jwp, _ = j_sample_jit(jlogits[b], jw, jwp, jax.random.PRNGKey(b), jsts[b],
                                       jcfg, top_k=64)
        firsts.append(tok)
        windows.append(jw)
        wposes.append(jwp)
    jstate = {"cache": jcache, "pos": jnp.asarray(LENGTHS, jnp.int32),
              "token": jnp.stack(firsts), "window": jnp.stack(windows),
              "wpos": jnp.stack(wposes), "key": jax.random.split(jax.random.PRNGKey(0), B)}
    want = [[int(t)] for t in firsts]
    jlane_st = jax.tree.map(lambda *x: jnp.stack(x), *jsts)
    for _ in range(CHUNKS):
        if knobs == "perlane":
            jstate, toks = j_chunk_perlane(jparams, jcfg, jstate, jlane_st, n_steps=CHUNK,
                                           top_k=64)
        else:
            jstate, toks = j_chunk_shared(jparams, jcfg, jstate, jsts[0], n_steps=CHUNK,
                                          top_k=64)
        for b in range(B):
            want[b] += np.asarray(toks)[:, b].tolist()

    # the port: the same through its lane programs
    state = init_batched_state(cfg, B, CPU)
    st = (lane_tensors([_port_sp(sp) for sp in sps], CPU) if knobs == "perlane"
          else lane_tensors([_port_sp(sps[0])] * B, CPU))
    with torch.inference_mode():
        logits = batched_prefill(params, cfg, torch.from_numpy(padded), LENGTHS,
                                 state["cache"])
    rel = (np.linalg.norm(logits.numpy() - np.asarray(jlogits))
           / np.linalg.norm(np.asarray(jlogits)))
    assert rel <= 1e-2
    got = []
    for b, p in enumerate(prompts):
        window, wpos = seed_window(p, CPU)
        knobs_b = {k: v[b] for k, v in st.items()}
        tok = sample_chain(logits[b], window, state["gens"][b], knobs_b, top_k=64)
        window[wpos % 64] = tok
        state["window"][b] = window
        state["wpos"][b] = wpos + 1
        state["token"][b] = tok
        got.append([int(tok)])
    state["pos"].copy_(torch.tensor(LENGTHS))
    state["slots"] = list(LENGTHS)
    for _ in range(CHUNKS):
        rows = generate_chunk_lanes(params, cfg, state, st, CHUNK, top_k=64).rows()
        for b in range(B):
            got[b] += rows[:, b].tolist()

    n_fed = CHUNKS * CHUNK
    jwin = np.asarray(jstate["window"])
    for b, p in enumerate(prompts):
        agree = _agree(got[b], want[b], jparams, jcfg, p, sps[b])
        assert int(state["pos"][b]) == int(jstate["pos"][b]) == state["slots"][b] \
            == LENGTHS[b] + n_fed
        assert int(state["wpos"][b]) == int(jstate["wpos"][b])
        window, jwindow = state["window"][b].numpy(), jwin[b]
        if agree < len(want[b]):
            # the ring slots of the tokens from the parting on differ
            _, wpos0 = seed_window(p, CPU)
            parted = sorted({(wpos0 + j) % 64 for j in range(agree, len(want[b]))})
            window, jwindow = np.delete(window, parted), np.delete(jwindow, parted)
        assert window.tolist() == jwindow.tolist()
        fed = slice(0, LENGTHS[b] + min(agree, n_fed))
        for name, leaf in state["cache"].items():
            ref = np.asarray(jnp.asarray(jstate["cache"][name][b], jnp.float32))[:, :, fed]
            lane = leaf[b][:, :, fed]
            if name in ("k", "v"):
                _close_bf16(lane, ref, name)
            elif name in ("k_q", "v_q"):
                # codes within one on the rows whose scale is the
                # reference's (one grid); every row within 10⁻² dequantized
                diff = np.abs(lane.numpy().astype(np.int32) - ref.astype(np.int32))
                sc = state["cache"][name[0] + "_s"][b][:, :, fed].numpy()
                jsc = np.asarray(jstate["cache"][name[0] + "_s"][b])[:, :, fed]
                assert diff[sc == jsc].max() <= 1, name
                deq, jdeq = lane.numpy() * sc[..., None], ref * jsc[..., None]
                assert np.linalg.norm(deq - jdeq) <= 1e-2 * np.linalg.norm(jdeq), name
            else:
                assert np.linalg.norm(lane.numpy() - ref) <= 1e-2 * np.linalg.norm(ref), name
    assert state_nbytes(state) == sum(t.numel() * t.element_size() for t in (
        *state["cache"].values(), *(state[k] for k in ("pos", "token", "window", "wpos",
                                                       "out"))))


def test_lane_sample_chain_equals_the_one_sequence_chain_row_by_row():
    """Random logits, penalty rings and knobs for 5 lanes (sampled, greedy,
    k=1, k disabled, a tight top-p): the lane chain's candidates, filtered
    logits and draws equal the one-sequence chain's on each row, with each
    lane's generator seeded alike."""
    B, V = 5, 300
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(B, V, generator=g) * 3
    windows = torch.randint(-1, V, (B, 64), generator=g)
    sps = [SamplingParams(), SamplingParams(temperature=0.0), SamplingParams(top_k=1),
           SamplingParams(top_k=0, temperature=0.9), SamplingParams(top_p=0.3, min_p=0.2)]
    st = lane_tensors(sps, CPU)
    gens = [torch.Generator().manual_seed(40 + b) for b in range(B)]
    ids, masked = candidates_lanes(logits, windows, st, 64)
    pen = apply_penalties_lanes(logits, windows, st)
    for b in range(B):
        one = sampling_tensors(sps[b], CPU)
        assert torch.equal(pen[b], apply_penalties(logits[b], windows[b], one))
        i1, m1 = candidates(logits[b], windows[b], one, 64)
        assert torch.equal(ids[b], i1) and torch.equal(masked[b], m1)
    gens_one = [torch.Generator().manual_seed(40 + b) for b in range(B)]
    for _ in range(3):
        toks = sample_chain_lanes(logits, windows, gens, st, 64)
        want = [int(sample_chain(logits[b], windows[b], gens_one[b],
                                 sampling_tensors(sps[b], CPU), 64)) for b in range(B)]
        assert toks.tolist() == want
    assert toks[1] == pen[1].argmax() and toks[2] == pen[2].argmax()


# ---------------------------------------------------------------------------
# a proxy for CUDA-graph capture, and lanes staying apart
# ---------------------------------------------------------------------------

def _tiny(tmp_path, fmt, kv_dtype, unroll, n_ctx=1024):
    path = str(tmp_path / "tiny.gguf")
    write_tiny_llama_gguf(path)                   # Q8_0 linears
    cfg = ModelConfig.from_gguf(GGUFFile(path), n_ctx=n_ctx)
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype, decode_layer_unroll=unroll)
    return cfg, load_params(GGUFFile(path), cfg, fmt, CPU)


def _lanes_at(cfg, slots: list, seed: int = 3) -> dict:
    state = init_batched_state(cfg, len(slots), CPU, seed=seed)
    g = torch.Generator().manual_seed(seed)
    for leaf in state["cache"].values():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, dtype=torch.int8))
        else:
            leaf.copy_((torch.rand(leaf.shape, generator=g) * 0.5).to(leaf.dtype))
    state["pos"].copy_(torch.tensor(slots))
    state["slots"] = list(slots)
    state["token"].copy_(torch.arange(len(slots)) + 7)
    state["window"].copy_(torch.randint(-1, cfg.vocab_size, state["window"].shape, generator=g))
    return state


@pytest.mark.parametrize("fmt,kv_dtype,unroll", [
    ("bf16", "bf16", 0),
    ("bf16", "int8", 0),       # kernel 10 over the lanes, one call a layer
    ("q4k", "bf16", 0),        # the fused Q8_0 matmul over (B, dim) rows
    ("int8", "int8", -1),      # the looped kernel once a lane
])
def test_lane_step_has_the_same_ops_at_every_slot(tmp_path, monkeypatch, fmt, kv_dtype,
                                                  unroll):
    from tests.test_torch_generate import HOST_READS, _Recorder, _wrap_kernels

    cfg, params = _tiny(tmp_path, fmt, kv_dtype, unroll)
    st = lane_tensors([SamplingParams(temperature=0.8)] * 3, CPU)
    lane_step(params, cfg, _lanes_at(cfg, [1, 2, 3]), st, 64)     # warm caches

    def ops(slots):
        state = _lanes_at(cfg, slots)
        rec = _Recorder()
        _wrap_kernels(monkeypatch, rec)
        with rec:
            lane_step(params, cfg, state, st, 64)
        monkeypatch.undo()
        assert state["pos"].tolist() == [s + 1 for s in slots]
        return rec.ops

    a, b = ops([5, 900, 17]), ops([1023, 3, 1500])
    names = [op for op, _ in a]
    reads = [op for op in names if op.startswith(HOST_READS)]
    assert not reads, f"host reads or host values in the lane step: {reads}"
    assert a == b
    kernels = [op for op in names if op.startswith("kernel:")]
    if unroll:
        assert kernels.count("kernel:decode_loop") == 3        # once a lane
    elif kv_dtype == "int8":
        assert kernels.count("kernel:kv_quantize") == cfg.n_layers   # the lanes in one call
    if fmt == "q4k":
        assert "kernel:q8_matmul" in kernels


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_a_parked_lane_steps_at_its_last_slot(tmp_path, kv_dtype):
    """Lane 1 at slot n_ctx-1 and lane 2 past the ring step 3 times without
    error: their writes land in their last slot alone (the slot clamped on
    the device), lane 0 decodes on."""
    cfg, params = _tiny(tmp_path, "bf16", kv_dtype, 0, n_ctx=64)
    state = _lanes_at(cfg, [10, 63, 70])
    before = {k: v.clone() for k, v in state["cache"].items()}
    st = lane_tensors([SamplingParams(temperature=0.0)] * 3, CPU)
    rows = generate_chunk_lanes(params, cfg, state, st, 3, top_k=40).rows()
    assert rows.shape == (3, 3)
    assert state["pos"].tolist() == [13, 66, 73]
    for k, leaf in state["cache"].items():
        for lane in (1, 2):
            assert torch.equal(leaf[lane][:, :, :63], before[k][lane][:, :, :63]), k
        assert torch.equal(leaf[0][:, :, 13:], before[k][0][:, :, 13:]), k
        assert not torch.equal(leaf[0][:, :, 10:13], before[k][0][:, :, 10:13]), k


@pytest.mark.parametrize("kv_dtype,unroll", [("bf16", 0), ("int8", 0), ("bf16", -1)])
def test_a_step_leaves_the_other_lanes_untouched(tmp_path, kv_dtype, unroll):
    """The same step with lane 1's token, knobs and slot changed: lanes 0
    and 2 give bit-identical logits, tokens and rings."""
    cfg, params = _tiny(tmp_path, "bf16", kv_dtype, unroll, n_ctx=128)
    sps = [SamplingParams(temperature=0.0), SamplingParams(temperature=0.0),
           SamplingParams(temperature=0.0, top_k=3)]
    outs = []
    for tok1, slot1, sp1 in ((9, 40, sps[1]), (100, 77, SamplingParams(temperature=1.5))):
        state = _lanes_at(cfg, [20, slot1, 55])
        state["token"][1] = tok1
        st = lane_tensors([sps[0], sp1, sps[2]], CPU)
        with torch.inference_mode():
            logits = forward_lanes(params, cfg, state["token"], state["pos"].clone(),
                                   {k: v.clone() for k, v in state["cache"].items()})
            tok = lane_step(params, cfg, state, st, 64)
        outs.append((logits, tok, state["cache"]))
    (la, ta, ca), (lb, tb, cb) = outs
    for lane in (0, 2):
        assert torch.equal(la[lane], lb[lane])
        assert ta[lane] == tb[lane]
        for k in ca:
            assert torch.equal(ca[k][lane], cb[k][lane]), k


# ---------------------------------------------------------------------------
# kernel 10's plain lane write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,slots", [(1, [700]), (3, [0, 700, 1023]),
                                     (8, [0, 700, 1023, 5, 1024, 511, 999, 1])])
def test_kv_quantize_lane_write_is_b_serial_writes(B, slots):
    """Through the wrapper on CPU tensors (its plain version): token t into
    lane t at its slot equals B serial one-ring writes, a slot out of range
    (1024) leaves its lane alone, and the one-ring call on lane 0's view is
    the serial write itself."""
    n_kv, hd, n_ctx, L, i = 2, 64, 1024, 2, 1
    g = torch.Generator().manual_seed(B)
    k = (torch.randn(B, n_kv, hd, generator=g) * 4).to(torch.bfloat16)
    v = torch.randn(B, n_kv, hd, generator=g).to(torch.bfloat16)
    positions = torch.tensor(slots)
    cos, sin = rope_cos_sin(positions.clamp(0, n_ctx - 1), hd, 500000.0)
    q = torch.randint(-127, 128, (2, B, L, n_kv, n_ctx, hd), generator=g, dtype=torch.int8)
    s = torch.rand(2, B, L, n_kv, n_ctx, generator=g)
    want_q, want_s = q.clone(), s.clone()
    kvquant.kv_quantize(k, v, cos, sin, positions, q[0][:, i], q[1][:, i], s[0][:, i],
                        s[1][:, i])
    for b, slot in enumerate(slots):
        if slot < n_ctx:
            kvquant.kv_quantize(k[b:b + 1], v[b:b + 1], cos[b:b + 1], sin[b:b + 1],
                                positions[b:b + 1], want_q[0][b, i], want_q[1][b, i],
                                want_s[0][b, i], want_s[1][b, i])
    assert torch.equal(q, want_q)
    assert torch.equal(s, want_s)


def test_kv_quantize_refuses_lane_rings_that_are_not_one_stride_apart():
    n_kv, hd, n_ctx = 2, 64, 32
    k = torch.zeros(2, n_kv, hd, dtype=torch.bfloat16)
    cos = sin = torch.zeros(2, hd // 2)
    pos = torch.tensor([0, 1])
    ring = torch.zeros(2, n_kv, n_ctx, hd, dtype=torch.int8)
    sc = torch.zeros(2, n_kv, n_ctx)
    with pytest.raises(ValueError, match="do not fit"):
        kvquant.kv_quantize(k, k, cos, sin, pos, ring, ring, sc[:1], sc[:1])
    with pytest.raises(ValueError, match="one stride apart"):
        kvquant.kv_quantize(k, k, cos, sin, pos, ring.transpose(1, 2).contiguous()
                            .transpose(1, 2), ring, sc, sc)


def test_init_lane_cache_lanes_are_serial_rings():
    cfg = ModelConfig(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=1, ffn_dim=96,
                      n_ctx=32, kv_dtype="int8")
    cache = init_lane_cache(cfg, 3, CPU)
    assert cache["k_q"].shape == (3, 2, 1, 32, 32) and cache["k_s"].shape == (3, 2, 1, 32)
    assert all(leaf[1].is_contiguous() for leaf in cache.values())
