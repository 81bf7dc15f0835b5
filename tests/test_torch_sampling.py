"""Port sampling chain against the JAX reference's.

Greedy picks are identical; the penalty-adjusted logits and the filtered,
tempered probability vector agree within 1e-5 (f32 softmax in two
libraries).  Draws are not compared: the PRNGs differ by design.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_fastapi_k8s_gpu_tpu.sampling.sample import SamplingParams as JSamplingParams
from llama_fastapi_k8s_gpu_tpu.sampling.sample import apply_penalties as j_apply_penalties
from llama_fastapi_k8s_gpu_tpu.sampling.sample import sample_chain as j_sample_chain
from llama_fastapi_k8s_gpu_tpu.sampling.sample import sampling_tensors as j_sampling_tensors
from llama_fastapi_k8s_gpu_tpu.sampling.sample import seed_window as j_seed_window
from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import (
    PENALTY_WINDOW,
    SamplingParams,
    apply_penalties,
    candidates,
    sample_chain,
    sampling_tensors,
    seed_window,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
VOCAB = 300

PARAMS = [
    dict(temperature=1.2, top_p=0.9, frequency_penalty=0.7, presence_penalty=0.8),
    dict(temperature=0.7, top_p=0.5, top_k=10, min_p=0.1, repeat_penalty=1.3),
    dict(temperature=1.0, top_p=1.0, top_k=0, min_p=0.0, repeat_penalty=1.0),
]


def _case(seed: int, window_fill: int = 40):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(VOCAB) * 3).astype(np.float32)
    window = np.full(PENALTY_WINDOW, -1, np.int64)
    window[:window_fill] = rng.integers(0, VOCAB, window_fill)
    window[3] = int(np.argmax(logits))      # penalize the favourite
    return logits, window


def _j_filtered_probs(logits, window, st, top_k=40):
    """The reference chain up to the draw, spelled with its own
    apply_penalties and the steps of its sample_chain."""
    lg = j_apply_penalties(jnp.asarray(logits), jnp.asarray(window, jnp.int32), st)
    vals, idx = jax.lax.top_k(lg, top_k)
    vals = jnp.where(jnp.arange(top_k) < st["top_k"], vals, -jnp.inf)
    probs = jax.nn.softmax(vals)
    cum_excl = jnp.cumsum(probs) - probs
    keep = cum_excl < st["top_p"]
    keep &= probs >= st["min_p"] * probs[0]
    keep = keep.at[0].set(True)
    masked = jnp.where(keep, vals, -jnp.inf)
    tempered = jax.nn.softmax(masked / jnp.maximum(st["temperature"], 1e-6))
    return np.asarray(idx), np.asarray(tempered)


@pytest.mark.parametrize("kw", PARAMS)
@pytest.mark.parametrize("seed", [0, 1])
def test_penalties_and_filtered_distribution(kw, seed):
    logits, window = _case(seed)
    jst = j_sampling_tensors(JSamplingParams(**kw))
    st = sampling_tensors(SamplingParams(**kw), CPU)
    got_pen = apply_penalties(torch.from_numpy(logits), torch.from_numpy(window), st)
    ref_pen = j_apply_penalties(jnp.asarray(logits), jnp.asarray(window, jnp.int32), jst)
    np.testing.assert_allclose(got_pen.numpy(), np.asarray(ref_pen), atol=1e-5, rtol=0)

    idx, masked = candidates(torch.from_numpy(logits), torch.from_numpy(window), st)
    probs = torch.softmax(masked / torch.clamp(st["temperature"], min=1e-6), -1)
    ref_idx, ref_probs = _j_filtered_probs(logits, window, jst)
    assert idx.tolist() == ref_idx.tolist()
    np.testing.assert_allclose(probs.numpy(), ref_probs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_identical(seed):
    logits, window = _case(seed)
    kw = dict(temperature=0.0, frequency_penalty=0.7, presence_penalty=0.8)
    ref = j_sample_chain(jnp.asarray(logits), jnp.asarray(window, jnp.int32),
                         jax.random.PRNGKey(seed), j_sampling_tensors(JSamplingParams(**kw)))
    gen = torch.Generator().manual_seed(seed)
    got = sample_chain(torch.from_numpy(logits), torch.from_numpy(window), gen,
                       sampling_tensors(SamplingParams(**kw), CPU))
    assert int(got) == int(ref)


def test_draws_stay_in_the_filtered_set_and_follow_the_generator():
    logits, window = _case(3)
    st = sampling_tensors(SamplingParams(temperature=1.0, top_p=0.8), CPU)
    idx, masked = candidates(torch.from_numpy(logits), torch.from_numpy(window), st)
    allowed = set(idx[torch.isfinite(masked)].tolist())

    def draws(seed):
        gen = torch.Generator().manual_seed(seed)
        return [int(sample_chain(torch.from_numpy(logits), torch.from_numpy(window),
                                 gen, st)) for _ in range(50)]

    a = draws(11)
    assert set(a) <= allowed and len(set(a)) > 1
    assert a == draws(11)


@pytest.mark.parametrize("n", [0, 5, 63, 64, 65, 200])
def test_seed_window_identical(n):
    ids = list(range(1000, 1000 + n))
    ref_w, ref_pos = j_seed_window(ids)
    w, pos = seed_window(ids, CPU)
    assert w.tolist() == np.asarray(ref_w).tolist()
    assert pos == int(ref_pos)


@pytest.mark.parametrize("tie", [(210, 229), (5, 6, 299), (0, 150)])
def test_exact_bf16_tie_picks_the_first_index_in_both(tie):
    """ROADMAP C.2 is a rounding difference, not a rule difference: on logits
    whose maximum is an exact bf16 tie, ``torch.argmax`` and ``jnp.argmax``
    both return the first maximal index, and both greedy chains (the
    reference's ``lax.top_k``, the port's stable sort) pick that id."""
    rng = np.random.default_rng(len(tie))
    logits = rng.standard_normal(VOCAB).astype(np.float32)
    top = np.float32(np.abs(logits).max() + 1.0)
    logits[list(tie)] = top
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    jbf = jnp.asarray(logits, jnp.bfloat16)
    assert bool((bf[list(tie)] == bf[tie[0]]).all())
    assert int(torch.argmax(bf)) == int(jnp.argmax(jbf)) == tie[0]
    as_f32 = bf.float().numpy()
    window = np.full(PENALTY_WINDOW, -1, np.int64)
    kw = dict(temperature=0.0, frequency_penalty=0.0, presence_penalty=0.0,
              repeat_penalty=1.0)
    ref = j_sample_chain(jnp.asarray(as_f32), jnp.asarray(window, jnp.int32),
                         jax.random.PRNGKey(0), j_sampling_tensors(JSamplingParams(**kw)))
    got = sample_chain(torch.from_numpy(as_f32), torch.from_numpy(window),
                       torch.Generator().manual_seed(0),
                       sampling_tensors(SamplingParams(**kw), CPU))
    assert int(got) == int(ref) == tie[0]
