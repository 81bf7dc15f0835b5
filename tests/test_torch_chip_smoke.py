"""The pure helpers of ``chip_smoke.py`` (the H100 smoke run at the repo
root): the cold timings' copy count and call rotation, the decode
token's recipe of fused matmul calls that its ``fused_token`` lines sum,
the looped kernel's bound and ``loop_positions`` line, the synthetic
files' random blocks of every type, the mixed-type file's spread and the
Mistral file's SentencePiece vocabulary.
These run on the CPU; the timings themselves need the card."""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _collect_wrapped_engines():
    """The recorders under test wrap an engine's methods with closures over
    the engine (a reference cycle): collect such engines when each test
    ends, so no later test in the process finds their memory-ledger rows."""
    yield
    gc.collect()


@pytest.mark.parametrize("nbytes,copies", [
    (2_359_296, 43),        # Q4_K 1024 x 4096: 2.4 MB
    (33_030_144, 4),        # Q4_K 14336 x 4096
    (50_000_000, 2),        # exactly half the flush
    (558_366_720, 2),       # Q8_0 128256 x 4096: at least 2
    (100_000_000, 2),
])
def test_cold_copies_pass_the_flush_bytes_between_uses(nbytes, copies):
    assert chip_smoke.cold_copies(nbytes) == copies
    # the other copies between two uses of one hold at least the flush bytes
    assert (copies - 1) * nbytes >= chip_smoke.COLD_FLUSH_BYTES - nbytes


@pytest.mark.parametrize("reps,copies", [(20, 43), (20, 2), (20, 3), (5, 1)])
def test_graph_calls_rotate_whole_cycles_of_copies(reps, copies):
    calls = chip_smoke.graph_calls(lambda i: i, reps, copies)
    got = [c() for c in calls]
    assert len(got) >= reps and len(got) % copies == 0
    assert got == [i % copies for i in range(len(got))]


def test_graph_calls_warm_mode_repeats_the_call():
    calls = chip_smoke.graph_calls(lambda: 7, 4)
    assert len(calls) == 4 and {c() for c in calls} == {7}


@pytest.mark.parametrize("layout,calls", [
    ("q4km", {"q4k_matmul": 160, "q6k_matmul": 65}),
    ("q5km", {"q5k_matmul": 160, "q6k_matmul": 65}),
    ("q8_0", {"q8_matmul": 225}),
    ("q6_k", {"q6k_matmul": 225}),
])
def test_token_recipe_counts_a_decode_token(layout, calls):
    """Seven linears a layer times 32 layers, and the output head once."""
    recipe = chip_smoke.token_recipe(layout)
    by_kernel: dict = {}
    for (name, _), n in recipe.items():
        by_kernel[name] = by_kernel.get(name, 0) + n
    assert by_kernel == calls
    # every shape is one phase 3 times at B=1
    for name, shape in recipe:
        assert shape in chip_smoke.MATMUL_SHAPES[name]
    assert recipe[(chip_smoke.served_formats(layout)["output"] + "_matmul",
                   chip_smoke.HEAD_SHAPE)] == 1


def test_fused_token_sums_calls_times_times():
    recipe = chip_smoke.token_recipe("q8_0")
    rows = {key: {"cold_graph_ms": 1.0, "graph_ms": 0.5, "library_cold_graph_ms": 2.0,
                  "bound_ms": 0.25 * (key[1] == chip_smoke.HEAD_SHAPE)}
            for key in recipe}
    line = chip_smoke.fused_token("q8_0", rows)
    assert line["calls"] == 225
    assert line["cold_graph_ms"] == 225.0 and line["graph_ms"] == 112.5
    assert line["library_cold_graph_ms"] == 450.0 and line["bound_ms"] == 0.25
    assert line["by_kernel"]["q8_matmul"]["calls"] == 225


B = list(chip_smoke.SWEEP_BATCHES)              # 1..9, 12, 16


@pytest.mark.parametrize("tc,want", [
    # a clean crossover: the tensor cores win from 4 rows on
    ([3.5] * 11, 4),
    # they win at 2 and 3, lose at 4, and win again from 5 on
    ([5.0, 1.5, 2.5, 4.5, *[4.0] * 7], 5),
    # a tie is not a win
    ([4.0] * 11, 5),
    # they win only at the smallest B and lose at the largest: never
    ([0.5, *[20.0] * 10], None),
    ([*[0.5] * 10, 20.0], None),
    # they win everywhere
    ([0.5] * 11, 1),
])
def test_route_threshold_reads_the_last_crossover(tc, want):
    """The CUDA-core path's time grows with B (here 1 ms a row); the
    tensor cores' stays nearly flat."""
    cuda_core = [float(b) for b in B]
    assert chip_smoke.route_threshold(B, cuda_core, tc) == want


def test_route_thresholds_read_each_format_from_its_file():
    """Made-up sweeps through ``route_layer``: each format's threshold comes
    from its own file's layer; q6k's share of the Q4_K_M layer is reported
    at that B."""
    sweeps = []
    for name, shapes in chip_smoke.MATMUL_SHAPES.items():
        cross = {"q4k_matmul": 7, "q5k_matmul": 3, "q6k_matmul": 5, "q8_matmul": None}[name]
        for shape in shapes[:4]:
            tc = [1.0 if cross and b >= cross else 3.0 for b in B]
            sweeps.append({"name": name, "shape": list(shape),
                           "cuda_core_ms": [2.0] * len(B), "tc_ms": tc})
    layers = chip_smoke.route_layer(sweeps)
    launcher = {"q4k_matmul": 7, "q5k_matmul": 8, "q6k_matmul": 8, "q8_matmul": 9}
    got = {r["name"]: r for r in chip_smoke.route_thresholds(layers, launcher)}
    assert {n: r["measured"] for n, r in got.items()} == {
        "q4k_matmul": 7, "q5k_matmul": 3, "q6k_matmul": 5, "q8_matmul": None}
    assert {n: r["file"] for n, r in got.items()} == chip_smoke.THRESHOLD_FILE
    assert got["q6k_matmul"]["launcher"] == 8
    # q6k serves in three files' layers; at 5 rows its tensor cores take half
    assert got["q6k_matmul"]["tc_over_cuda_core_at_measured"] == {
        "q4km": 0.5, "q5km": 0.5, "q6_k": 0.5}
    assert got["q8_matmul"]["tc_over_cuda_core_at_measured"] == {}


@pytest.mark.parametrize("w_int8,kv_int8", [(False, False), (False, True), (True, False),
                                            (True, True)])
def test_loop_bound_counts_weights_ring_and_h(w_int8, kv_int8):
    # two 8B layers at slot 700: 701 keys of 8 KV heads of 128
    wbytes, weights = 436_000_000, 218_000_000
    got = chip_smoke.loop_bound(wbytes, weights, 2, 8, 32, 128, 4096, 701, w_int8, kv_int8)
    ring = 2 * 2 * 8 * 701 * (128 + 4 if kv_int8 else 256)
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(1e3 * (wbytes + ring + 4 * 4096)
                                            / chip_smoke.HBM_BPS)
    # the ring's bytes grow with the keys, the weights' stay
    more = chip_smoke.loop_bound(wbytes, weights, 2, 8, 32, 128, 4096, 1024, w_int8, kv_int8)
    assert more["bound_ms"] > got["bound_ms"]


@pytest.mark.parametrize("w_int8,rate", [(False, "BF16_FLOPS"), (True, "INT8_OPS")])
def test_loop_bound_turns_to_operations_past_the_ridge(w_int8, rate):
    # more multiply-adds than bytes can carry: the weights' peak rate bounds it
    got = chip_smoke.loop_bound(1000, 10 ** 12, 1, 8, 32, 128, 4096, 1, w_int8, False)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(
        1e3 * (2.0 * 10 ** 12 + 4.0 * 32 * 128) / getattr(chip_smoke, rate))


def test_loop_positions_reads_share_and_growth():
    rows = [{"variant": "bf16 weights, bf16 ring", "layers": 2,
             "positions": [{"pos": 0, "ms": 0.4, "bound_ms": 0.2},
                           {"pos": 1023, "ms": 0.5, "bound_ms": 0.25}]},
            {"variant": "int8 weights, int8 ring", "layers": 2,
             "positions": [{"pos": 0, "ms": 0.2, "bound_ms": 0.1}]}]
    got = chip_smoke.loop_positions(rows)["variants"]
    assert [v["variant"] for v in got] == [r["variant"] for r in rows]
    assert [s["share_of_bound"] for s in got[0]["slots"]] == [0.5, 0.5]
    assert got[0]["slots"][1]["pos"] == 1023
    assert got[0]["last_over_first"] == pytest.approx(1.25)
    assert got[1]["last_over_first"] == 1.0


@pytest.mark.parametrize("layout,fmt,want", [
    # fused: token_embd alone, into bf16
    ("q4km", "auto", {"dequant_q4_k": 1}),
    ("q5km", "auto", {"dequant_q5_k": 1}),
    ("q8_0", "auto", {"dequant_q8_0": 1}),
    ("q6_k", "auto", {"dequant_q6_k": 1}),
    # bf16: every linear (7 × 32) and the head, and token_embd
    ("q8_0", "bf16", {"dequant_q8_0": 226}),
    # int8: the Q4_K linears (5 × 32) and the Q6_K ones (2 × 32 + the head)
    ("q4km", "int8", {"dequant_q4_k": 161, "dequant_q6_k": 65}),
])
def test_load_dequants_counts_a_load(layout, fmt, want):
    plan = chip_smoke.load_dequants(layout, fmt)
    got: dict = {}
    for (name, shape, out), n in plan.items():
        got[name] = got.get(name, 0) + n
        assert shape in chip_smoke.DEQUANT_SHAPES
        # token_embd and the bf16 load come out in bf16, the int8 load in f32
        assert out == ("float32" if fmt == "int8" and (name, shape, out) != (
            chip_smoke.DEQUANT_OF[chip_smoke.file_types(layout)["token_embd"]],
            chip_smoke.HEAD_SHAPE, "bfloat16") else "bfloat16")
    assert got == want


def _dequant_lines(ms_of):
    return [{"name": name, "shapes": [
        {"shape": list(shape), "out": out, "graph_ms": ms_of(name, shape), "bound_ms": 1.0}
        for shape in chip_smoke.DEQUANT_SHAPES for out in ("bfloat16", "float32")]}
        for name in chip_smoke.DEQUANT_OF.values()]


def test_dequant_rank_sums_launches_times_gap_over_the_six_engines():
    """Made-up times: every shape 1 ms over a 1 ms bound, Q8_0's 4096-row
    shapes 3 ms; the launches are the six engines' loads (PERF.md §6:
    162 / 1 / 66 / 227)."""
    lines = _dequant_lines(lambda name, shape: 3.0 if name == "dequant_q8_0"
                           and shape[0] == 4096 else 2.0)
    counters = {"dequant_q4_k": 162, "dequant_q5_k": 1, "dequant_q6_k": 66,
                "dequant_q8_0": 227, "kv_quantize": 9}
    got = chip_smoke.dequant_rank(lines, counters)
    rows = {r["name"]: r for r in got["ranked"]}
    assert {n: r["launches"] for n, r in rows.items()} == {
        n: counters[n] for n in rows}
    assert [r["name"] for r in got["ranked"]] == [
        "dequant_q8_0", "dequant_q4_k", "dequant_q6_k", "dequant_q5_k"]
    # Q8_0: 96 launches at 4096 rows (attn_q/output, ffn_down) lose 2 ms each
    assert rows["dequant_q8_0"]["gap_ms"] == 96 * 2.0 + (227 - 96) * 1.0
    assert rows["dequant_q4_k"]["gap_ms"] == 162.0
    assert sum(rows["dequant_q8_0"]["by_shape"].values()) == 227
    with pytest.raises(AssertionError, match="counters"):
        chip_smoke.dequant_rank(lines, {**counters, "dequant_q6_k": 65})


def test_device_kernels_counts_kernels_not_copies():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, dev):
        return SimpleNamespace(name=name, device_type=dev)

    events = [ev("aten::mm", DeviceType.CPU), ev("gemv_kernel", DeviceType.CUDA),
              ev("Memcpy HtoD (Pageable -> Device)", DeviceType.CUDA),
              ev("Memset (Device)", DeviceType.CUDA), ev("kv_quantize_kernel", DeviceType.CUDA)]
    assert chip_smoke.device_kernels(events) == 2
    assert chip_smoke.device_kernels([ev("aten::mm", DeviceType.CPU)]) == 0


@pytest.mark.parametrize("name,size", [("dequant_q4_k", 144), ("dequant_q5_k", 176)])
def test_dequant_input_randomises_every_k_quant_header(name, size):
    """The dequant checks' Q4_K / Q5_K blocks: a scale that differs from its
    min somewhere, every 6-bit value reachable, and a d and dmin per block
    (a swapped scale and min, or a neighbour's header, would not pass)."""
    import numpy as np

    from llama_fastapi_k8s_gpu_tpu_torch.gguf.quants import unpack_scale_min_k4

    raw = chip_smoke.dequant_input(name, np.random.default_rng(0), 37, 4352)
    assert raw.shape == (37, 17 * size) and raw.dtype == np.uint8
    blk = raw.reshape(-1, size)
    sc, mn = unpack_scale_min_k4(blk[:, 4:16])
    assert (sc != mn).any()
    assert {int(v) for v in np.unique(sc)} == set(range(64))
    assert {int(v) for v in np.unique(mn)} == set(range(64))
    d, dmin = (blk[:, a:a + 2].copy().view(np.float16)[:, 0] for a in (0, 2))
    assert len(np.unique(d)) > 1 and len(np.unique(dmin)) > 1
    assert np.isfinite(d).all() and np.isfinite(dmin).all()
    assert (d != dmin).any()


def test_dequant_shapes_and_rank_read_every_k_quant_shape(monkeypatch):
    """Rows 1 and 9b (Q4_K, Q5_K): ``dequant_shapes`` times every load
    shape into bf16 and f32, and ``dequant_rank`` reads each launched
    (shape, out) from those lines."""
    seen = []

    def fake_check(name, rng, n_out=128256, k_in=4096, dtype="bfloat16", plain=True):
        seen.append((name, (n_out, k_in), dtype))
        return {"shape": [n_out, k_in], "out": dtype, "ms": 2.0, "graph_ms": 1.5,
                "bound_ms": 1.0}

    monkeypatch.setattr(chip_smoke, "check_dequant", fake_check)
    want = {(shape, out) for shape in chip_smoke.DEQUANT_SHAPES
            for out in ("bfloat16", "float32")}
    lines = []
    for name in chip_smoke.DEQUANT_OF.values():
        head = [fake_check(name, None, dtype=dt) for dt in ("bfloat16", "float32")]
        seen.clear()
        line = chip_smoke.dequant_shapes(name, None, head)
        got = {(tuple(r["shape"]), r["out"]) for r in line["shapes"]}
        assert got == want and len(line["shapes"]) == len(want)
        # the head's shape comes from the kernel lines, the others are checked here
        assert {(s, o) for _, s, o in seen} == want - {(chip_smoke.HEAD_SHAPE, o)
                                                        for o in ("bfloat16", "float32")}
        assert all(r["over_bound"] == 1.5 for r in line["shapes"])
        lines.append(line)
    rows = {r["name"]: r for r in chip_smoke.dequant_rank(lines)["ranked"]}
    for name in ("dequant_q4_k", "dequant_q5_k"):
        plan: dict = {}
        for layout, fmt in chip_smoke.ENGINES:
            for (kern, shape, out), n in chip_smoke.load_dequants(layout, fmt).items():
                if kern == name:
                    key = f"{shape[0]}x{shape[1]} {out}"
                    plan[key] = plan.get(key, 0) + n
        assert rows[name]["by_shape"] == plan
        assert rows[name]["gap_ms"] == 0.5 * sum(plan.values())
    # the int8 load's f32 layer shapes and both heads of Q4_K; Q5_K's token_embd
    assert rows["dequant_q4_k"]["launches"] == 162
    assert set(rows["dequant_q4_k"]["by_shape"]) == {
        "4096x4096 float32", "1024x4096 float32", "14336x4096 float32",
        "128256x4096 bfloat16"}
    assert rows["dequant_q5_k"]["by_shape"] == {"128256x4096 bfloat16": 1}


@pytest.mark.parametrize("name,part", [
    ("void lfkt::qgemv_kernel<(anonymous namespace)::Q4KGemv, 1>(...)", "fused_linears"),
    ("void qmma_kernel<Q6KDecoder, 128, true>(...)", "fused_linears"),
    ("void (anonymous namespace)::decode_loop_kernel<true, false>(LoopArgs)", "looped_layers"),
    ("void (anonymous namespace)::kv_quantize_kernel<128>(...)", "kv_write"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x64x32", "cublas"),
    ("void gemv2T_kernel_val<int, int, float, float, float, 128, 16, 4, 4>", "cublas"),
    ("nvjet_tst_384x8_64x4_2x1_v_bz_TNT", "cublas"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "softmax"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>", "sort"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
])
def test_kernel_part_names_the_part_of_a_decode_token(name, part):
    assert chip_smoke.kernel_part(name) == part


def test_replay_breakdown_sums_parts_and_idle_per_replay():
    """Two replays of three kernels: per-replay µs and counts by part, the
    busy time as the union of the intervals (an overlap counts once) and
    the idle time between them."""
    kernels = [("qgemv_kernel<Q4KGemv>", 0.0, 10.0), ("softmax_x", 12.0, 14.0),
               ("elementwise", 13.0, 16.0),
               ("qgemv_kernel<Q4KGemv>", 20.0, 30.0), ("softmax_x", 31.0, 33.0),
               ("elementwise", 34.0, 36.0)]
    got = chip_smoke.replay_breakdown(kernels, 2)
    assert got["parts"]["fused_linears"] == {"us": 10.0, "kernels": 1.0}
    assert got["parts"]["softmax"] == {"us": 2.0, "kernels": 1.0}
    assert got["parts"]["other"] == {"us": 2.5, "kernels": 1.0}
    assert got["busy_us"] == (14.0 + 14.0) / 2 and got["span_us"] == 18.0
    assert got["idle_us"] == 4.0 and got["idle_share"] == 8.0 / 36.0


def test_reply_changes_key_by_engine_prompt_and_occurrence():
    before = [{"engine": 0, "prompt": [1, 2], "ids": [5, 6, 7]},
              {"engine": 0, "prompt": [3], "ids": [8, 9]},
              {"engine": 1, "prompt": [1, 2], "ids": [5, 6, 7]}]
    now = [{"engine": 0, "prompt": [1, 2], "ids": [5, 6, 4]},
           {"engine": 0, "prompt": [3], "ids": [8, 9]},
           {"engine": 0, "prompt": [1, 2], "ids": [1]},          # a second occurrence
           {"engine": 1, "prompt": [1, 2], "ids": [5, 6]}]       # stopped earlier
    got = chip_smoke.reply_changes(now, before)
    assert [(c["rec"]["engine"], c["first_diff"], c["before"], c["now"]) for c in got] == [
        (0, 2, 7, 4), (1, 2, 7, None)]


def test_record_replies_appends_prompt_ids_and_finish():
    class Fake:
        def _finish(self, ctx):
            return {"done": True}

        def create_chat_completion(self, **kw):
            out = self._finish({"prompt_ids": [1, 2], "ids": [3]})
            return {"choices": [{"finish_reason": "length"}], "inner": out}

    eng, sink = Fake(), []
    chip_smoke.record_replies(eng, 4, sink)
    assert eng.create_chat_completion()["inner"] == {"done": True}
    assert sink == [{"engine": 4, "prompt": [1, 2], "ids": [3], "finish_reason": "length"}]


def test_sse_text_joins_deltas_and_keeps_the_last_finish():
    events = [{"choices": [{"delta": {"role": "assistant"}, "finish_reason": None}]},
              {"choices": [{"delta": {"content": "he"}, "finish_reason": None}]},
              {"choices": [{"delta": {"content": "llo"}, "finish_reason": None}]},
              {"choices": [{"delta": {}, "finish_reason": "length"}]},
              {"choices": [], "usage": {"prompt_tokens": 3}}, "[DONE]"]
    assert chip_smoke.sse_text(events) == ("hello", "length")
    assert chip_smoke.sse_text(["[DONE]"]) == ("", None)


def test_prom_samples_reads_one_family_by_labels():
    text = ("# HELP http_requests_total x\n# TYPE http_requests_total counter\n"
            'http_requests_total{route="/v1/chat/completions",code="200"} 3\n'
            'http_requests_total{route="/items/{item_id}",code="422"} 1\n'
            "http_requests_total_other 9\nhealth_state 1\n"
            'request_seconds_bucket{route="/a",le="0.5"} 2\n')
    got = chip_smoke.prom_samples(text, "http_requests_total")
    assert got == {(("route", "/v1/chat/completions"), ("code", "200")): 3.0,
                   (("route", "/items/{item_id}"), ("code", "422")): 1.0}
    assert chip_smoke.prom_samples(text, "health_state") == {(): 1.0}
    assert chip_smoke.prom_samples(text, "kv_cache_bytes") == {}


def _span(name, start, end, *children):
    return {"name": name, "start": start, "end": end, "children": list(children)}


def test_spans_within_names_spans_outside_their_parent():
    ok = _span("request", 1.0, 9.0, _span("httpd.read", 0.5, 1.0),
               _span("queue", 1.0, 1.1), _span("engine", 1.1, 8.0,
                                                _span("prefill", 1.1, 2.0),
                                                _span("decode_chunk", 2.0, 8.0)))
    assert chip_smoke.spans_within(ok) == []
    bad = _span("request", 1.0, 9.0, _span("queue", 0.9, 1.1),
                _span("engine", 1.1, 9.5, _span("decode_chunk", 2.0, None)))
    assert chip_smoke.spans_within(bad) == ["queue", "engine", "decode_chunk"]


def test_devtime_delta_keeps_what_grew():
    before = {"decode_chunk": {"compiles": 1, "dispatches": 10, "signatures": 1, "storms": 0},
              "prefill": {"compiles": 0, "dispatches": 3, "signatures": 0, "storms": 0}}
    after = {"decode_chunk": {"compiles": 2, "dispatches": 74, "signatures": 2, "storms": 0},
             "prefill": {"compiles": 0, "dispatches": 3, "signatures": 0, "storms": 0},
             "kernel_build": {"compiles": 1, "dispatches": 0, "signatures": 1, "storms": 0}}
    assert chip_smoke.devtime_delta(before, after) == {
        "decode_chunk": {"compiles": 1, "dispatches": 64},
        "kernel_build": {"compiles": 1, "dispatches": 0}}


def test_worst_burns_reads_each_slo_and_window():
    doc = {"slos": [{"name": "error_rate", "windows": {"300s": {"burn_rate": 66.7},
                                                       "3600s": {"burn_rate": 5.0}}},
                    {"name": "ttft_p95", "windows": {"300s": {"burn_rate": 0.0}}}]}
    assert chip_smoke.worst_burns(doc) == {"error_rate": {"300s": 66.7, "3600s": 5.0},
                                           "ttft_p95": {"300s": 0.0}}


def test_profile_trace_stats_counts_kernels_port_kernels_and_graph_launches(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void qgemv_kernel<Q4KGemv>(...)"},
        {"ph": "X", "cat": "kernel", "name": "void at::native::reduce_kernel<512>(...)"},
        {"ph": "X", "cat": "kernel", "name": "void qgemv_kernel<Q6KGemv>(...)"},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch"},
        {"ph": "X", "cat": "cpu_op", "name": "qgemv_kernel lookalike"},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}, indent=1))
    got = chip_smoke.profile_trace_stats(str(path))
    assert (got["cuda_kernels"], got["port_kernels"], got["graph_launches"]) == (3, 2, 1)
    assert got["port_kernel_names"] == ["void qgemv_kernel<Q4KGemv>(...)",
                                        "void qgemv_kernel<Q6KGemv>(...)"]


@pytest.mark.parametrize("gtype", sorted(chip_smoke.RAND))
def test_random_blocks_decode_to_unit_weights(gtype):
    """Every synthetic file's random blocks: whole blocks of the type, and
    the codec decodes them to finite weights of std ≈ k_in^-0.5 and mean
    within a fraction of it (the synthetic model's activations stay in
    range at any depth)."""
    import numpy as np

    from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGMLType, quants
    from llama_fastapi_k8s_gpu_tpu_torch.gguf.constants import tensor_nbytes

    n_out, k_in = 32, 4096
    blocks = chip_smoke.RAND[gtype](np.random.default_rng(0), n_out, k_in)
    assert blocks.dtype == np.uint8 and blocks.shape[0] == n_out
    assert blocks.size == tensor_nbytes(GGMLType[gtype], n_out * k_in)
    w = quants.dequantize(blocks.reshape(-1), GGMLType[gtype], n_out * k_in)
    assert np.isfinite(w).all()
    assert 0.9 < w.std() * k_in ** 0.5 < 1.1
    assert abs(w.mean()) * k_in ** 0.5 < 0.25


def test_mixed_file_spreads_every_type():
    """The mixed file: every type on two tensors or more, ffn_down (K =
    14336) carries Q2_K, Q3_K, IQ4_XS and Q4_0, and every linear name mixes
    types across its layers (so it takes bf16 under ``q4k``)."""
    import collections

    kinds = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")
    per_name = {k: [chip_smoke.mixed_type_of(k, i) for i in range(chip_smoke.MIXED_DEPTH)]
                for k in kinds}
    counts = collections.Counter(t for ts in per_name.values() for t in ts)
    counts.update(chip_smoke.mixed_type_of(k, None) for k in ("token_embd", "output"))
    assert set(counts) == set(chip_smoke.MIXED_TYPES)
    assert min(counts.values()) >= 2
    assert {"Q2_K", "Q3_K", "IQ4_XS", "Q4_0"} <= set(per_name["ffn_down"])
    assert all(len(set(ts)) > 1 for ts in per_name.values())


def test_spm_vocabulary_makes_the_prompts_words_whole():
    """The Mistral file's 32000-piece vocabulary: the persona prompt and the
    long conversation encode to whole ``▁word`` pieces, ``[INST]`` to one
    piece, the text outside ASCII to byte pieces, and the rendered long
    prompt is over 4,600 tokens, past the 4096-token window."""
    import re

    from llama_fastapi_k8s_gpu_tpu_torch.server.app import build_system_prompt
    from llama_fastapi_k8s_gpu_tpu_torch.server.schemas import BotProfile
    from llama_fastapi_k8s_gpu_tpu_torch.tokenizer import SPMTokenizer, TokenType
    from llama_fastapi_k8s_gpu_tpu_torch.tokenizer.chat_template import apply_chat_template

    md = chip_smoke.spm_metadata(chip_smoke.mistral_texts())
    tok = SPMTokenizer(md["tokenizer.ggml.tokens"], md["tokenizer.ggml.scores"],
                       md["tokenizer.ggml.token_type"])
    assert tok.vocab_size == 32000 and (tok.bos_id, tok.eos_id) == (1, 2)
    msgs = [{"role": "system", "content": build_system_prompt(BotProfile(**chip_smoke.BOT))}]
    msgs += [{"role": "user" if t == "user" else "assistant", "content": m}
             for t, m in chip_smoke.mistral_long_context()]
    ids = apply_chat_template(tok, msgs, kind="mistral")
    assert 4600 < len(ids) < 8192 - 512
    pieces = [tok.tokens[i] for i in ids]
    assert pieces[:2] == ["<s>", "▁[INST]"]
    words = re.findall(r"(?<= )[A-Za-z']+", " ".join(m["content"] for m in msgs))
    assert all("▁" + w in tok.token_to_id for w in words)
    assert sum(tok.token_types[i] == TokenType.BYTE for i in ids) > 100
    text = chip_smoke.NON_ASCII
    assert tok.decode(tok.encode(text, add_bos=False)) == text


# ---------------------------------------------------------------------------
# the lane engines' helpers (batched serving)
# ---------------------------------------------------------------------------

def test_percentile_is_the_nearest_rank():
    xs = [0.5, 0.1, 0.3, 0.2, 0.4]
    assert chip_smoke.percentile(xs, 0.5) == 0.3
    assert chip_smoke.percentile(xs, 0.95) == 0.5
    assert chip_smoke.percentile(xs, 0.0) == 0.1
    assert chip_smoke.percentile([], 0.5) is None


@pytest.mark.parametrize("x,step", [(1.0, 2 ** -7), (3.0, 2 ** -6), (-0.75, 2 ** -8), (0.0, 0.0)])
def test_bf16_step_is_one_ulp_at_the_magnitude(x, step):
    assert chip_smoke.bf16_step(x) == step


def test_first_diff_names_the_first_differing_index():
    import torch

    a = torch.zeros(2, 3, 4)
    b = a.clone()
    assert chip_smoke.first_diff(a, b) is None
    b[1, 2, 0] = 1
    b[1, 2, 3] = 1
    assert chip_smoke.first_diff(a, b) == {"index": [1, 2, 0]}


@pytest.fixture(scope="module")
def tiny_file(tmp_path_factory):
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                      ffn_dim=128, n_ctx=128)
    path = str(tmp_path_factory.mktemp("lanes") / "tiny-q8_0.gguf")
    chip_smoke.write_gguf(cfg, path, "q8_0")
    return path


MSG = [{"role": "user", "content": "tell me about the sea"}]
KW = dict(n_ctx=128, max_gen_tokens=6, decode_chunk=4, prefill_buckets=(64, 128), device="cpu")


def test_lane_record_pairs_a_cycles_prompts_and_replies(tiny_file):
    """The cycle engine's answered entries, in order: each prompt's ids (the
    engine's tokenizer), its generated ids (what the reply decodes) and its
    finish_reason; an oversized entry is left out."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import MeshEngine

    eng = MeshEngine(tiny_file, batch_size=3, **KW)
    msgs = [MSG, [{"role": "user", "content": "x" * 600}],
            [{"role": "user", "content": "another prompt"}]]
    want = [eng.tokenize_messages(m) for m in (msgs[0], msgs[2])]
    sink: list = []
    chip_smoke.lane_record(eng, sink)
    outs = eng.create_chat_completions(msgs, temperature=0.0, max_tokens=5)
    assert [r["prompt"] for r in sink] == want
    answered = [outs[0], outs[2]]
    for rec, out in zip(sink, answered):
        assert len(rec["ids"]) == out["usage"]["completion_tokens"]
        assert rec["finish_reason"] == out["choices"][0]["finish_reason"]
        assert eng._decode_text(rec["ids"]) == out["choices"][0]["message"]["content"]
        assert rec["ttft_s"] > 0 and rec["stream"] is False


def test_lane_record_takes_the_continuous_engines_finished_slots(tiny_file):
    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine

    eng = ContinuousEngine(tiny_file, batch_size=2, **KW)
    sink: list = []
    chip_smoke.lane_record(eng, sink)
    try:
        out = eng.submit(MSG, temperature=0.0, max_tokens=5).result(timeout=60)
        list(eng.submit_stream(MSG, temperature=0.0, max_tokens=5))
    finally:
        eng.shutdown()
    assert [r["stream"] for r in sink] == [False, True]
    assert sink[0]["prompt"] == eng.tokenize_messages(MSG)
    assert len(sink[0]["ids"]) == out["usage"]["completion_tokens"]
    assert sink[0]["ids"] == sink[1]["ids"]
    assert sink[0]["finish_reason"] == out["choices"][0]["finish_reason"]


def test_serial_reply_is_the_serial_engines_reply_to_the_ids(tiny_file):
    """The serial engine fed prompt ids directly generates what it does for
    the messages those ids encode, under the same knobs; its tokenizer is
    back afterwards."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    eng = Engine(tiny_file, prefix_cache=False, **KW)
    sp = chip_smoke.served_sampling(Settings(temperature=0.0))
    sink: list = []
    chip_smoke.record_replies(eng, 0, sink)
    eng.create_chat_completion(MSG, temperature=0.0, top_p=sp.top_p,
                               frequency_penalty=sp.frequency_penalty,
                               presence_penalty=sp.presence_penalty, max_tokens=5)
    ids = eng.tokenize_messages(MSG)
    assert chip_smoke.serial_reply(eng, ids, 5, sp) == sink[0]["ids"]
    assert eng.tokenize_messages(MSG) == ids and "tokenize_messages" not in vars(eng)


def test_clone_and_restore_lanes_round_trip():
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
    from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import init_batched_state

    cfg = ModelConfig(vocab_size=64, dim=64, n_layers=1, n_heads=2, n_kv_heads=1, ffn_dim=96,
                      n_ctx=16, kv_dtype="int8")
    state = init_batched_state(cfg, 2, "cpu")
    saved = chip_smoke.clone_lanes(state)
    draws = [torch.rand(3, generator=g) for g in state["gens"]]
    state["pos"] += 5
    state["cache"]["k_q"].fill_(3)
    state["slots"] = [9, 9]
    chip_smoke.restore_lanes(state, saved)
    assert state["pos"].tolist() == [0, 0] and not state["cache"]["k_q"].any()
    assert state["slots"] == [0, 0]
    assert all(torch.equal(torch.rand(3, generator=g), d)
               for g, d in zip(state["gens"], draws))


def test_every_lane_engine_names_its_kernels_and_an_earlier_source():
    """Each lane engine lists the kernels its served path must launch; one
    that serves another's weights names an earlier engine of the same
    file; a per-layer int8-ring engine is among them (kernel 10's lane
    axis on a served path)."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    labels = [row[0] for row in chip_smoke.LANES]
    assert set(chip_smoke.LANE_KERNELS) == set(labels) and chip_smoke.LANE_DRILLS in labels
    for i, row in enumerate(chip_smoke.LANES):
        assert set(chip_smoke.LANE_KERNELS[row[0]]) <= set(KERNELS)
        if row[-1] is not None:
            src = next(r for r in chip_smoke.LANES[:i] if r[0] == row[-1])
            assert src[1] == row[1]
    assert any(r[3] == "int8" and r[4] == 0 and "kv_quantize" in chip_smoke.LANE_KERNELS[r[0]]
               for r in chip_smoke.LANES)


def test_phase_all_lanes_hands_an_engines_weights_to_the_next(monkeypatch):
    calls = []

    def fake(label, layout, path, counters, fmt, kv_dtype, unroll, lanes, scheduler, clients,
             parts=None):
        calls.append((label, path, parts))
        return {"kv_quantize": 1, "q4k_matmul": 2}, ("weights of", label)

    monkeypatch.setattr(chip_smoke, "phase_lanes", fake)
    counters = dict.fromkeys(["kv_quantize", "q4k_matmul", "decode_loop"])
    paths = {"q4km": "a.gguf", "q8_0": "b.gguf"}
    got = chip_smoke.phase_all_lanes(paths, counters)
    assert [(c[0], c[2]) for c in calls] == [
        ("lanes_q4km", None), ("lanes_q4km_int8", ("weights of", "lanes_q4km")),
        ("cycle_q8_0_bf16_loop8", None)]
    assert [c[1] for c in calls] == ["a.gguf", "a.gguf", "b.gguf"]
    assert got == {"kv_quantize": 3, "q4k_matmul": 6, "decode_loop": 0}
    calls.clear()
    chip_smoke.phase_all_lanes(paths, counters, ["lanes_q4km_int8"])
    assert calls == [("lanes_q4km_int8", "a.gguf", None)]


def test_oracle_draft_follows_the_vanilla_reply_then_repeats():
    """The oracle draft is the reply's next D tokens (zero-padded at its
    end) while the history follows the reply; past a parting, past the
    reply's end or for another prompt it is the always-hit draft."""
    refs = [{"prompt": [1, 2, 3], "ids": [7, 8, 9, 10, 11]},
            {"prompt": [4, 5], "ids": [6, 6, 6]}]
    draft = chip_smoke.oracle_draft
    assert draft(refs, [1, 2, 3, 7], 3) == [8, 9, 10]
    assert draft(refs, [1, 2, 3, 7, 8, 9, 10], 3) == [11, 0, 0]
    assert draft(refs, [4, 5, 6], 2) == [6, 6]
    assert draft(refs, [1, 2, 3, 7, 99], 3) == [99, 99, 99]            # parted
    assert draft(refs, [1, 2, 3, 7, 8, 9, 10, 11], 2) == [11, 11]      # reply's end
    assert draft(refs, [9, 9, 9, 9], 2) == [9, 9]                      # another prompt


def test_oracle_drafts_patch_the_lookup_and_put_it_back():
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine

    saved = Engine.__dict__["_lookup_draft"]
    with chip_smoke.oracle_drafts([{"prompt": [1], "ids": [2, 3, 4]}]):
        assert Engine._lookup_draft([1, 2], 2) == [3, 4]
    assert Engine.__dict__["_lookup_draft"] is saved
    assert Engine._lookup_draft([1, 2, 3, 4], 4) is None


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_route_noise_is_nil_where_both_routes_share_the_arithmetic(tiny_file, kv_dtype):
    """On the CPU one-row decode steps and D+1-row verify passes run the
    same plain linears: teacher-forced, they pick the same tokens at the
    same top-2 gaps and write the same ring (bf16 values, int8 codes and
    scales), so the card's partings come from its routes and not from the
    verify's bookkeeping."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine

    eng = Engine(tiny_file, kv_dtype=kv_dtype, prefix_cache=False, **KW)
    prompt = eng.tokenize_messages(MSG)
    out = chip_smoke.route_noise(eng, prompt, list(range(5, 46)), D=4)
    assert out["positions"] == 40 and out["kv_dtype"] == kv_dtype
    for h in ("rejected", "accepted"):
        assert out[h]["argmax_differs"] == 0 and out[h]["gap_steps_max"] == 0.0
        for leaf in out[h]["ring"].values():
            assert leaf["all"]["share_differs"] == 0.0


def test_every_speculative_phase_names_its_kernels():
    """The speculative phases serve both rings; an int8 phase's path must
    launch kernel 10 and the int8 flash kernel."""
    for label in ("spec", "spec_int8", "spec_lanes", "spec_lanes_int8"):
        kernels = chip_smoke.PAGED_KERNELS[label]
        assert ("kv_quantize" in kernels) == label.endswith("int8")
        assert ("flash_attention_int8" in kernels) == label.endswith("int8")


def test_chain_margin_reads_the_serial_chains_own_step(tiny_file):
    """At every reply token the serial chain's own logits (its ring as its
    steps wrote it, one more eager step) rank that chain's token first."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    eng = Engine(tiny_file, prefix_cache=False, **KW)
    sp = chip_smoke.served_sampling(Settings(temperature=0.0))
    prompt = eng.tokenize_messages(MSG)
    ids = chip_smoke.serial_reply(eng, prompt, 6, sp)
    for at in range(6):
        m = chip_smoke.chain_margin(eng, prompt, ids, at, sp)
        assert m["read"] == ("prompt_pass" if at == 0 else "chain")
        assert m["margin"] >= 0.0 and "prompt_pass_margin" in m
        if m["margin"] > 0.0:
            assert m["top2"][0] == ids[at]
    paged = Engine(tiny_file, kv_paged=True, kv_page_tokens=16, **KW)
    with pytest.raises(ValueError, match="reuses no prefix"):
        chip_smoke.chain_margin(paged, prompt, ids, 2, sp)


def test_forced_gaps_read_the_serial_chain_at_every_token(tiny_file):
    """Teacher-forced through the serial engine, its own greedy reply is
    its choice at every token (gap 0), and a token swapped for another
    reads a gap there; a turn is held only within the tie steps."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    eng = Engine(tiny_file, prefix_cache=False, **KW)
    sp = chip_smoke.served_sampling(Settings(temperature=0.0))
    prompt = eng.tokenize_messages(MSG)
    ids = chip_smoke.serial_reply(eng, prompt, 6, sp)
    assert chip_smoke.forced_gaps(eng, prompt, ids, sp) == [0.0] * 6
    other = ids[:3] + [(ids[3] + 1) % eng.cfg.vocab_size] + ids[4:]
    gaps = chip_smoke.forced_gaps(eng, prompt, other, sp)
    assert gaps[:3] == [0.0] * 3 and gaps[3] > 0.0
    rec = {"prompt": prompt, "ids": other}
    row, = chip_smoke.held_tokens([rec], [{"prompt": prompt, "ids": ids}], eng, sp, n=6)
    assert row["first_diff"] == 3 and not row["equal"]
    assert row["held"] == (row["max_gap_steps"] <= chip_smoke.MESH_TIE_STEPS)
    paged = Engine(tiny_file, kv_paged=True, kv_page_tokens=16, **KW)
    with pytest.raises(ValueError, match="reuses no prefix"):
        chip_smoke.forced_gaps(paged, prompt, ids, sp)


def test_pages_equal_compares_bits_not_values():
    import torch

    a = torch.tensor([[1.0, float("nan")]], dtype=torch.bfloat16)
    b = a.clone()
    assert chip_smoke.pages_equal([a], [b])          # NaN != NaN by value, equal by bits
    c = b.clone()
    c.view(torch.int16)[0, 1] ^= 1                   # another NaN pattern
    assert not chip_smoke.pages_equal([a], [c])
    assert not chip_smoke.pages_equal([a], [a, a])
    assert not chip_smoke.pages_equal([a], [a.reshape(2, 1)])
    i8 = torch.tensor([1, -2], dtype=torch.int8)
    assert chip_smoke.pages_equal([a, i8], [b, i8.clone()])


def test_tier_phases_name_kernels_that_exist_and_route_by_model():
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    for label, names in chip_smoke.TIER_KERNELS.items():
        assert names and set(names) <= set(KERNELS), label
    s = chip_smoke.tier_settings(models="a=x.gguf", batch_size=4)
    assert (s.kv_paged, s.kv_page_tokens, s.max_gen_tokens, s.temperature, s.batch_size) == \
        (True, chip_smoke.PAGE_TOKENS, chip_smoke.TIER_TOKENS, 0.0, 4)
    assert chip_smoke.model_body(chip_smoke.SHORT_CTX, "q6k")["model"] == "q6k"
    assert "model" not in chip_smoke.model_body(chip_smoke.SHORT_CTX, None)
    v1 = chip_smoke.v1_body("q4km", "hi", stream=True)
    assert (v1["model"], v1["messages"], v1["stream"], v1["temperature"]) == \
        ("q4km", [{"role": "user", "content": "hi"}], True, 0.0)


# ---------------------------------------------------------------------------
# the fleet phases' helpers
# ---------------------------------------------------------------------------

def test_fleet_key_is_the_reference_affinity_key_and_stable_across_turns():
    from llama_fastapi_k8s_gpu_tpu.serving.fleet.affinity import affinity_key

    ctx = [("user", chip_smoke.FLEET_OPENER.format(i=3))]
    key = chip_smoke.fleet_key(ctx)
    assert key == affinity_key("/response", {}, json.dumps(chip_smoke.body(ctx)).encode())[0]
    later = chip_smoke.fleet_next(chip_smoke.fleet_next(ctx, 0), 1)
    assert later[1:] == [("assistant", chip_smoke.FLEET_ACK), ("user", chip_smoke.FLEET_FOLLOW[0]),
                         ("assistant", chip_smoke.FLEET_ACK), ("user", chip_smoke.FLEET_FOLLOW[1])]
    assert chip_smoke.fleet_key(later) == key
    assert chip_smoke.fleet_key([("user", chip_smoke.FLEET_OPENER.format(i=4))]) != key


@pytest.mark.parametrize("owner", [0, 1, 2])
def test_fleet_conv_picks_conversations_the_owner_owns(owner):
    from llama_fastapi_k8s_gpu_tpu.serving.fleet.affinity import rendezvous_rank

    addrs = ["127.0.0.1:8001", "127.0.0.1:8002", "127.0.0.1:8003"]
    skip: set = set()
    picked = [chip_smoke.fleet_conv(addrs[owner], addrs, skip) for _ in range(3)]
    assert len({i for i, _ in picked}) == 3 and skip == {i for i, _ in picked}
    for _i, ctx in picked:
        assert rendezvous_rank(chip_smoke.fleet_key(ctx), addrs)[0] == addrs[owner]


def test_fleet_sums_and_labelled_read_prometheus_text():
    a = 'x_total{reason="remap"} 2\nx_total{reason="drain"} 1\ny 3\n'
    b = 'x_total{reason="remap"} 5\n'
    sums = chip_smoke.fleet_sums([a, b], "x_total")
    assert sums == {(("reason", "remap"),): 7.0, (("reason", "drain"),): 1.0}
    assert chip_smoke.labelled(sums) == {"reason=remap": 7.0, "reason=drain": 1.0}
    assert chip_smoke.fleet_sums([a], "z_total") == {}


# ---------------------------------------------------------------------------
# the image phase's helpers: the toolkit scrub, the read-only copy, the
# NEEDED reader, the page-cache reading, the write check and the build
# child's import list
# ---------------------------------------------------------------------------

def test_scrub_toolkit_drops_every_way_to_nvcc(tmp_path):
    with_nvcc, without = tmp_path / "cuda" / "bin", tmp_path / "usr" / "bin"
    with_nvcc.mkdir(parents=True)
    without.mkdir(parents=True)
    (with_nvcc / "nvcc").write_text("#!/bin/sh\n")
    (with_nvcc / "nvcc").chmod(0o755)
    (without / "nvcc").write_text("not executable")
    env = {"PATH": os.pathsep.join([str(with_nvcc), str(without), ""]),
           "CUDA_HOME": str(tmp_path / "cuda"), "CUDA_PATH": str(tmp_path / "cuda"),
           "HOME": "/home/x"}
    out = chip_smoke.scrub_toolkit(env)
    assert out == {"PATH": str(without), "HOME": "/home/x"}
    assert env["CUDA_HOME"] and str(with_nvcc) in env["PATH"]   # the input is left alone


def test_readonly_copy_is_the_package_without_builds_or_bytecode(tmp_path):
    src = tmp_path / "pkg"
    for rel in ("a.py", "csrc/k.cu", "_build/abc/lib.so", "sub/__pycache__/m.pyc", "sub/m.py"):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(rel)
    dst = chip_smoke.readonly_copy(str(src), str(tmp_path / "img" / "pkg"))
    files = sorted(os.path.relpath(os.path.join(d, f), dst)
                   for d, _, fs in os.walk(dst) for f in fs)
    assert files == ["a.py", "csrc/k.cu", "sub/m.py"]
    assert open(os.path.join(dst, "csrc/k.cu")).read() == "csrc/k.cu"
    for d, dirs, fs in os.walk(dst):
        for name in [d, *(os.path.join(d, f) for f in fs)]:
            assert os.stat(name).st_mode & 0o222 == 0, name
    # a second copy over the first clears it (the next run's)
    (src / "b.py").write_text("b")
    chip_smoke.readonly_copy(str(src), dst)
    assert os.path.exists(os.path.join(dst, "b.py"))
    chip_smoke.make_writable(dst)
    assert os.stat(os.path.join(dst, "a.py")).st_mode & 0o200


def test_tree_state_sees_a_write(tmp_path):
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "f").write_text("x")
    before = chip_smoke.tree_state(str(tmp_path))
    assert set(before) == {"d", os.path.join("d", "f")}
    assert chip_smoke.tree_state(str(tmp_path)) == before
    (tmp_path / "d" / "__pycache__").mkdir()
    after = chip_smoke.tree_state(str(tmp_path))
    assert set(after) - set(before) == {os.path.join("d", "__pycache__")}


def _shared_objects() -> list:
    import _ctypes
    import sysconfig

    libs = [_ctypes.__file__]
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    if ldlib.endswith(".so") or ".so." in ldlib:
        libs.append(os.path.join(libdir, ldlib))
    import torch

    libs += [os.path.join(os.path.dirname(torch.__file__), "lib", n)
             for n in ("libc10.so", "libtorch_python.so")]
    return [p for p in libs if os.path.isfile(p)]


@pytest.mark.parametrize("index", range(3))
def test_needed_libs_reads_what_readelf_lists(index):
    libs = _shared_objects()
    if index >= len(libs):
        pytest.skip("fewer shared objects on this host")
    needed = chip_smoke.needed_libs(libs[index])
    assert needed and all(n.endswith(tuple(".so" + s for s in ("", ".1", ".2", ".6")))
                          or ".so." in n for n in needed), needed


def test_needed_libs_refuses_what_is_no_elf(tmp_path):
    p = tmp_path / "x.so"
    p.write_bytes(b"#!/bin/sh\n")
    with pytest.raises(subprocess.CalledProcessError):
        chip_smoke.needed_libs(str(p))


def test_resident_share_and_evict(tmp_path):
    """A file just written is all in the page cache; after :func:`evict`
    the share is a fraction (how much the kernel drops depends on the file
    system: tmpfs keeps every page)."""
    p = tmp_path / "f.bin"
    p.write_bytes(os.urandom(5 * 4096 + 17))
    p.read_bytes()
    assert chip_smoke.resident_share(str(p)) == 1.0
    assert 0.0 <= chip_smoke.evict(str(p)) <= 1.0
    assert p.read_bytes()[:1] and chip_smoke.resident_share(str(p)) == 1.0
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    assert chip_smoke.resident_share(str(empty)) == 0.0


def test_imported_modules_reads_importtime():
    err = ("import time: self [us] | cumulative | imported package\n"
           "import time:       120 |        120 |   _io\n"
           "import time:        80 |       4000 | llama_fastapi_k8s_gpu_tpu_torch.utils.config\n"
           "import time:        10 |         10 |     torch._C\n"
           "some other line\n")
    assert chip_smoke.imported_modules(err) == {
        "imported package", "_io", "llama_fastapi_k8s_gpu_tpu_torch.utils.config", "torch._C"}
