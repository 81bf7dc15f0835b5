"""The pure helpers of ``chip_smoke.py`` (the H100 smoke run at the repo
root): the cold timings' copy count and call rotation, the decode
token's recipe of fused matmul calls that its ``fused_token`` lines sum,
the looped kernel's bound and ``loop_positions`` line, the synthetic
files' random blocks of every type, the mixed-type file's spread and the
Mistral file's SentencePiece vocabulary.
These run on the CPU; the timings themselves need the card."""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


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
