"""The benchmark's arithmetic on synthetic inputs: the device-interval
union and idle share, percentiles and spreads, the attribution of kernels
to host ranges by launch correlation, and the roofline's counts against
hand counts at full width."""

import math

import pytest

from perfbench.harness import peaks, stats, trace
from perfbench.reference import mvit, x3d
from perfbench.tests.bench_copy import REPO

import json

MVIT = json.loads((REPO / "perfbench/configs/mvit_base_16x4.json").read_text())["model"]


def op(name, ts, dur, cat="kernel", corr=None, tid=7):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_union_merges_overlaps_and_clips_to_the_window():
    spans = [(0, 10), (5, 12), (20, 30), (29, 31), (40, 50)]
    assert trace.merge(spans) == [(0, 12), (20, 31), (40, 50)]
    assert trace.busy(spans, 2, 45) == pytest.approx(10 + 11 + 5)
    assert trace.idle_gaps(spans, 2, 45) == [(12, 20), (31, 40)]


def test_idle_share_of_a_window_leaves_out_annotations_and_full_buffers():
    events = [op("perfbench.window", 100, 100, cat="user_annotation", tid=1),
              op("k1", 110, 30), op("k2", 130, 20, cat="gpu_memcpy"),
              op("perfbench.window", 100, 100, cat="gpu_user_annotation"),
              op("Command Buffer Full", 150, 40, cat="kernel"),
              op("k3", 190, 30)]
    busy_us, window_us = trace.idle_share(events, "perfbench.window")
    assert (busy_us, window_us) == (40 + 10, 100)


def test_idle_share_is_none_without_device_work():
    events = [op("perfbench.window", 0, 10, cat="user_annotation")]
    assert trace.idle_share(events, "perfbench.window") is None


def test_idle_a_request_reads_the_traced_busy_time_against_the_untraced_median():
    from types import SimpleNamespace

    from perfbench.harness.idle import idle_per_request_percent

    run = SimpleNamespace(busy=(3000.0, 9000.0), traffic={"traced_requests": 3},
                          window={"latencies_s": [0.002, 0.004, 0.0025]}, note=lambda line: None)
    assert idle_per_request_percent(run) == pytest.approx(100.0 * (1 - 1000.0 / 2500.0))
    run.busy = None
    assert idle_per_request_percent(run) is None


def test_percentile_over_all_values_and_the_quartile_spread():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    assert stats.percentile(values, 50) == pytest.approx(50.5)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.spread([10, 10, 10, 10]) == 0.0
    assert stats.spread([1, 2, 3, 4, 5, 6, 7]) == pytest.approx((6 - 2) / 4)


def test_kernels_go_to_the_range_their_launch_lies_in_whatever_their_names():
    events = [
        op("perfbench.unit.a", 0, 100, cat="user_annotation", tid=1),
        op("perfbench.unit.b", 100, 50, cat="user_annotation", tid=1),
        op("perfbench.unit.b.inner", 110, 10, cat="user_annotation", tid=1),
        op("cudaLaunchKernel", 10, 2, cat="cuda_runtime", corr=1, tid=1),
        op("cudaLaunchKernel", 60, 2, cat="cuda_runtime", corr=2, tid=1),
        op("cudaMemcpyAsync", 105, 2, cat="cuda_runtime", corr=3, tid=1),
        op("cuLaunchKernel", 112, 2, cat="cuda_driver", corr=4, tid=1),
        op("cudaLaunchKernel", 170, 2, cat="cuda_runtime", corr=5, tid=1),
        op("cudaLaunchKernel", 20, 2, cat="cuda_runtime", corr=6, tid=2),
        op("same_name", 200, 30, corr=1), op("same_name", 240, 5, corr=2),
        op("Memcpy DtoD", 250, 7, cat="gpu_memcpy", corr=3),
        op("other", 260, 11, corr=4), op("late", 300, 13, corr=5), op("x", 320, 17, corr=6),
    ]
    got = trace.attribute(events, "perfbench.unit.")
    assert got == {"perfbench.unit.a": [35.0], "perfbench.unit.b": [7.0],
                   "perfbench.unit.b.inner": [11.0]}


def test_breakdown_names_device_ops_and_the_host_in_the_gaps():
    events = [op("perfbench.window", 0, 100, cat="user_annotation", tid=1),
              op("cudaStreamSynchronize", 40, 30, cat="cuda_runtime", tid=1),
              op("aten::copy_", 80, 15, cat="cpu_op", tid=1),
              op("gemm", 0, 40), op("gemm", 70, 10), op("norm", 95, 5)]
    got = trace.breakdown(events, "perfbench.window")
    assert got["device_ops"] == [["gemm", 50e-6], ["norm", 5e-6]]
    assert got["idle_gaps"] == [["cudaStreamSynchronize", 30e-6], ["aten::copy_", 15e-6]]


def test_conv_b_counts_at_x3d_s_stage_2_full_width():
    # Block 1 of stage 2 at B128 in bf16: (128, 108, 13, 20, 20) in and out.
    n = 128 * 108 * 13 * 20 * 20
    flops, nbytes = x3d.conv_b_work((128, 108, 13, 20, 20), (128, 108, 13, 20, 20), 2)
    assert flops == 2 * 27 * n == 3881779200
    assert nbytes == 2 * (2 * n + 27 * 108 + 108) == 287545248
    least, by = peaks.least_s(flops, nbytes)
    assert by == "bytes" and least == pytest.approx(287545248 / 3.35e12)


def test_attention_counts_at_mvit_b_block_1_full_width():
    # Block 1 at B32: grid 8x56x56 of width 192 in two heads of 96; q pools
    # 1x2x2 to 8x28x28, k and v 1x4x4 to 8x14x14; every pool 3x3x3.
    B, d, c, L, Lq, Lk = 32, 192, 96, 8 * 56 * 56, 8 * 28 * 28, 8 * 14 * 14
    flops, nbytes, q_thw = mvit.attention_work(MVIT, 1, B, (8, 56, 56), 2)
    assert q_thw == (8, 28, 28)
    hand_flops = (3 * 2 * B * (L + 1) * d * d        # q, k, v projections
                  + 2 * 27 * B * Lq * d               # q pool
                  + 2 * 2 * 27 * B * Lk * d           # k and v pools
                  + 2 * 2 * B * (Lq + 1) * (Lk + 1) * d  # QK^T and PV over both heads
                  + 2 * B * (Lq + 1) * d * d)         # output projection
    assert flops == hand_flops
    hand_weights = 4 * (d * d + d) + 3 * (27 * c + 2 * c)
    assert nbytes == 2 * (B * (L + 1) * d + B * (Lq + 1) * d + hand_weights)
    least, by = peaks.least_s(flops, nbytes)
    assert by == "operations" and least == pytest.approx(hand_flops / 989e12)


def test_forward_flops_are_the_published_per_clip_counts():
    x3d_model = json.loads((REPO / "perfbench/configs/x3d_s.json").read_text())["model"]
    assert x3d.flops_per_clip(x3d_model) / 1e9 == pytest.approx(3.93, abs=0.01)
    assert mvit.flops_per_clip(MVIT) / 1e9 == pytest.approx(141.2, abs=0.1)
    assert not math.isnan(x3d.flops_per_clip(x3d_model))
