"""The yardstick's arithmetic on made-up numbers and against hand counts."""

from __future__ import annotations

import pytest

from benchmark import counts
from benchmark.timing import busy, gaps, intervals_between, label_at, percentile, union


def test_percentile_pools_all_values():
    values = [float(v) for v in range(1, 101)]     # 1..100
    assert percentile(values, 95) == pytest.approx(95.05)
    assert percentile(values, 50) == pytest.approx(50.5)
    assert percentile([3.0], 95) == 3.0


def test_step_times_from_step_ends():
    assert intervals_between([0.0, 10.0, 25.0, 26.0]) == [10.0, 15.0, 1.0]


def test_rate_and_p95_on_made_up_steps():
    from benchmark.run import end_to_end

    ranks = [{"window": {"images": 1280, "wall_s": 2.0, "step_ms": [100.0] * 19 + [300.0]}},
             {"window": {"images": 640, "wall_s": 1.0, "step_ms": [110.0] * 20}}]
    out = end_to_end("train", ranks, 5.0)
    assert out["train_images_per_s"][0] == pytest.approx(640 + 640)
    pooled = sorted([100.0] * 19 + [300.0] + [110.0] * 20)
    assert out["train_step_p95_ms"][0] == pytest.approx(percentile(pooled, 95))
    assert out["setup_s"][0] == 5.0


def test_idle_union():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 11.0)]
    assert union(iv, 0.0, 10.0) == [(0.0, 2.0), (3.0, 4.0), (9.0, 10.0)]
    assert busy(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert gaps(iv, -1.0, 10.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 9.0)]
    spans = [("step", 1.5, 8.0), ("loader_next", 4.0, 5.0)]
    assert label_at(4.5, spans) == "loader_next"
    assert label_at(2.5, spans) == "step"
    assert label_at(9.5, spans) == "outside the spans"


def test_convnext_b_forward_flops_by_hand():
    # 260 px: stages at 65, 33, 17, 9
    assert counts.convnext_stage_sizes((260, 260)) == [(65, 65), (33, 33), (17, 17), (9, 9)]
    hand = 2 * 65 * 65 * 128 * 48                                   # stem
    hand += 2 * 33 * 33 * 256 * 128 * 4 + 2 * 17 * 17 * 512 * 256 * 4 \
        + 2 * 9 * 9 * 1024 * 512 * 4                                # downsamples
    for hw, depth, c in ((65 * 65, 3, 128), (33 * 33, 3, 256), (17 * 17, 27, 512),
                         (9 * 9, 3, 1024)):
        hand += depth * hw * (2 * 49 * c + 2 * c * 4 * c * 2)       # dw, fc1, fc2
    hand += 2 * 1024 * 44 + 2 * 44 * (256 + 512 + 1024)             # head, aux heads
    got = counts.convnext_forward_flops((3, 3, 27, 3), (128, 256, 512, 1024), (260, 260),
                                        44, True)
    assert got == hand
    assert 44e9 < got < 46e9      # ~45.2 GFLOP a forward, ~135.6 a trained image


@pytest.mark.parametrize("m,c,bound_ms", [
    (1081600, 128, 0.2867), (278784, 256, 0.2956), (73984, 512, 0.3138)])
def test_block_tail_forward_matches_the_kernel_table(m, c, bound_ms):
    # PERF.md's kernel table, row 1, inference: operations bound these
    least = counts.least_seconds(*counts.block_tail_work(m, c, False), counts.PEAK_BF16_FLOPS)
    assert least * 1e3 == pytest.approx(bound_ms, abs=5e-5)


def test_block_tail_bytes_by_hand():
    ops, nbytes = counts.block_tail_work(100, 8, False)
    assert ops == 16 * 100 * 64 and nbytes == 6 * 100 * 8 + 16 * 64
    ops, nbytes = counts.block_tail_work(100, 8, True)
    assert ops == 32 * 100 * 64 and nbytes == 6 * 100 * 8 + 48 * 64


@pytest.mark.parametrize("n,h,c,which,bound_ms", [
    (256, 65, 128, "fwd", 0.2025), (256, 33, 256, "fwd", 0.1044),
    (256, 17, 512, "fwd", 0.0554), (256, 9, 1024, "fwd", 0.0311),
    (16, 65, 128, "dw", 0.0127), (16, 33, 256, "dw", 0.0065)])
def test_dwconv_matches_the_kernel_table(n, h, c, which, bound_ms):
    # PERF.md's kernel table, rows 3 and 4: operations at 67 TFLOP/s bound these
    least = counts.least_seconds(*counts.dwconv_work(n, h, h, c, which), counts.PEAK_F32_FLOPS)
    assert least * 1e3 == pytest.approx(bound_ms, abs=5e-5)


def test_dwconv_bytes_by_hand():
    assert counts.dwconv_work(2, 3, 4, 5, "fwd") == (98 * 120, 4 * 120 + 98 * 5)
    assert counts.dwconv_work(2, 3, 4, 5, "dw") == (98 * 120, 4 * 120 + 196 * 5)


def _ctx(role, traces_steps=(), images=1000, wall=2.0, chips=1):
    from benchmark.spec import Spec
    from benchmark.tests.conftest import ROOT

    spec = Spec(ROOT)
    cfg = spec.config("convnext_b_v4")["config"]
    traffic = spec.traffic("predict_3fold_scale4_b64" if role == "predict" else "train_epochs")
    return {"role": role, "cfg": cfg, "traffic": traffic, "chips": chips,
            "ranks": [{"images": images, "wall_s": wall, "steps": 10, "loader_wait_ms": 1.0,
                       "trace": None}] * chips}


def test_train_mfu_by_hand():
    from benchmark.rooflines import mfu_pct

    ctx = _ctx("train", images=1000, wall=1.0)
    flops = 3 * counts.convnext_forward_flops((3, 3, 27, 3), (128, 256, 512, 1024),
                                              (260, 260), 44, True)
    assert mfu_pct(ctx, "train") == pytest.approx(100 * flops * 1000 / 989e12)
    assert mfu_pct(ctx, "predict") is None


def test_predict_mfu_counts_every_model_and_view():
    from benchmark.rooflines import mfu_pct

    ctx = _ctx("predict", images=100, wall=1.0)
    fwd = counts.convnext_forward_flops((3, 3, 27, 3), (128, 256, 512, 1024), (260, 260),
                                        44, True)
    assert mfu_pct(ctx, "predict") == pytest.approx(100 * fwd * 3 * 4 * 100 / 989e12)


def test_roofline_reads_the_named_kernels_only():
    from benchmark.rooflines import block_tail_least_s, roofline_pct
    from benchmark.trace import Trace

    ctx = _ctx("train")
    least = block_tail_least_s(ctx, 512)
    tr = Trace(0.0, 1.0, [("void (anonymous namespace)::gemm_kernel<X>", 0.0, least),
                          ("other", 0.0, 0.5)], steps=1)
    ctx["ranks"] = [dict(ctx["ranks"][0], trace=tr)]
    assert roofline_pct(ctx, "train", ("namespace)::gemm_kernel<",), least) == \
        pytest.approx(100.0)
    assert roofline_pct(ctx, "train", ("absent",), least) is None
