"""The BasicVSR++ cell (``basicvsrpp_x4.stream270``) at a tiny size on the
CPU: a sound run is correct, loses nothing and cuts no clip short while
the source is live; the faults planted under the timed path and the
float8 control read above the cell's limit; the counts are the published
net's."""

import pytest
import torch

from portbench import counts, spec
from portbench import run as runmod
from portbench.counts import basicvsrpp as vc
from portbench.traffic import vsr_stream

CPU = torch.device("cpu")
CELL = "basicvsrpp_x4.stream270"
TINY = {"height": 64, "width": 64, "batch": 3, "cycle": 6, "outstanding": 9,
        "queue_size": 12, "warmup_frames": 3, "sample": 2, "expected_fps": 4}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The forward is thousands of small ops; one intra-op thread keeps
    them off each other's barriers beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_sound_run_is_correct_and_traced():
    res = runmod.run_cell(CELL, 2**31 + 101, 1.0, True, CPU, cell_override=TINY)
    assert res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["frames_lost"]["value"] == 0 and checks["order_errors"]["value"] == 0
    assert checks["mid_stream_short_clips"]["value"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0
    d = res["detail"]
    assert d["tracer_dropped"] == 0 and d["vsr_stats"]["clips"] >= 2
    assert d["vsr_stats"]["dcn_calls"] == 4 * (TINY["batch"] - 1) * d["vsr_stats"]["clips"]
    assert "mfu.stream" in res["metrics"]         # the .vsr metrics read device spans


@pytest.mark.parametrize("fault", ["nearest", "zero_flow", "no_deform", "no_second_order"])
def test_planted_fault_is_not_correct(fault):
    res = runmod.run_cell(CELL, 2**31 + 103, 0.5, False, CPU, fault=fault, cell_override=TINY)
    gap = res["checks"]["worst_frame_rms_gap"]
    assert not res["correct"] and gap["value"] > gap["limit"]


def test_control_reads_above_the_limit():
    cell = spec.load_cell(CELL)
    cell["params"].update(TINY)
    ctx = runmod.Ctx(cell=cell, config=spec.load_config(cell["config"]), seed=2**31 + 107,
                     seconds=1.0, trace=False, device=CPU)
    assert vsr_stream.control(ctx)["worst_frame_rms_gap"] > cell["limits"]["worst_frame_rms_gap"]


def test_counts_are_the_published_net():
    cfg = spec.load_config("basicvsrpp_x4")
    ops = vc.frame(cfg, 270, 480)
    total = counts.flops(ops)
    assert total == pytest.approx(1.876e12, rel=2e-3)
    dcn = vc.dcn_ops(cfg, 270, 480)
    # 4 passes × 7 of 8 steps, each 2·9·128·64 FLOPs an output pixel.
    assert counts.flops(dcn) == pytest.approx(4 * 7 / 8 * 2 * 9 * 128 * 64 * 270 * 480)
    one = vc.DeformConv(128, 64, 16, 270, 480)
    px = 270 * 480
    assert one.bytes(2) == 2 * (px * (128 + 64) + 9 * 128 * 64) + 4 * px * 27 * 16
