"""The HAT cell (``hat_srx4.stream270``) at a tiny size on the CPU: a sound
run is correct and loses nothing, the faults planted under the timed path
and the float8 control read above the cell's limit, and the counts are
the published net's."""

import pytest
import torch

from portbench import counts, spec
from portbench import run as runmod
from portbench.counts import hat as hc
from portbench.traffic import sr_stream

CPU = torch.device("cpu")
CELL = "hat_srx4.stream270"
TINY = {"height": 16, "width": 30, "cycle": 4, "outstanding": 2, "queue_size": 4,
        "warmup_frames": 2, "sample": 2, "expected_fps": 2}


def test_sound_run_is_correct_and_traced():
    res = runmod.run_cell(CELL, 2**31 + 101, 1.0, True, CPU, cell_override=TINY)
    assert res["correct"], res["checks"]
    assert res["checks"]["frames_lost"]["value"] == 0
    assert res["checks"]["clipped_share"]["value"] <= res["checks"]["clipped_share"]["limit"]
    assert res["attempted"] > 0 and res["failed"] == 0
    d = res["detail"]
    assert d["tracer_dropped"] == 0 and d["hat_stats"]["sdpa_backend"] == "cpu default"
    assert "mfu.hat" in res["metrics"]            # the device metrics need a card


@pytest.mark.parametrize("fault", ["nearest", "no_window_attn", "no_cab"])
def test_planted_fault_is_not_correct(fault):
    res = runmod.run_cell(CELL, 2**31 + 103, 0.5, False, CPU, fault=fault, cell_override=TINY)
    gap = res["checks"]["worst_frame_rms_gap"]
    assert not res["correct"] and gap["value"] > gap["limit"]


def test_control_reads_above_the_limit():
    cell = spec.load_cell(CELL)
    cell["params"].update(TINY)
    ctx = runmod.Ctx(cell=cell, config=spec.load_config(cell["config"]), seed=2**31 + 107,
                     seconds=1.0, trace=False, device=CPU)
    assert sr_stream.control(ctx)["worst_frame_rms_gap"] > cell["limits"]["worst_frame_rms_gap"]


def test_counts_are_the_published_net():
    cfg = spec.load_config("hat_srx4")
    ops = hc.frame(cfg, 270, 480)                 # padded to 272 x 480
    total = counts.flops(ops)
    assert total == pytest.approx(6.622e12, rel=1e-3)
    assert total / (272 * 480) == pytest.approx(50.72e6, rel=1e-3)
    att = sum(o.flops for o in ops if isinstance(o, hc.Attention))
    assert att / total == pytest.approx(0.18, abs=0.005)
    # One window attention of a frame: 4 * 256 keys * 180 * tokens; its bytes
    # q, k, v and out once in bf16, plus the 31^2 x 6 table.
    a = hc.Attention(272 * 480, 256, 180, 31 * 31 * 6)
    assert a.flops == 4 * 256 * 180 * 130560
    assert a.bytes(2) == 2 * (4 * 130560 * 180 + 5766)
