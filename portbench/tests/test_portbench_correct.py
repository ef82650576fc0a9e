"""The comparison that decides ``correct`` fails where it must.

- The control (the float8 reference in the program's place) reads above
  the cell's limit, at a size a test run holds.
- A run with the timed path broken underneath (the harness's look for a
  chip skipped, everything else as in a run) comes out not correct, once
  for each fault the cell can have, while the sound run of the same size
  reads under the limit that the fault breaks.
"""

import pytest
import torch

from portbench import run as runmod
from portbench import spec
from portbench.traffic import stream, train

CPU = torch.device("cpu")
STREAM_TINY = {"height": 32, "width": 48, "batch": 4, "cycle": 8, "outstanding": 8,
               "queue_size": 12, "warmup_frames": 8, "sample": 64, "expected_fps": 20}
TRAIN_TINY = {"batch": 2, "size": 48, "pool": 4, "warmup_steps": 1}


def _ctx(name, tiny, seed):
    cell = spec.load_cell(name)
    cell["params"].update(tiny)
    return runmod.Ctx(cell=cell, config=spec.load_config(cell["config"]), seed=seed,
                      seconds=1.0, trace=False, device=CPU)


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 4000000007])
def test_stream_control_reads_above_the_limit(seed):
    limit = spec.load_cell("style.stream720")["limits"]["worst_frame_rms_gap"]
    assert stream.control(_ctx("style.stream720", STREAM_TINY, seed))["worst_frame_rms_gap"] > limit


def test_stream_sound_run_is_correct():
    res = runmod.run_cell("style.stream720", 23, 1.5, False, CPU, cell_override=STREAM_TINY)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_stream_broken_path_is_not_correct(fault):
    res = runmod.run_cell("style.stream720", 29, 1.5, False, CPU, fault=fault,
                          cell_override=STREAM_TINY)
    assert not res["correct"]
    gap = res["checks"]["worst_frame_rms_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("seed", [13, 2**31 + 6, 4000000009])
def test_train_control_fails_a_number(seed):
    limits = spec.load_cell("style_train.vgg16_256")["limits"]
    got = train.control(_ctx("style_train.vgg16_256", TRAIN_TINY, seed))
    assert any(got[k] > limits[k] for k in limits), got


def test_train_sound_run_is_correct():
    res = runmod.run_cell("style_train.vgg16_256", 31, 0.3, False, CPU, cell_override=TRAIN_TINY)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault,number", [("unchanged", "grad_gap"), ("unchanged", "change_gap"),
                                          ("half_batch", "grad_gap"),
                                          ("half_batch", "grad_diff_median")])
def test_train_broken_step_is_not_correct(fault, number):
    res = runmod.run_cell("style_train.vgg16_256", 31, 0.3, False, CPU, fault=fault,
                          cell_override=TRAIN_TINY)
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
