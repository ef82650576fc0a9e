"""The port's roofline model of the neural filters
(``dvf_tpu_torch.models.analysis``), held to the JAX package's
(``dvf_tpu.models.analysis``): the same layers with the same FLOPs and
HBM bytes, which do not depend on the hardware, and the H100's
tensor-core tiling and peaks in place of the TPU's systolic array."""

import json

import pytest

import dvf_tpu.models.analysis as ref
import dvf_tpu_torch.models.analysis as an
from dvf_tpu_torch.runtime import cost

GEOMETRIES = [(720, 1280), (540, 960)]


def _same_layers(ours, theirs):
    assert [l.name for l in ours] == [l.name for l in theirs]
    for a, b in zip(ours, theirs):
        assert (a.kind, a.h, a.w, a.cin, a.cout, a.ksize) == \
            (b.kind, b.h, b.w, b.cin, b.cout, b.ksize), a.name
        assert a.flops == b.flops, a.name
        assert a.hbm_bytes == b.hbm_bytes, a.name


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_style_layers_equal_the_references(h, w, bf16):
    _same_layers(an.style_layer_costs(h, w, bf16=bf16),
                 ref.style_layer_costs(h, w, bf16=bf16))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_espcn_layers_equal_the_references(h, w, bf16):
    _same_layers(an.espcn_layer_costs(h, w, bf16=bf16),
                 ref.espcn_layer_costs(h, w, bf16=bf16))


def test_macs_per_pixel_totals():
    """153,792 MAC per pixel (style, c 32, r 5) and 26,688 per
    low-resolution pixel (ESPCN x2): the closed forms chip_smoke.py's
    bounds used before they read these counters."""
    c, r = 32, 5
    style = (81 * 3 * c + 9 * c * 2 * c // 4 + 9 * 2 * c * 4 * c // 16
             + 2 * r * 9 * 16 * c * c // 16 + 9 * 4 * c * 2 * c // 4
             + 9 * 2 * c * c + 81 * c * 3)
    espcn = 25 * 3 * 64 + 9 * 64 * 32 + 9 * 32 * 3 * 2 * 2
    assert cost.style_macs_per_pixel() == style == 153_792
    assert cost.espcn_macs_per_pixel() == espcn == 26_688
    h, w = 720, 1280
    assert sum(l.flops for l in an.style_layer_costs(h, w)) == 2 * 153_792 * h * w
    h, w = 540, 960
    assert sum(l.flops for l in an.espcn_layer_costs(h, w)) == 2 * 26_688 * h * w


def test_tensor_core_tiling_model():
    """cuDNN pads channels to 8; wgmma fills N in steps of 8, K in steps
    of 16 (bf16), M in 64-row tiles."""
    out = an.conv_cost("out", 720, 1280, 32, 3, 9)
    assert out.n_eff == 3 / 8
    assert out.k_eff == 1.0                      # 81 x 32 = 2592 = 162 x 16
    stem = an.conv_cost("stem", 720, 1280, 3, 32, 9)
    assert stem.n_eff == 1.0
    assert stem.k_eff == 243 / 656               # 81 x 8 = 648 → 656
    trunk = an.conv_cost("trunk", 180, 320, 128, 128, 3)
    assert trunk.n_eff == trunk.k_eff == 1.0
    assert trunk.tc_ms == pytest.approx(trunk.flops / 989e12 * 1e3)
    assert trunk.hbm_ms == pytest.approx(trunk.hbm_bytes / 3.35e12 * 1e3)
    # float32 (TF32 off) runs on the CUDA cores: only the channel pad
    f32 = an.conv_cost("f32", 64, 64, 3, 32, 9, dtype_bytes=4, bf16=False)
    assert f32.tc_ms == pytest.approx(f32.flops / (67e12 * 3 / 8) * 1e3)
    for layer in an.style_layer_costs(720, 1280) + an.espcn_layer_costs(540, 960):
        assert 0 < layer.n_eff <= 1 and 0 < layer.k_eff <= 1
        assert layer.bound in ("tensor", "hbm")
        assert layer.ideal_ms == max(layer.tc_ms, layer.hbm_ms)
    # A Cout = 3 head wastes far less of a wgmma N step than of a
    # 128-lane systolic array.
    assert out.n_eff > ref.conv_cost("out", 720, 1280, 32, 3, 9).lane_eff


def test_summarize_keys_and_verdict():
    layers = an.style_layer_costs(720, 1280)
    s = an.summarize(layers, label="style")
    theirs = ref.summarize(ref.style_layer_costs(720, 1280), label="style")
    assert s["total_gflops_per_frame"] == theirs["total_gflops_per_frame"]
    assert s["total_hbm_mb_per_frame"] == theirs["total_hbm_mb_per_frame"]
    assert s["serial_ideal_ms"] == pytest.approx(
        sum(l.ideal_ms for l in layers), abs=1e-4)
    assert 0 < s["mfu_at_ideal"] <= 1.0
    fast = an.summarize(layers, measured_ms=s["serial_ideal_ms"], label="x")
    assert fast["verdict"] == "transfer/arithmetic-bound"
    assert fast["mfu_measured"] == pytest.approx(s["mfu_at_ideal"], abs=2e-4)
    slow = an.summarize(layers, measured_ms=10 * s["serial_ideal_ms"], label="x")
    assert slow["lowering_gap_x"] == 10.0
    assert slow["verdict"].startswith("lowering-bound")
    assert "measured_ms_per_frame" not in s


def test_main_json_takes_the_measured_ms_from_the_caller(capsys, tmp_path):
    md = tmp_path / "roof.md"
    assert an.main(["--json", "--measured", "style_720p=5.0",
                    "--md-out", str(md)]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert doc["style_720p"]["measured_ms_per_frame"] == 5.0
    assert "measured_ms_per_frame" not in doc["sr2x_540p"]
    text = md.read_text()
    assert "| stem 9x9 3→32 |" in text and "989 dense bf16" in text
    for bad in ("style_720p", "style_720p=x", "flow_720p=1.0"):
        with pytest.raises(SystemExit, match="bad --measured"):
            an.main(["--measured", bad])


def test_analysis_reads_no_bench_table():
    """The TPU's committed bench table is not the port's: the module has
    no reader of it."""
    assert not hasattr(an, "_measured_ms")
    import inspect

    assert "BENCH_TABLE" not in inspect.getsource(an)
