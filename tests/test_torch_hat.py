"""HAT-SRx4 in the port (``models/hat.py``, ``super_resolution(arch="hat")``)
held to the benchmark's plain float32 reference (``portbench/reference/
hat.py``, written apart from the port), on the CPU at small shapes: the
whole net at a tiny width, the shifted-window and overlapping attention
against brute force over the whole frame, the pad and crop, the filter's
entry, spans and counters. The JAX package has no HAT, so the reference
here is the benchmark's."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dvf_tpu_torch
from dvf_tpu_torch.models import hat
from dvf_tpu_torch.models.espcn import EspcnConfig, apply_espcn, init_espcn
from dvf_tpu_torch.obs.trace import Tracer
from dvf_tpu_torch.ops.sr import super_resolution
from portbench.reference import hat as ref

TINY = hat.HatConfig(window_size=4, compress_ratio=3, squeeze_factor=3, depths=(2, 2),
                     embed_dim=12, num_heads=(2, 2), num_feat=8,
                     compute_dtype=torch.float32)
TINY_NET = dict(upscale=4, in_chans=3, window_size=4, compress_ratio=3, squeeze_factor=3,
                conv_scale=0.01, overlap_ratio=0.5, img_range=1.0, depths=[2, 2],
                embed_dim=12, num_heads=[2, 2], mlp_ratio=2.0, num_feat=8,
                rgb_mean=[0.4488, 0.4371, 0.4040])
CPU = torch.device("cpu")


def _frames(seed, b, h, w):
    return torch.rand((b, h, w, 3), generator=torch.Generator().manual_seed(seed))


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def test_float32_matches_the_reference():
    params = hat.init_hat(3, TINY)
    x = _frames(1, 2, 14, 22)                    # neither side a multiple of the window
    got = hat.apply_hat(params, x, TINY)
    want = ref.forward(params, x, TINY_NET, block=5)
    assert got.shape == want.shape == (2, 56, 88, 3)
    assert float((got - want.clamp(0, 1)).abs().max()) <= 2e-5


def test_bfloat16_matches_the_reference_within_rounding():
    params = hat.init_hat(4, TINY)
    x = _frames(2, 1, 14, 22)
    got = hat.apply_hat(params, x, dataclasses.replace(TINY, compute_dtype=torch.bfloat16))
    want = ref.forward(params, x, TINY_NET).clamp(0, 1)
    # bf16 keeps 8 bits of mantissa: every conv, linear and residual sum
    # rounds at ~2^-9 relative, over a dozen layers on a stream of unit
    # size (measured: max 2.0e-3, RMS 4e-4).
    assert float((got - want).abs().max()) <= 1e-2
    assert float(torch.sqrt(((got - want) ** 2).mean())) <= 2e-3


def test_the_benchmarks_weights_fit_the_port():
    """The benchmark draws its own weights (``make_params``) in the
    port's layout: the same layers, leaves and shapes as ``init_hat``."""
    mine, theirs = hat.init_hat(5, TINY), ref.make_params(TINY_NET, 5, CPU, cab_conv_gain=6.0)
    assert mine.keys() == theirs.keys()
    for layer in mine:
        assert mine[layer].keys() == theirs[layer].keys(), layer
        for leaf in mine[layer]:
            assert mine[layer][leaf].shape == theirs[layer][leaf].shape, (layer, leaf)
    x = _frames(3, 1, 8, 12)
    got = hat.apply_hat(theirs, x, TINY)
    assert float((got - ref.forward(theirs, x, TINY_NET).clamp(0, 1)).abs().max()) <= 2e-5


@pytest.mark.parametrize("h,w", [(16, 24), (13, 21), (4, 4)])
def test_output_is_four_times_the_input_after_pad_and_crop(h, w):
    params = hat.init_hat(6, TINY)
    y = hat.apply_hat(params, _frames(4, 1, h, w), TINY)
    assert y.shape == (1, 4 * h, 4 * w, 3) and y.dtype == torch.float32
    assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0


def _branch_only(leaves, keep):
    """A block's leaves with every branch but ``keep`` zeroed at its last
    layer, so the block returns its input plus that branch."""
    out = dict(leaves)
    for name in {"window_attn": ("cab2", "fc2"), "ocab": ("fc2",)}[keep]:
        out[name + ".w"] = torch.zeros_like(leaves[name + ".w"])
        out[name + ".b"] = torch.zeros_like(leaves[name + ".b"])
    return out


def _qkv(leaves, x):
    xn = _ln(x, leaves["norm1.w"], leaves["norm1.b"])
    return F.linear(xn, leaves["qkv.w"], leaves["qkv.b"]).chunk(3, dim=-1)


def _attend(q, k, v, bias, allowed, heads, proj_w, proj_b):
    """Brute force over explicit token sets: q (n, c), k and v (m, c),
    bias (heads, n, m), allowed (n, m)."""
    n, c = q.shape
    d = c // heads
    out = []
    for h in range(heads):
        s = q[:, h * d:(h + 1) * d] @ k[:, h * d:(h + 1) * d].T * d ** -0.5 + bias[h]
        s = s.masked_fill(~allowed, float("-inf"))
        out.append(torch.softmax(s, -1) @ v[:, h * d:(h + 1) * d])
    return F.linear(torch.cat(out, -1), proj_w, proj_b)


def test_shifted_window_attention_matches_brute_force_over_the_frame():
    """A shifted block's attention against a brute-force attention over
    every token pair of the padded frame: a pair attends where its two
    tokens share a window of the rolled canvas and a region of the
    published mask; the bias is the table's entry for their offset."""
    ws, s, hp, wp = TINY.window_size, TINY.window_size // 2, 16, 24
    params = hat.init_hat(7, TINY)
    leaves = _branch_only(params["g0.hab1"], "window_attn")
    x = torch.randn(1, hp, wp, TINY.embed_dim, generator=torch.Generator().manual_seed(8))
    prep = hat.prepare_hat({**params, "g0.hab1": leaves}, TINY, CPU)
    geom = hat._Geometry(prep, TINY, 1, hp, wp, CPU)
    got = hat._hab(prep["g0.hab1"], x, TINY, geom, hat._Attend(geom, None), True, "g0.hab1",
                   hat._NoMarks()) - x

    rolled = torch.roll(x, (-s, -s), (1, 2)).reshape(-1, TINY.embed_dim)
    q, k, v = _qkv(leaves, rolled)
    rows, cols = torch.meshgrid(torch.arange(hp), torch.arange(wp), indexing="ij")
    rows, cols = rows.reshape(-1), cols.reshape(-1)
    window = (rows // ws) * (wp // ws) + cols // ws
    region = hat._region_labels(hp, wp, ws, s).reshape(-1)
    allowed = (window[:, None] == window[None, :]) & (region[:, None] == region[None, :])
    dr = (rows[:, None] - rows[None, :]).clamp(-ws + 1, ws - 1) + ws - 1
    dc = (cols[:, None] - cols[None, :]).clamp(-ws + 1, ws - 1) + ws - 1
    bias = leaves["rpb"][dr * (2 * ws - 1) + dc].permute(2, 0, 1)
    o = _attend(q, k, v, bias, allowed, 2, leaves["proj.w"], leaves["proj.b"])
    want = torch.roll(o.view(1, hp, wp, -1), (s, s), (1, 2))
    assert float((got - want).abs().max()) <= 1e-5


def test_overlapping_attention_matches_brute_force_gather():
    """OCAB at window 4 and overlap window 6: each query window against
    the keys of its zero-padded 6×6 neighbourhood, gathered token by
    token, the bias indexed as the published ``calculate_rpi_oca``."""
    ws, wse, hp, wp = 4, 6, 12, 16
    r = (wse - ws) // 2
    params = hat.init_hat(9, TINY)
    leaves = _branch_only(params["g1.ocab"], "ocab")
    x = torch.randn(1, hp, wp, TINY.embed_dim, generator=torch.Generator().manual_seed(10))
    prep = hat.prepare_hat({**params, "g1.ocab": leaves}, TINY, CPU)
    geom = hat._Geometry(prep, TINY, 1, hp, wp, CPU)
    got = hat._ocab(prep["g1.ocab"], x, TINY, hat._Attend(geom, None), "g1.ocab",
                    hat._NoMarks()) - x

    q, k, v = (t.view(hp, wp, -1) for t in _qkv(leaves, x.view(-1, TINY.embed_dim)))
    kp, vp = (F.pad(t, (0, 0, r, r, r, r)) for t in (k, v))
    n_table = (ws + wse - 1) ** 2
    want = torch.zeros(hp, wp, TINY.embed_dim)
    for wr in range(hp // ws):
        for wc in range(wp // ws):
            qs = [(wr * ws + i, wc * ws + j) for i in range(ws) for j in range(ws)]
            ks = [(wr * ws + i, wc * ws + j) for i in range(wse) for j in range(wse)]
            bias = torch.empty(2, len(qs), len(ks))
            for a, (qi, qj) in enumerate(qs):
                for b, (ki, kj) in enumerate(ks):
                    ro, co = ki - wr * ws - (qi - wr * ws), kj - wc * ws - (qj - wc * ws)
                    idx = (ro + ws - wse + 1) * (ws + wse - 1) + (co + ws - wse + 1)
                    bias[:, a, b] = leaves["rpb"][idx % n_table]
            o = _attend(torch.stack([q[i, j] for i, j in qs]),
                        torch.stack([kp[i, j] for i, j in ks]),
                        torch.stack([vp[i, j] for i, j in ks]), bias,
                        torch.ones(len(qs), len(ks), dtype=torch.bool), 2,
                        leaves["proj.w"], leaves["proj.b"])
            for a, (i, j) in enumerate(qs):
                want[i, j] = o[a]
    assert float((got[0] - want).abs().max()) <= 1e-5


def test_default_super_resolution_is_espcn_unchanged():
    filt = super_resolution()
    assert filt.name == "super_resolution(x2)"
    x = _frames(11, 2, 12, 16)
    state = filt.init_state((2, 12, 16, 3), torch.float32, CPU)
    got, _ = filt.fn(x, state)
    cfg = EspcnConfig(scale=2, compute_dtype=torch.bfloat16)
    assert torch.equal(got, apply_espcn(init_espcn(0, cfg), x, cfg))


@pytest.mark.parametrize("kw", [{"arch": "hat", "scale": 2}, {"arch": "hat"},
                                {"arch": "swinir", "scale": 4}])
def test_bad_arch_or_scale_raises(kw):
    with pytest.raises(ValueError):
        dvf_tpu_torch.get_filter("super_resolution", **kw)


def test_dtype_is_checked_before_arch():
    with pytest.raises(ValueError, match="dtype"):
        super_resolution(dtype="int8", arch="hat", scale=4)


def test_hat_filter_names_itself_and_leaves_the_registry_alone():
    before = dvf_tpu_torch.list_filters()
    filt = dvf_tpu_torch.get_filter("super_resolution", arch="hat", scale=4)
    assert filt.name == "super_resolution(hat,x4)" and filt.stateful
    assert dvf_tpu_torch.list_filters() == before


@pytest.fixture(scope="module")
def tiny_hat_filter():
    """The HAT filter at the published widths on a 16×16 frame, with the
    tiny config's weights swapped for speed: the filter body is the one
    ``super_resolution(arch="hat")`` builds."""
    def build(tracer):
        filt = super_resolution(scale=4, arch="hat", tracer=tracer)
        step = filt.fn
        step.config = TINY
        state = hat.prepare_hat(hat.init_hat(12, TINY), TINY, CPU)
        return step, state
    return build


def test_enabled_tracer_records_the_six_spans_and_counters(tiny_hat_filter):
    tr = Tracer(enabled=True)
    step, state = tiny_hat_filter(tr)
    for _ in range(2):
        y, _ = step(_frames(13, 1, 16, 16), state)
    assert y.shape == (1, 64, 64, 3)
    spans = tr.spans()
    assert {n for n, *_ in spans} == set(hat.SPANS)
    assert {a["seq"] for *_, a in spans} == {0, 1}
    assert {a["block"] for n, *_, a in spans if n == hat.SPAN_OCAB_ATTN} == {"g0.ocab", "g1.ocab"}
    st = step.stats
    assert (st.batches, st.frames, st.windows_per_frame) == (2, 2, 16)
    assert st.attention_calls == 2 * (4 + 2 + 2)      # unshifted 1 call, shifted 2, OCAB 1
    assert st.padded_token_share == 0.0 and st.sdpa_backend == "cpu default"
    assert tr.dropped == 0


def test_disabled_tracer_records_nothing(tiny_hat_filter):
    for tr in (Tracer(enabled=False), None):
        step, state = tiny_hat_filter(tr)
        step(_frames(14, 1, 16, 16), state)
        assert step.stats.batches == 0
        if tr is not None:
            assert len(tr) == 0 and tr.device_spans() == []


def test_engine_runs_hat_at_published_widths():
    """The filter as registered (HatConfig's published defaults), through
    the engine on a small frame: uint8 in, ×4 uint8 out."""
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("super_resolution", arch="hat", scale=4),
                               device="cpu")
    x = np.random.default_rng(0).integers(0, 255, (1, 16, 20, 3), np.uint8)
    out = eng.submit(x).fetch()
    assert out.shape == (1, 64, 80, 3) and out.dtype == np.uint8


def test_cli_serves_hat_through_filter_config(capsys, monkeypatch):
    import json

    from dvf_tpu_torch.cli import main

    monkeypatch.setenv("DVF_FORCE_PLATFORM", "cpu")
    rc = main(["serve", "--filter", "super_resolution", "--filter-config",
               '{"arch": "hat", "scale": 4}', "--source", "synthetic", "--height", "16",
               "--width", "16", "--frames", "2", "--batch", "1", "--frame-delay", "0",
               "--queue-size", "8"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["delivered"] == 2
