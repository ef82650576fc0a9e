"""Static per-layer roofline decomposition of the neural filter models on
an NVIDIA H100 (the Hopper counterpart of ``dvf_tpu.models.analysis``).

For each layer of the style net / ESPCN at a given geometry it derives

- FLOPs (dense conv arithmetic, 2*K*K*Cin*Cout per output pixel) and HBM
  bytes (activation reads/writes at the compute dtype, plus the norm's
  extra read+write pass when it is not fused into the conv): the same
  counts as the reference's, layer for layer, since neither depends on
  the hardware;
- a tensor-core ideal time: FLOPs / (peak * n_eff * k_eff * m_eff), where
  the efficiency factors model how a conv lowered as an implicit GEMM
  (M = output pixels, N = Cout, K = k²·Cin) fills Hopper's ``wgmma``
  tiles: cuDNN's NHWC kernels pad channels to a multiple of 8, ``wgmma``
  takes N in steps of 8 (up to 256), K in steps of 16 for bf16 and M in
  64-row warpgroup tiles. A conv with Cout = 3 still fills 3/8 of its
  N step — far better than the 3/128 a 128x128 systolic array gives it,
  which is why this model, not the reference's, is the one for the card;
- an HBM ideal time: bytes / 3.35 TB/s,

and a per-layer verdict: which ceiling binds, and what the whole model's
best-case serial time is. Comparing that bound with a measured
ms_per_frame (the caller's, e.g. the port's own ``bench`` line; this
module reads no bench table) separates "the model is transfer- or
arithmetic-bound at these shapes" from "the lowering leaves time on the
table".

The numbers are a MODEL: the H100 SXM data-sheet peaks (989 dense bf16
TFLOP/s on the tensor cores, 67 float32 TFLOP/s outside them — a float32
net runs with TF32 off, so on the CUDA cores with no tile to fill — and
3.35 TB/s of HBM3: ``runtime.cost``'s, which chip_smoke.py uses too)
and idealised tiling, not a simulator. Where it and a measurement
disagree, the measurement wins.

Usage: python -m dvf_tpu_torch.models.analysis [--json] [--md-out PATH]
       [--measured style_720p=MS] [--measured sr2x_540p=MS]
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from dvf_tpu_torch.runtime.cost import H100_PEAKS

# H100 SXM data-sheet peaks: dense bf16 on the tensor cores, float32 on
# the CUDA cores, HBM3 bandwidth.
PEAK_BF16_TFLOPS = H100_PEAKS["bf16_tflops"]
PEAK_F32_TFLOPS = H100_PEAKS["f32_tflops"]
PEAK_HBM_GBPS = H100_PEAKS["hbm_gbps"]
# wgmma tile steps for bf16: N in multiples of 8 (up to 256), K in
# multiples of 16, M in 64-row warpgroup tiles; cuDNN's NHWC channel pad.
WGMMA_N_STEP = 8
WGMMA_K_STEP = 16
WGMMA_M_STEP = 64
CHANNEL_PAD = 8


@dataclasses.dataclass
class LayerCost:
    name: str
    kind: str               # conv | norm | upsample | pointwise
    h: int                  # OUTPUT spatial geometry
    w: int
    cin: int
    cout: int
    ksize: int
    flops: float            # per frame
    hbm_bytes: float        # per frame
    n_eff: float            # Cout / ceil8(Cout) -- wgmma N-step utilization
    k_eff: float            # k²·Cin / ceil16(k²·ceil8(Cin)) -- K-step utilization
    tc_ms: float            # ideal per-frame ms on the tensor-core model
    hbm_ms: float           # ideal per-frame ms on the HBM model
    note: str = ""

    @property
    def bound(self) -> str:
        if self.flops == 0 and self.hbm_bytes == 0:
            return "free"
        return "tensor" if self.tc_ms >= self.hbm_ms else "hbm"

    @property
    def ideal_ms(self) -> float:
        return max(self.tc_ms, self.hbm_ms)


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _hbm_ms(nbytes: float) -> float:
    return nbytes / (PEAK_HBM_GBPS * 1e9) * 1e3


def conv_cost(name: str, h_out: int, w_out: int, cin: int, cout: int,
              ksize: int, dtype_bytes: int = 2, bf16: bool = True,
              note: str = "") -> LayerCost:
    """Dense conv as implicit GEMM: M=(H*W), K=k²·Cin, N=Cout.

    bf16 runs on the tensor cores: channels padded to 8 (cuDNN NHWC), N
    filled in steps of 8, K in steps of 16, M in 64-row tiles. float32
    (TF32 off) runs on the CUDA cores, where only the channel pad
    wastes work."""
    flops = 2.0 * ksize * ksize * cin * cout * h_out * w_out
    cin_p = _ceil_to(cin, CHANNEL_PAD)
    cout_p = _ceil_to(cout, CHANNEL_PAD)
    if bf16:
        n_eff = cout / _ceil_to(cout_p, WGMMA_N_STEP)
        k_eff = ksize * ksize * cin / _ceil_to(ksize * ksize * cin_p,
                                                WGMMA_K_STEP)
        m = h_out * w_out
        m_eff = m / _ceil_to(m, WGMMA_M_STEP)
        peak = PEAK_BF16_TFLOPS * 1e12
    else:
        n_eff, k_eff, m_eff = cout / cout_p, cin / cin_p, 1.0
        peak = PEAK_F32_TFLOPS * 1e12
    tc_ms = flops / (peak * n_eff * k_eff * m_eff) * 1e3
    # Traffic: read input tile once (+ halo, negligible at these shapes),
    # write output once. Weights are tiny (<1 MB) and stay in L2.
    hbm_bytes = h_out * w_out * cin * dtype_bytes + h_out * w_out * cout * dtype_bytes
    return LayerCost(name, "conv", h_out, w_out, cin, cout, ksize,
                     flops, hbm_bytes, n_eff, k_eff, tc_ms,
                     _hbm_ms(hbm_bytes), note)


def norm_cost(name: str, h: int, w: int, c: int,
              dtype_bytes: int = 2, note: str = "") -> LayerCost:
    """Instance norm: one read pass for stats + one read-modify-write pass
    (when not fused into the producing conv -- the pessimistic case)."""
    bytes_ = 3 * h * w * c * dtype_bytes
    return LayerCost(name, "norm", h, w, c, c, 0, 0.0, bytes_, 1.0, 1.0,
                     0.0, _hbm_ms(bytes_), note)


def upsample_cost(name: str, h_out: int, w_out: int, c: int,
                  dtype_bytes: int = 2) -> LayerCost:
    """Nearest upsample: read source, write 4x target (broadcast)."""
    bytes_ = (h_out // 2) * (w_out // 2) * c * dtype_bytes + \
        h_out * w_out * c * dtype_bytes
    return LayerCost(name, "upsample", h_out, w_out, c, c, 0, 0.0, bytes_,
                     1.0, 1.0, 0.0, _hbm_ms(bytes_))


def _times(one: LayerCost, name: str, mult: int) -> LayerCost:
    return dataclasses.replace(
        one, name=name, flops=one.flops * mult, hbm_bytes=one.hbm_bytes * mult,
        tc_ms=one.tc_ms * mult, hbm_ms=one.hbm_ms * mult)


def style_layer_costs(height: int, width: int, base_channels: int = 32,
                      n_residual: int = 5, bf16: bool = True) -> List[LayerCost]:
    """Per-layer costs for models.style_transfer at one geometry."""
    c1, c2, c3 = base_channels, base_channels * 2, base_channels * 4
    h2, w2 = height // 2, width // 2
    h4, w4 = height // 4, width // 4
    dt = 2 if bf16 else 4
    mult = 2 * n_residual
    layers = [
        conv_cost("stem 9x9 3→%d" % c1, height, width, 3, c1, 9, dt, bf16,
                  note="full-res; Cin 3 pads to 8, K=648 of which 243 real"),
        norm_cost("stem_norm", height, width, c1, dt,
                  note="full-res stats pass"),
        conv_cost("down1 3x3 s2 %d→%d" % (c1, c2), h2, w2, c1, c2, 3, dt, bf16),
        norm_cost("down1_norm", h2, w2, c2, dt),
        conv_cost("down2 3x3 s2 %d→%d" % (c2, c3), h4, w4, c2, c3, 3, dt, bf16),
        norm_cost("down2_norm", h4, w4, c3, dt),
        _times(conv_cost("trunk conv 3x3 %d→%d" % (c3, c3), h4, w4, c3, c3,
                         3, dt, bf16, note="K=%d, full N steps" % (9 * c3)),
               "res_a/b x%d" % mult, mult),
        _times(norm_cost("trunk norm", h4, w4, c3, dt),
               "trunk norms x%d" % mult, mult),
        upsample_cost("up1 upsample", h2, w2, c3, dt),
        conv_cost("up1 3x3 %d→%d" % (c3, c2), h2, w2, c3, c2, 3, dt, bf16),
        norm_cost("up1_norm", h2, w2, c2, dt),
        upsample_cost("up2 upsample", height, width, c2, dt),
        conv_cost("up2 3x3 %d→%d" % (c2, c1), height, width, c2, c1, 3,
                  dt, bf16),
        norm_cost("up2_norm", height, width, c1, dt),
        conv_cost("out 9x9 %d→3" % c1, height, width, c1, 3, 9, dt, bf16,
                  note="N=3 → 3/8 of one wgmma N step: the structural floor"),
    ]
    return layers


def espcn_layer_costs(height: int, width: int, scale: int = 2,
                      c1: int = 64, c2: int = 32,
                      bf16: bool = True) -> List[LayerCost]:
    dt = 2 if bf16 else 4
    r2 = 3 * scale * scale
    d2s_bytes = 2.0 * height * width * r2 * 4  # f32 in the current body
    return [
        conv_cost("feat 5x5 3→%d" % c1, height, width, 3, c1, 5, dt, bf16,
                  note="Cin 3 pads to 8: K=200 of which 75 real"),
        conv_cost("map 3x3 %d→%d" % (c1, c2), height, width, c1, c2, 3,
                  dt, bf16),
        conv_cost("head 3x3 %d→%d" % (c2, r2), height, width, c2, r2, 3,
                  dt, bf16, note="N=%d → %d/%d of its N steps" % (
                      r2, r2, _ceil_to(r2, WGMMA_N_STEP))),
        LayerCost("depth_to_space", "upsample", height * scale,
                  width * scale, r2, 3, 0, 0.0, d2s_bytes, 1.0, 1.0, 0.0,
                  _hbm_ms(d2s_bytes), note="pure reshape/transpose; f32 read+write"),
    ]


def summarize(layers: List[LayerCost], measured_ms: Optional[float] = None,
              label: str = "") -> dict:
    total_flops = sum(l.flops for l in layers)
    total_bytes = sum(l.hbm_bytes for l in layers)
    serial_ideal = sum(l.ideal_ms for l in layers)
    out = {
        "label": label,
        "total_gflops_per_frame": round(total_flops / 1e9, 2),
        "total_hbm_mb_per_frame": round(total_bytes / 1e6, 2),
        "tc_floor_ms": round(sum(l.tc_ms for l in layers), 4),
        "hbm_floor_ms": round(sum(l.hbm_ms for l in layers), 4),
        "serial_ideal_ms": round(serial_ideal, 4),
        "ideal_fps": round(1e3 / serial_ideal, 1) if serial_ideal else None,
        "mfu_at_ideal": round(
            total_flops / (serial_ideal * 1e-3) / (PEAK_BF16_TFLOPS * 1e12),
            4) if serial_ideal else None,
    }
    if measured_ms:
        out["measured_ms_per_frame"] = measured_ms
        out["lowering_gap_x"] = round(measured_ms / serial_ideal, 1)
        out["mfu_measured"] = round(
            total_flops / (measured_ms * 1e-3) / (PEAK_BF16_TFLOPS * 1e12), 4)
        out["verdict"] = (
            "transfer/arithmetic-bound" if measured_ms <= serial_ideal * 1.5
            else "lowering-bound: measured %.1fx the per-layer roofline sum "
                 "-- the gap is in the kernels' lowering and dispatch, not "
                 "the model's arithmetic or traffic" % (measured_ms / serial_ideal))
    return out


def render_md(layers: List[LayerCost], summary: dict) -> str:
    lines = [
        f"### {summary.get('label', 'model')}",
        "",
        "| layer | kind | out HxWxC | GFLOP | HBM MB | N eff | K eff | "
        "TC ms | HBM ms | bound |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for l in layers:
        lines.append(
            f"| {l.name} | {l.kind} | {l.h}x{l.w}x{l.cout} "
            f"| {l.flops / 1e9:.2f} | {l.hbm_bytes / 1e6:.1f} "
            f"| {l.n_eff:.2f} | {l.k_eff:.2f} | {l.tc_ms:.4f} | {l.hbm_ms:.4f} "
            f"| {l.bound}{' -- ' + l.note if l.note else ''} |")
    lines += ["", "```json", json.dumps(summary, indent=2), "```", ""]
    return "\n".join(lines)


def _parse_measured(items: List[str]) -> Dict[str, float]:
    out = {}
    for item in items:
        name, sep, ms = item.partition("=")
        try:
            out[name] = float(ms)
        except ValueError:
            raise SystemExit(f"error: bad --measured {item!r} (want CONFIG=MS)")
        if not sep or name not in ("style_720p", "sr2x_540p"):
            raise SystemExit(f"error: bad --measured {item!r} (want "
                             f"style_720p=MS or sr2x_540p=MS)")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--md-out", default="")
    ap.add_argument("--measured", action="append", default=[],
                    metavar="CONFIG=MS",
                    help="measured ms_per_frame of style_720p or sr2x_540p "
                         "on the card (e.g. from `bench --config style_720p`)")
    args = ap.parse_args(argv)
    measured = _parse_measured(args.measured)

    style = style_layer_costs(720, 1280)
    style_sum = summarize(style, measured.get("style_720p"),
                          "style_720p (batch-independent, per frame)")
    sr = espcn_layer_costs(540, 960)
    sr_sum = summarize(sr, measured.get("sr2x_540p"),
                       "sr2x_540p (batch-independent, per frame)")

    if args.json:
        print(json.dumps({"style_720p": style_sum, "sr2x_540p": sr_sum}))
    md = ("# Neural-config roofline decomposition on the H100 (static model)\n\n"
          "Generated by `python -m dvf_tpu_torch.models.analysis`. Constants: "
          f"{PEAK_BF16_TFLOPS:.0f} dense bf16 TFLOP/s, {PEAK_HBM_GBPS:.0f} GB/s "
          "HBM3 (H100 SXM data sheet). Per-layer tensor-core times model "
          "cuDNN's NHWC channel pad to 8 and wgmma's tile steps (N by 8, "
          "K by 16, M by 64); HBM times are activation traffic at the "
          "compute dtype.\n\n"
          + render_md(style, style_sum) + "\n" + render_md(sr, sr_sum))
    if args.md_out:
        with open(args.md_out, "w") as f:
            f.write(md)
    else:
        print(md)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
