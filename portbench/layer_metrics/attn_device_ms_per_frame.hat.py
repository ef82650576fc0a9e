"""Device ms a frame of HAT's two attentions: the ``hat.window_attn`` and
``hat.ocab_attn`` spans (CUDA event pairs around each block's LayerNorm,
qkv, window gather, attention, proj and residual) of the batches collected
in the traced window, over their frames."""

ATTENTION_SPANS = ("hat.window_attn", "hat.ocab_attn")


def read(outcome):
    spans = outcome.get("hat_spans")
    if not spans or not spans["frames"] or not spans["ms"]:
        return None
    return sum(spans["ms"].get(n, 0.0) for n in ATTENTION_SPANS) / spans["frames"]
