"""The style nets' conv bias + instance norm + ReLU + residual as one call
(``models.layers.bias_norm_act``) on the CPU: its plain version against
the JAX package's chain of ops, the dispatch takes the plain ops for a
CPU tensor and for a differentiable call (counting the latter on a
device), and gradients through it match ``jax.value_and_grad`` of the
JAX package's layers. The kernels themselves run only on a card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvf_tpu.models import layers as jl
from dvf_tpu_torch.models import layers as tl
from dvf_tpu_torch.ops import kernels as tk

# The style net's three widths at its three resolutions (scaled down), and
# an odd geometry whose C is not a multiple of the kernels' 16-byte chunk.
SHAPES = [(2, 24, 40, 32), (2, 12, 20, 64), (2, 6, 10, 128), (3, 7, 9, 5)]


def _operands(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    y = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    p = {"scale": torch.from_numpy(rng.random(c, dtype=np.float32) + 0.5),
         "bias": torch.from_numpy(rng.standard_normal(c).astype(np.float32))}
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    return p, y.to(dtype), b, res.to(dtype)


def _ulp_bf16(x):
    """One bf16 ulp at |x| (float32 in, float32 out)."""
    e = torch.frexp(x.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(x), e - 8)


def _jax_chain(p, y, b, relu, residual):
    """The JAX package's style net ops on the same values and dtype: conv
    bias add, ``instance_norm``, ReLU, residual add (float32 out)."""
    jd = jnp.bfloat16 if y.dtype == torch.bfloat16 else jnp.float32

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jd)

    h = jl.instance_norm({"scale": jnp.asarray(p["scale"].numpy()),
                          "bias": jnp.asarray(p["bias"].numpy())}, j(y) + j(b))
    if relu:
        h = jax.nn.relu(h)
    if residual is not None:
        h = j(residual) + h
    return torch.from_numpy(np.array(h.astype(jnp.float32)))


def _norm_counts():
    return tk.LAUNCHES["instance_norm"], tk.AUTOGRAD_CALLS["instance_norm"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu,with_res", [(True, False), (False, True),
                                           (False, False), (True, True)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_the_jax_chain(shape, dtype, relu, with_res):
    """The plain version against the JAX package's chain. They round in
    the same places and differ by the float32 arithmetic of the
    statistics (``var_mean`` and one affine map against mean, var and two
    products): in float32 by at most 2^-19 of the terms each output is
    summed from (|y·a| + |shift| + |residual| and (|mean| + σ)·a, the
    statistics' own scale); in bf16 by one ulp of the output, or two of
    those terms where the map cancels, on under 0.1 % of the elements.
    The dispatch on a CPU tensor is the plain version bit for bit."""
    p, y, b, res = _operands(shape, sum(shape), dtype)
    residual = res if with_res else None
    got = tl.bias_norm_act_plain(p, y, b, relu=relu, residual=residual)
    assert got.dtype == dtype and got.shape == y.shape
    same = tl.bias_norm_act(p, y, b, relu=relu, residual=residual)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(same.view(bits), got.view(bits))
    want = _jax_chain(p, y, b, relu, residual)
    yb = (y + b.to(dtype)).float()
    var, mean = torch.var_mean(yb, dim=(1, 2), keepdim=True, correction=0)
    a = torch.rsqrt(var + 1e-5) * p["scale"]
    terms = ((yb * a).abs() + (p["bias"] - mean * a).abs()
             + (mean.abs() + var.sqrt()) * a.abs())
    if residual is not None:
        terms += residual.float().abs()
    g = got.float()
    diff = (g - want).abs()
    if dtype == torch.bfloat16:
        bound = torch.maximum(_ulp_bf16(torch.maximum(g.abs(), want.abs())),
                              2 * _ulp_bf16(terms))
        assert float((diff > 0).float().mean()) < 1e-3
    else:
        bound = 2.0 ** -19 * terms
    assert float((diff - bound).max()) <= 0


def test_cpu_and_differentiable_calls_take_the_plain_ops_uncounted():
    tk.reset_launches()
    p, y, b, res = _operands((2, 6, 10, 16), 1, torch.float32)
    tl.bias_norm_act(p, y, b, relu=True)
    y.requires_grad_(True)
    out = tl.bias_norm_act(p, y, b, residual=res)
    assert out.requires_grad
    assert _norm_counts() == (0, 0)


def test_device_dispatch_counts_the_differentiable_path_and_never_falls_back():
    """On a device other than the CPU (here "meta", which runs no kernel):
    a call with any operand requiring grad under grad mode takes the plain
    ops and counts in ``AUTOGRAD_CALLS``; any other call goes to
    the kernels, which refuse a tensor that is not on a card rather than
    fall back."""
    tk.reset_launches()
    p, y, b, res = _operands((2, 6, 10, 16), 2, torch.bfloat16)
    meta = {k: v.to("meta") for k, v in p.items()}
    ym, bm, rm = y.to("meta"), b.to("meta"), res.to("meta")
    for leaf in ("y", "b", "scale", "residual"):
        args = {"y": ym.clone(), "b": bm.clone(), "scale": meta["scale"].clone(),
                "residual": rm.clone()}
        args[leaf].requires_grad_(True)
        out = tl.bias_norm_act({"scale": args["scale"], "bias": meta["bias"]},
                               args["y"], args["b"], residual=args["residual"])
        assert out.device.type == "meta" and out.requires_grad
    assert _norm_counts() == (0, 4)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            tl.bias_norm_act(meta, ym.clone().requires_grad_(True), bm, relu=True)
    with pytest.raises(ValueError, match="CUDA"):
        tl.bias_norm_act(meta, ym, bm, relu=True)
    assert _norm_counts() == (0, 4)
    tk.reset_launches()
    assert _norm_counts() == (0, 0)


def test_kernel_wrapper_refuses_a_tensor_off_the_card():
    p, y, b, _ = _operands((2, 6, 10, 16), 3, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tk.bias_norm_act_cuda(p, y, b)


@pytest.mark.parametrize("relu,with_res", [(True, False), (False, True)])
def test_gradients_through_the_call_match_jax(relu, with_res):
    """Gradients of a weighted sum of the call's float32 output with
    respect to y, the conv bias, the norm's scale and bias and the
    residual, against ``jax.value_and_grad`` of the JAX package's
    ``instance_norm`` chain, within 1e-4 of each gradient's largest
    element (the existing train tests' bar). The conv bias's gradient is
    zero up to rounding (the norm removes any per-channel constant)."""
    shape = (2, 9, 11, 6)
    p, y, b, res = _operands(shape, 4, torch.float32)
    w = np.random.default_rng(5).standard_normal(shape).astype(np.float32)

    def jfn(y, b, scale, bias, res):
        h = jl.instance_norm({"scale": scale, "bias": bias}, y + b)
        if relu:
            h = jax.nn.relu(h)
        if with_res:
            h = res + h
        return jnp.sum(h * w)

    jargs = [jnp.asarray(t.numpy()) for t in (y, b, p["scale"], p["bias"], res)]
    jval, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [t.clone().requires_grad_(True) for t in (y, b, p["scale"], p["bias"], res)]
    out = tl.bias_norm_act({"scale": targs[2], "bias": targs[3]}, targs[0], targs[1],
                           relu=relu, residual=targs[4] if with_res else None)
    tval = (out * torch.from_numpy(w)).sum()
    tval.backward()
    assert abs(float(tval.detach()) - float(jval)) <= 1e-4 * abs(float(jval))
    for name, t, g in zip(("y", "b", "scale", "bias", "res"), targs, jgrads):
        want = np.asarray(g)
        got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
        big = max(float(np.abs(want).max()), 1.0 if name == "b" else 0.0)
        assert float(np.abs(got - want).max()) <= 1e-4 * big, name
