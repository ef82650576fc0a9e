"""The style nets' out stage, 9×9 conv + bias + scaled tanh, as one call
(``models.layers.out_conv_tanh``) on the CPU: its plain version against
the JAX package's ``cv("out")`` and tanh, the dispatch takes the plain
ops for a CPU tensor and for a differentiable call (counting the latter
on a device) and sends every other takeable bf16 call to the kernel,
which refuses a tensor off the card; gradients through the plain ops
match ``jax.value_and_grad``. The kernel itself runs only on a card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvf_tpu.models import layers as jl
from dvf_tpu_torch.models import layers as tl
from dvf_tpu_torch.ops import kernels as tk

# (B, H, W, Cin): the smallest frames the reflect border of radius 4
# takes, and frames that are no multiple of the kernel's 16 × 64 tile.
SHAPES = [(1, 5, 5, 16), (2, 7, 7, 32), (2, 13, 37, 16), (1, 19, 35, 32)]


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((9, 9, cin, 3)) * np.sqrt(2.0 / (81 * cin))).astype(np.float32)
    b = (rng.standard_normal(3) * 0.3).astype(np.float32)
    return x, {"w": w, "b": b}


def _torch_params(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _ulp_bf16(x):
    """One bf16 ulp at |x| (float32 in, float32 out)."""
    e = torch.frexp(x.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(x), e - 8)


def _jax_out_stage(p, x, dtype):
    """The JAX package's out stage: ``cv("out", x)`` (the reflect-padded
    conv in the compute dtype plus the bias in it) and the float32 scaled
    tanh (dvf_tpu/models/style_transfer.py), as float32."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y = jl.conv2d_nb(jp, jnp.asarray(x).astype(jd), compute_dtype=jd, reflect=True)
    y = y + jp["b"].astype(jd)
    out = 0.5 * (jnp.tanh(y.astype(jnp.float32)) + 1.0)
    return torch.from_numpy(np.array(out.astype(jnp.float32))), torch.from_numpy(
        np.array(y.astype(jnp.float32)))


def _counts():
    return tk.LAUNCHES["out_conv"], tk.AUTOGRAD_CALLS["out_conv"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_out_stage_matches_the_jax_package(shape, dtype):
    """Both round where the reference rounds (the conv result and the bias
    add to the compute dtype, tanh in float32) and differ by the conv's
    summation order over 81·Cin products. In float32 that is a few ulps
    of the summed magnitudes; in bf16 it flips a rounding of the pre-tanh
    value now and then: one bf16 ulp of the conv result, and of the sum
    with the bias, moves the output by at most half of that (tanh's slope
    is at most 1, the scale 0.5; each ulp taken one step up, where a flip
    crosses a power of two), on under 1 % of the elements (none at these
    shapes: they agree within tanh's float32 noise). The dispatch on a
    CPU tensor is the plain version bit for bit."""
    x, p = _operands(shape, sum(shape))
    tp = _torch_params(p)
    xt = torch.from_numpy(x).to(dtype)
    got = tl.out_conv_tanh_plain(tp, xt, dtype, torch.float32)
    assert got.dtype == torch.float32 and got.shape == shape[:3] + (3,)
    same = tl.out_conv_tanh(tp, xt, dtype, torch.float32)
    assert torch.equal(same.view(torch.int32), got.view(torch.int32))
    want, z = _jax_out_stage(p, x, dtype)
    diff = (got - want).abs()
    if dtype == torch.bfloat16:
        s = (z - torch.from_numpy(p["b"]).to(dtype).float()).abs()
        us = _ulp_bf16(s + _ulp_bf16(s))
        bound = 0.5 * (us + _ulp_bf16(z.abs() + us + _ulp_bf16(z))) + 2.0 ** -22
        assert float((diff > 2.0 ** -22).float().mean()) < 0.01
    else:
        terms = torch.from_numpy(np.abs(np.asarray(jl.conv2d_nb(
            {"w": jnp.abs(jnp.asarray(p["w"]))}, jnp.abs(jnp.asarray(x)),
            compute_dtype=jnp.float32, reflect=True))))
        bound = 0.5 * 2.0 ** -20 * terms + 2.0 ** -22
    assert float((diff - bound).max()) <= 0


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plain_out_stage_writes_the_batch_dtype(out_dtype):
    x, p = _operands((1, 6, 9, 16), 3)
    got = tl.out_conv_tanh(_torch_params(p), torch.from_numpy(x).to(torch.bfloat16),
                           torch.bfloat16, out_dtype)
    assert got.dtype == out_dtype and got.shape == (1, 6, 9, 3)
    assert float(got.float().min()) >= 0 and float(got.float().max()) <= 1


def test_cpu_and_differentiable_calls_take_the_plain_ops_uncounted():
    tk.reset_launches()
    x, p = _operands((1, 8, 10, 16), 1)
    tp = _torch_params(p)
    tl.out_conv_tanh(tp, torch.from_numpy(x).to(torch.bfloat16), torch.bfloat16,
                     torch.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tl.out_conv_tanh(tp, xt, torch.bfloat16, torch.float32)
    assert out.requires_grad
    assert _counts() == (0, 0)


def test_device_dispatch_counts_the_differentiable_path_and_never_falls_back():
    """On a device other than the CPU (here "meta", which runs no kernel):
    a call with any operand requiring grad under grad mode takes the plain
    ops and counts in ``AUTOGRAD_CALLS``; a float32 call, one writing
    bf16, and a bf16 one whose shape the kernel does not take (Cin 8),
    take the plain ops uncounted; any other call goes to the kernel, which
    refuses a tensor that is not on a card rather than fall back."""
    tk.reset_launches()
    x, p = _operands((2, 6, 10, 16), 2)
    meta = {k: torch.from_numpy(v).to("meta") for k, v in p.items()}
    xm = torch.from_numpy(x).to("meta")
    for leaf in ("x", "w", "b"):
        args = {"x": xm.clone(), "w": meta["w"].clone(), "b": meta["b"].clone()}
        args[leaf].requires_grad_(True)
        out = tl.out_conv_tanh({"w": args["w"], "b": args["b"]}, args["x"],
                               torch.bfloat16, torch.float32)
        assert out.device.type == "meta" and out.requires_grad
        assert out.shape == (2, 6, 10, 3) and out.dtype == torch.float32
    assert _counts() == (0, 3)
    out = tl.out_conv_tanh(meta, xm, torch.float32, torch.float32)
    assert out.shape == (2, 6, 10, 3)
    out = tl.out_conv_tanh(meta, xm, torch.bfloat16, torch.bfloat16)
    assert out.shape == (2, 6, 10, 3) and out.dtype == torch.bfloat16
    x8, p8 = _operands((2, 6, 10, 8), 2)
    out = tl.out_conv_tanh({k: torch.from_numpy(v).to("meta") for k, v in p8.items()},
                           torch.from_numpy(x8).to("meta"), torch.bfloat16, torch.float32)
    assert out.shape == (2, 6, 10, 3)
    assert _counts() == (0, 3)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            tl.out_conv_tanh(meta, xm.clone().requires_grad_(True), torch.bfloat16,
                             torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tl.out_conv_tanh(meta, xm, torch.bfloat16, torch.float32)
    assert _counts() == (0, 3)
    tk.reset_launches()
    assert _counts() == (0, 0)


@pytest.mark.parametrize("x_shape,w_shape,takes", [
    ((8, 720, 1280, 32), (9, 9, 32, 3), True),
    ((1, 5, 5, 16), (9, 9, 16, 3), True),
    ((1, 5, 5, tk.OUT_CONV_MAX_CIN), (9, 9, tk.OUT_CONV_MAX_CIN, 3), True),
    ((1, 5, 5, tk.OUT_CONV_MAX_CIN + 16), (9, 9, tk.OUT_CONV_MAX_CIN + 16, 3), False),
    ((1, 4, 5, 16), (9, 9, 16, 3), False),
    ((1, 5, 4, 16), (9, 9, 16, 3), False),
    ((1, 9, 9, 24), (9, 9, 24, 3), False),
    ((1, 9, 9, 32), (9, 9, 32, 4), False),
    ((1, 9, 9, 32), (3, 3, 32, 3), False),
    ((9, 9, 32), (9, 9, 32, 3), False),
])
def test_out_conv_takes(x_shape, w_shape, takes):
    assert tk.out_conv_takes(x_shape, w_shape) is takes


def test_kernel_wrapper_refuses_a_tensor_off_the_card():
    x, p = _operands((1, 8, 10, 16), 3)
    with pytest.raises(ValueError, match="CUDA"):
        tk.out_conv_tanh_cuda(_torch_params(p), torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("shape", [(2, 9, 11, 16), (1, 5, 7, 32)])
def test_gradients_through_the_out_stage_match_jax(shape):
    """Gradients of a weighted sum of the float32 out stage with respect
    to the activation, the weight and the bias, against
    ``jax.value_and_grad`` of the JAX package's conv + bias + tanh, within
    1e-4 of each gradient's largest element (the train tests' bar)."""
    x, p = _operands(shape, 4)
    wsum = np.random.default_rng(5).standard_normal(shape[:3] + (3,)).astype(np.float32)

    def jfn(x, w, b):
        y = jl.conv2d_nb({"w": w}, x, compute_dtype=jnp.float32, reflect=True) + b
        return jnp.sum(0.5 * (jnp.tanh(y) + 1.0) * wsum)

    jargs = [jnp.asarray(v) for v in (x, p["w"], p["b"])]
    jval, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(*jargs)
    targs = [torch.from_numpy(v).clone().requires_grad_(True) for v in (x, p["w"], p["b"])]
    out = tl.out_conv_tanh({"w": targs[1], "b": targs[2]}, targs[0], torch.float32,
                           torch.float32)
    tval = (out * torch.from_numpy(wsum)).sum()
    tval.backward()
    assert abs(float(tval.detach()) - float(jval)) <= 1e-4 * abs(float(jval))
    for name, t, g in zip(("x", "w", "b"), targs, jgrads):
        want = np.asarray(g)
        assert float(np.abs(t.grad.numpy() - want).max()) <= 1e-4 * float(
            np.abs(want).max()), name
