"""The plain reference agrees with the port's CPU path at tiny sizes, in
float32; and one conv's counts worked by hand."""

import numpy as np
import pytest
import torch

from portbench import counts, inputs
from portbench.counts import johnson as jc
from portbench.reference import johnson, vgg
from portbench.reference import train as ref_train
from portbench.traffic import train

DEV = torch.device("cpu")
BLOCKS = [(2, 8), (1, 16), (2, 16)]


def test_net_matches_port_float32():
    from dvf_tpu_torch.models.style_transfer import StyleNetConfig, apply_style_net

    params = inputs.make_params(inputs.johnson_layers(8, 2), 5, DEV)
    x = torch.rand((2, 24, 32, 3), generator=torch.Generator().manual_seed(1))
    port = apply_style_net(params, x, StyleNetConfig(8, 2, torch.float32))
    ref = johnson.forward(params, x, 2)
    assert port.shape == ref.shape == (2, 24, 32, 3)
    assert torch.allclose(port, ref, atol=2e-5)


def test_vgg_matches_port_float32():
    from dvf_tpu_torch.models.vgg import VGGConfig, vgg_features

    params = inputs.make_params(inputs.vgg_layers(BLOCKS), 6, DEV)
    x = torch.rand((2, 20, 20, 3), generator=torch.Generator().manual_seed(2))
    port = vgg_features(params, x, VGGConfig(blocks=tuple(BLOCKS), compute_dtype=torch.float32))
    ref = vgg.features(params, x, BLOCKS)
    assert len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        assert torch.allclose(a.permute(0, 3, 1, 2), b, atol=1e-5)


def test_loss_and_adam_steps_match_port_float32():
    from dvf_tpu_torch.models.style_transfer import StyleNetConfig
    from dvf_tpu_torch.models.vgg import VGGConfig
    from dvf_tpu_torch.train import optim
    from dvf_tpu_torch.train.style import StyleTrainConfig, init_train_state, make_train_step

    net = inputs.make_params(inputs.johnson_layers(8, 1), 7, DEV)
    enc = inputs.make_params(inputs.vgg_layers(BLOCKS), 8, DEV)
    style = inputs.train_images(9, 1, 16, DEV)
    batches = inputs.train_images(10, 6, 16, DEV).view(3, 2, 16, 16, 3)
    weights = {"content_weight": 1.0, "style_weight": 10.0, "tv_weight": 1e-4}
    config = StyleTrainConfig(net=StyleNetConfig(8, 1, torch.float32),
                              vgg=VGGConfig(blocks=tuple(BLOCKS), compute_dtype=torch.float32),
                              learning_rate=1e-3, **weights)
    state = init_train_state(0, style, config, device="cpu")
    with torch.no_grad():
        for tree, src in ((state.params, net), (state.vgg_params, enc)):
            for k, leaves in tree.items():
                for n, t in leaves.items():
                    t.copy_(src[k][n])
    from dvf_tpu_torch.models.layers import gram_matrix
    from dvf_tpu_torch.models.vgg import vgg_features
    state.style_grams = [gram_matrix(f)[0] for f in vgg_features(state.vgg_params, style, config.vgg)]
    step = make_train_step(config=config, state_template=state)
    losses = []
    for i in range(3):
        state, m = step(state, batches[i])
        losses.append(float(m["loss"]))
        if i == 0:
            _, mu, _ = optim.adam_state(state.opt_state, state.params)
            grad = {k: v.clone() / (1 - 0.9) for k, v in mu.items()}
    change = {k: t.detach() - net[k.split("/")[0]][k.split("/")[1]]
              for k, t in optim.flatten(state.params).items()}
    ref = ref_train.run_steps(net, enc, style, list(batches), BLOCKS, 1, weights, 1e-3)
    gaps = train.compare(losses, grad, change, *ref)[0]
    # float32 on both sides: the gaps are round-off, which Adam's division by
    # sqrt(v) amplifies on the leaves with the smallest gradients.
    assert gaps["loss_gap"] < 1e-3
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-2


def test_one_conv_counted_by_hand():
    # A 3x3 conv 64 -> 128 at stride 2 from 360x640 to 180x320, bf16:
    # FLOPs 2*9*64*128 = 147456 per output pixel x 57600 pixels;
    # bytes 2 * (360*640*64 + 180*320*128 + 9*64*128).
    c = counts.Conv(3, 64, 128, 360, 640, 180, 320)
    assert c.flops == 147456 * 57600 == 8493465600
    assert c.bytes(2) == 2 * (14745600 + 7372800 + 73728) == 44384256
    least = counts.least_time_s([c], "bfloat16")
    assert least == pytest.approx(max(8493465600 / 989e12, 44384256 / 3.35e12))


def test_frame_count_is_the_published_net():
    convs = jc.frame({"net": {"base_channels": 32, "n_residual": 5}}, 720, 1280)
    assert len(convs) == 16
    assert counts.flops(convs) == pytest.approx(283.47e9, rel=1e-3)
