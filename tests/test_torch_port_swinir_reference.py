"""The port's SwinIR against the benchmark's plain reference
(``port_bench/reference/swinir.py``) on seeded weights, at the reference's
``small()`` size (embed 12, depths (2, 2), heads (2, 2), window 8, mlp 2)
on the CPU.

Two inputs: 2x3x40x44 needs reflect padding (to 40x48), 1x3x32x32 is a
window multiple; both are wider than a window, so the shifted blocks run
with their mask. Compared: the fp32 forward and every parameter's gradient
of ``sum(out * cot)``, the bf16 program's output, the failure of the
comparison under three planted faults (shift dropped, mask dropped, bias
table ignored), and the spans and counters the attention records under a
profiler.
"""

import math

import pytest
import torch

from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.models import swinir as port
from lowlight_image_enhancement_tpu_torch.utils import profiling
from port_bench.harness.weights import make_params
from port_bench.reference import swinir as ref

COLOR_DN = {"type": "SwinIRRestoration", "img_channel": 3, "embed_dim": 180,
            "depths": [6] * 6, "num_heads": [6] * 6, "window_size": 8,
            "mlp_ratio": 2.0, "img_range": 1.0, "upsampler": "",
            "resi_connection": "1conv"}
NET = ref.small(COLOR_DN)
SHAPES = [(2, 3, 40, 44), (1, 3, 32, 32)]
SEED = 2 ** 32 + 23
# fp32 against fp32: the two differ only in the order of their sums (the
# port's fp32 copies of its operands, its window partition), ~1e-7 of the
# output; a planted fault moves it by 7e-4 or more
FWD_TOL = 1e-5
# every leaf's gradient, L2 of the difference over the leaf's L2: the
# backward adds a few more reordered sums
GRAD_TOL = 1e-4
# bf16 activations (8-bit mantissa, ~4e-3 a rounding) through 4 blocks,
# 2 RSTB convs and the trunk: the L2 of the difference over the L2 of what
# the reference adds to its input reads ~7e-3 here
BF16_TOL = 2e-2


def params():
    return make_params(ref.param_shapes(NET), SEED, "net", "cpu",
                       init=ref.init)


def port_net(p, dtype=None):
    opt = dict(NET, dtype=dtype) if dtype else dict(NET)
    net = define_network(opt, device="cpu")
    net.load_state_dict(p)
    return net


def inputs(shape):
    g = torch.Generator().manual_seed(sum(shape))
    return (torch.rand(shape, generator=g),
            torch.randn(shape, generator=g))


def l2_gap(got, want, base):
    return float((got - want).norm() / base.norm())


def gaps(net, p, shape):
    """``(forward gap, worst leaf's gradient gap)`` of the port against
    the reference, fp32, on ``sum(out * cot)``."""
    x, cot = inputs(shape)
    out = net(x)
    grads = torch.autograd.grad((out * cot).sum(), list(net.parameters()))
    got = dict(zip([n for n, _ in net.named_parameters()], grads))
    leaves = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    want = ref.forward(x, leaves, NET)
    wgrads = torch.autograd.grad((want * cot).sum(), list(leaves.values()))
    fwd = float((out - want).detach().abs().max() / (want - x).abs().max())
    grad = max(l2_gap(got[n], g, g) for n, g in zip(leaves, wgrads))
    return fwd, grad


def test_param_shapes_are_the_ports_state_dict_in_order():
    sd = port_net(params()).state_dict()
    assert [(k, tuple(v.shape)) for k, v in sd.items()] == list(
        ref.param_shapes(NET).items())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fp32_forward_and_gradients_match_the_reference(shape):
    p = params()
    fwd, grad = gaps(port_net(p), p, shape)
    assert fwd < FWD_TOL and grad < GRAD_TOL, (fwd, grad)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bf16_output_is_near_the_fp32_reference(shape):
    p = params()
    x, _ = inputs(shape)
    with torch.no_grad():
        got = port_net(p, "bfloat16")(x)
        want = ref.forward(x, p, NET)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert l2_gap(got, want, want - x) < BF16_TOL


def drop_shift(net, monkeypatch):
    for m in net.modules():
        if isinstance(m, port.SwinBlock):
            monkeypatch.setattr(m, "shift", 0)


def drop_mask(net, monkeypatch):
    core = port.WindowAttention._core
    monkeypatch.setattr(port.WindowAttention, "_core",
                        lambda self, qkv, mask: core(self, qkv, None))


def ignore_bias(net, monkeypatch):
    for m in net.modules():
        if isinstance(m, port.WindowAttention):
            monkeypatch.setattr(m, "relative_position_bias_table",
                                torch.nn.Parameter(torch.zeros_like(
                                    m.relative_position_bias_table)))


@pytest.mark.parametrize("fault", [drop_shift, drop_mask, ignore_bias],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_a_planted_fault_fails_the_comparison(shape, fault, monkeypatch):
    p = params()
    net = port_net(p)
    fault(net, monkeypatch)
    fwd, grad = gaps(net, p, shape)
    assert fwd > 10 * FWD_TOL or grad > 10 * GRAD_TOL, (fwd, grad)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_profiler_records_windows_and_both_spans(shape, tmp_path):
    net = port_net(params())
    x, cot = inputs(shape)
    calls = sum(NET["depths"])
    with profiling.trace(str(tmp_path)):
        out = net(x)
        forward = profiling.record()
        torch.autograd.grad((out * cot).sum(), list(net.parameters()))
        rec = profiling.record()
    profiling.reset()
    # windows of the padded image a block, every block; half are shifted
    per_block = shape[0] * math.ceil(shape[2] / 8) * math.ceil(shape[3] / 8)
    assert {k: rec["counters"][k] for k in (
        "swinir.windows", "swinir.shifted_windows")} == {
            "swinir.windows": per_block * calls,
            "swinir.shifted_windows": per_block * calls // 2}
    fwd = [s for s in forward["spans"] if s.name == "swinir.attention"]
    assert len(fwd) == calls and not any(
        s.name == "swinir.attention_bwd" for s in forward["spans"])
    bwd = [s for s in rec["spans"] if s.name == "swinir.attention_bwd"]
    assert len(bwd) == calls
    assert all(s.device_s is None and s.t1 >= s.t0 for s in fwd + bwd)


def test_off_the_profiler_nothing_is_recorded():
    net = port_net(params())
    x, cot = inputs(SHAPES[1])
    profiling.reset()
    out = net(x)
    torch.autograd.grad((out * cot).sum(), list(net.parameters()))
    assert profiling.record() == {"spans": [], "counters": {}}
