"""The yardstick's arithmetic on known inputs: percentiles and rates,
the NAFBlock's operations and bytes, the FLOP count of the network."""

import math

import pytest
import torch

from port_bench.harness import counts, readers
from port_bench.harness.record import Run, Unit


def test_p95_nearest_rank():
    assert readers.percentile(list(range(1, 101)), 95) == 95
    assert readers.percentile(list(range(100, 0, -1)), 95) == 95
    assert readers.percentile([5.0], 95) == 5.0
    vals = [float(v) for v in range(1, 21)]     # 20 values: rank 19
    assert readers.percentile(vals, 95) == 19.0


def test_serve_rate_and_p95_over_the_window():
    units = [Unit(start=0.2 * i, end=0.2 * i + 0.15, pixels=1_000_000)
             for i in range(10)]
    run = Run("serve", "bfloat16", {}, units=units)
    run.window_s = units[-1].end - units[0].start      # 1.95 s
    assert readers.rate(run) == pytest.approx(10 / 1.95)
    from port_bench.harness.spec import metric_reader
    assert metric_reader("serve_p95_ms")(run) == pytest.approx(150.0)


def test_train_step_ms_is_window_over_steps():
    run = Run("train", "bfloat16", {},
              units=[Unit(i, i + 0.5, wait=0.25) for i in range(8)])
    run.window_s = 4.0
    assert readers.step_ms(run) == pytest.approx(500.0)
    from port_bench.harness.spec import metric_reader
    assert metric_reader("data_wait_ms.train")(run) == pytest.approx(250.0)
    assert metric_reader("step_host_ms.train")(run) == pytest.approx(500.0)


def test_block_params_match_the_reference_block():
    from port_bench.reference.nafnet import nafnet_param_shapes

    shapes = nafnet_param_shapes(3, 32, [1], 0, [1])
    block = sum(math.prod(s) for k, s in shapes.items()
                if k.startswith("encoders.0.0."))
    assert block == counts.block_params(32)


def test_flop_counter_agrees_with_a_hand_count_of_one_block():
    from port_bench.reference.nafnet import nafblock, nafnet_param_shapes

    n, c, h, w = 2, 32, 8, 12
    shapes = {k[len("encoders.0.0."):]: s
              for k, s in nafnet_param_shapes(3, c, [1], 0, [1]).items()
              if k.startswith("encoders.0.0.")}
    p = {f"b.{k}": torch.empty(s, device="meta") for k, s in shapes.items()}
    counter = torch.utils.flop_counter.FlopCounterMode(display=False)
    with counter, torch.no_grad():
        nafblock(torch.empty(n, c, h, w, device="meta"), p, "b")
    flops, _ = counts.block_work(n, c, h, w, "bfloat16")
    assert counter.get_total_flops() == flops


@pytest.mark.parametrize("c", [24, 32, 40, 1024])
def test_roofline_count_does_not_depend_on_the_route(c):
    """The kernels take a tensor-core route at C % 16 == 0 and an FMA
    route otherwise; the count is of the block's math alone, so it is
    the same formula at every C and grows exactly with the pixels."""
    n, h, w = 2, 16, 24
    f1, b1 = counts.block_work(n, c, h, w, "bfloat16")
    f2, b2 = counts.block_work(n, c, 2 * h, w, "bfloat16")
    assert f2 - f1 == pytest.approx(2.0 * n * h * w * (6 * c * c + 18 * c))
    assert b2 - b1 == pytest.approx(2.0 * n * h * w * c * 2)
    fb, bb = counts.block_work(n, c, h, w, "bfloat16", backward=True)
    assert fb == 2 * f1
    assert bb == 3 * n * h * w * c * 2 + 8 * counts.block_params(c)
    assert counts.block_bound_s(n, c, h, w, "bfloat16") == max(
        f1 / 989e12, b1 / 3.35e12)


NAFNET = {"nafnet_params": {"img_channel": 3, "width": 8, "enc_blk_nums": [1],
                            "middle_blk_num": 1, "dec_blk_nums": [1]}}


def test_network_flops_on_meta_are_the_blocks_and_the_convs():
    from port_bench.reference import nafnet

    total = counts.net_flops((1, 3, 16, 16), NAFNET, nafnet)
    blocks = (2 * counts.block_work(1, 8, 16, 16, "float32")[0]
              + counts.block_work(1, 16, 8, 8, "float32")[0])
    convs = 2 * (16 * 16 * (8 * 3 * 9 + 3 * 8 * 9)      # intro, ending
                 + 8 * 8 * 16 * 8 * 4                   # down 2x2 s2
                 + 8 * 8 * 32 * 16)                     # up 1x1
    assert total == blocks + convs


def test_mfu_counts_three_forwards_a_step():
    from port_bench.reference import nafnet

    run = Run("train", "bfloat16", NAFNET, nafnet, units=[Unit(0, 1)] * 4)
    run.window_s, run.step_shape = 2.0, (2, 3, 16, 16)
    want = 100 * 3 * counts.net_flops((2, 3, 16, 16), NAFNET, nafnet) * 4 \
        / 2.0 / 989e12
    assert readers.mfu(run) == pytest.approx(want)


def test_trace_reading_of_a_known_chrome_trace(tmp_path):
    """Busy time is the union of device intervals inside the window; device
    operations are named by the span that launched them, idle gaps by the
    span they fall in."""
    import json

    from port_bench.harness.trace import WINDOW, read_trace

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}
    events = [
        x("user_annotation", WINDOW, 0, 1000),
        x("user_annotation", "server.predict", 50, 900),
        x("user_annotation", "model.forward", 90, 360),
        x("cuda_runtime", "cudaLaunchKernel", 95, 2, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 96, 2, correlation=2),
        x("cuda_runtime", "cudaMemcpyAsync", 700, 5, correlation=3),
        x("kernel", "void nafblk::k2_mma_kernel<64>(float*)", 100, 200,
          correlation=1),
        x("kernel", "void nafblk::k1_dw_kernel<K1Mma>(float*)", 250, 150,
          correlation=2),
        x("kernel", "void at::native::elementwise_kernel<4>()", 600, 100),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 800, 50,
          correlation=3),
        x("kernel", "before the window", -500, 100),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = read_trace(str(path), ("server.predict", "model.forward"))
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(450e-6)          # 100-400, 600-700, 800-850
    assert t.busy_in_s(50, 950) == pytest.approx(450e-6)
    assert t.device_s(lambda e: "nafblk::" in e["name"]) == pytest.approx(
        350e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["model.forward/nafblk::k2_mma_kernel",
                                  pytest.approx(200e-6)]
    assert ["server.predict/Memcpy_DtoH", pytest.approx(50e-6)] in b[
        "device_ops"]
    assert ["other/at::native::elementwise_kernel",
            pytest.approx(100e-6)] in b["device_ops"]
    assert b["idle_gaps"][0] == ["server.predict", pytest.approx(200e-6)]
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx(
        [200e-6, 150e-6, 100e-6, 100e-6])


@pytest.mark.parametrize("warmup", [-1, 5000])
def test_reference_learning_rate_follows_the_ports_schedule(warmup):
    """The reference optimizer's rate of each of the first updates, with
    and without the linear warm-up of a recipe such as SwinIR's."""
    from lowlight_image_enhancement_tpu_torch.training.schedules import (
        make_schedule,
    )
    from port_bench.reference.optim import AdamWClip

    train = {"warmup_iter": warmup,
             "optim_g": {"type": "AdamW", "lr": 2e-4},
             "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 300000,
                           "eta_min": 1e-6}}
    ref = AdamWClip([], train)
    port = make_schedule(train["scheduler"], 2e-4, warmup)
    for k in (0, 1, 2, 3, 5000, 5001):
        assert ref.rate(k) == pytest.approx(float(port(k)), rel=1e-12,
                                            abs=1e-18)
    assert (ref.rate(0) == 0.0) is (warmup > 0)
