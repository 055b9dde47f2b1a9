"""A 6-step leg of ``tools/parity_port_ab.py`` (its v1 protocol: width-8
NAFNet, 32x32 batch, L1(raw) + 0.1 * the sRGB physics term, AdamW + clip,
fp32 on the CPU): the port's ``make_train_step`` against the JAX
``make_train_step`` from one shared init. Both losses fall, the largest
relative loss difference stays under 5e-5 and the final largest parameter
difference under 2e-6 (the 12-step records of ``parity_port_ab.json``
stand beside the JAX-against-reference bar in PERF.md).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import parity_port_ab  # noqa: E402


def test_six_step_leg_of_the_v1_protocol():
    proto = parity_port_ab.PROTOCOLS["v1"]
    report = parity_port_ab.run_parity(6, proto["side"], proto["width"],
                                       full=False)
    assert report["port_loss_decreased"] and report["jax_loss_decreased"]
    assert report["max_rel_loss_diff"] < 5e-5
    assert report["final_param_max_abs_diff"] < 2e-6
    assert len(report["loss_port"]) == len(report["loss_jax"]) == 6
