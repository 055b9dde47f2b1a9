"""What the harness reads of a NAFNet configuration, pinned to the digits
it read before each configuration named its own reference module: the
seeded weights bit for bit (the same tensors, in the same order, by the
same rule) and the forward FLOP count at each cell's step or forward
shape. A change to the harness that moves either moves every cell's
weights or ``train_mfu`` / ``serve_mfu``."""

import hashlib
from pathlib import Path

import pytest

from port_bench.harness import counts
from port_bench.harness.serve import net_params
from port_bench.harness.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 3141592653

# sha256 over each leaf's name, shape and fp32 bytes, drawn on the CPU
WEIGHTS = {
    "newbp_w32.serve_burst8": (
        664, 29159715,
        "1fb379ce528fe884f89b02f115c4b1e9383e13d5e2976b1d0bd9e9edeb75c246"),
    "newbp_w64.serve_fullframe": (
        664, 115982915,
        "5473e33935c3ad84ff392323c0e0006e8c49005712f2566ca51f5592c1e79845"),
}

# a serve cell's forward (the burst: one 704x1024 bucket of 8; the full
# frame: 1024^2 tiles, 8 a forward); a training cell's step
FLOPS = {
    "newbp_w32.serve_burst8": ((8, 3, 704, 1024), 2823299072000.0),
    "newbp_w64.serve_fullframe": ((8, 3, 1024, 1024), 16184761384960.0),
    "newbp_w64.train_subimg512": ((8, 3, 384, 384), 2276197662720.0),
    "newbp_w32.train_sid384": ((2, 3, 384, 384), 144385720320.0),
}


def digest(params):
    h = hashlib.sha256()
    for name, t in params.items():
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell", sorted(WEIGHTS))
def test_seeded_weights_are_unchanged(cell):
    params = net_params(load_cell(cell, ROOT), SEED, "cpu")
    leaves, numel, sha = WEIGHTS[cell]
    assert len(params) == leaves
    assert sum(t.numel() for t in params.values()) == numel
    assert digest(params) == sha


@pytest.mark.parametrize("cell", sorted(FLOPS))
def test_forward_flops_are_unchanged(cell):
    c = load_cell(cell, ROOT)
    shape, flops = FLOPS[cell]
    if c.traffic["kind"] == "train":
        assert shape == (c.traffic["batch"],
                         c.reference.in_channels(c.config["network_g"]),
                         c.traffic["patch"], c.traffic["patch"])
    assert counts.net_flops(shape, c.config["network_g"],
                            c.reference) == flops
