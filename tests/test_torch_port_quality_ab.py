"""The port's ``tools/quality_ab.py`` (``lowlight_image_enhancement_tpu_
torch/tools/quality_ab.py``) against the JAX tool of ``tools/`` on the CPU:

- ``ARCHS`` and ``build_opt`` equal the JAX tool's for both architectures;
  the flags and defaults equal the JAX tool's but for the deliberate
  differences: ``--out`` defaults to ``quality_ab_torch.json`` (the JAX
  default would overwrite the reference's ``quality_ab.json``),
  ``--width`` (the CPU tests' width), ``--seed`` (default 7, the seed the
  JAX tool's ``build_opt`` gives every run) and ``--device`` (as every
  port tool);
- the tool's recipe (its raw ``build_opt`` dict) through the port's and
  the JAX Trainer: 3 iterations from the same initial params, ``l_total``
  within rtol 1e-4; then ``evaluate_full`` equals the JAX tool's within
  rtol 1e-4 on the JAX Trainer's final params (bridged), the same
  ``make_synthetic_sid`` val set and one LPIPS-alex file that both read
  through ``$LLIE_LPIPS_NPZ``. Both networks at width 8 and one block a
  level, in fp32 (``enable_amp: false`` and ``dtype: float32``), as the
  port's Trainer tests compare in fp32;
- ``main`` over both architectures at width 8 goes end to end through
  its one-process-per-architecture branch and writes ``quality_ab.json``'s
  keys and nesting.

The JAX tool is imported from ``tools/`` on ``sys.path`` here only.
"""

import argparse
import copy
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.training.trainer import Trainer as JaxTrainer
from lowlight_image_enhancement_tpu_torch.data import make_synthetic_sid
from lowlight_image_enhancement_tpu_torch.models.lpips import load_lpips
from lowlight_image_enhancement_tpu_torch.tools import quality_ab
from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer
from lowlight_image_enhancement_tpu_torch.weights import bridge_for

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
RTOL = 1e-4
ITERS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tool():
    """``tools/quality_ab.py`` as a module."""
    sys.path.insert(0, str(TOOLS))
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tool_quality_ab", TOOLS / "quality_ab.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(TOOLS))
    return mod


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sid_synth")
    make_synthetic_sid(str(root), n_train=2, n_val=2, size=64)
    return str(root)


def test_archs_equal_jax(jax_tool):
    assert quality_ab.ARCHS == jax_tool.ARCHS
    assert quality_ab.ARCHS["nafnet_tpu_w64"]["width"] == 32


@pytest.mark.parametrize("name", ["nafnet_w32", "nafnet_tpu_w64"])
def test_build_opt_equals_jax(jax_tool, name):
    args = (name, quality_ab.ARCHS[name], "/data/sid", "/work", 5000, 2, 384)
    assert quality_ab.build_opt(*args) == jax_tool.build_opt(*args)
    assert quality_ab.build_opt(*args, seed=3) == jax_tool.build_opt(
        *args, seed=3)


def _defaults(main, argv):
    """The parsed flags of ``main`` on ``argv``, caught before it runs."""
    seen = {}

    class Parsed(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        seen.update(vars(orig(self, args, namespace)))
        raise Parsed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", catch)
        mp.setattr(sys, "argv", ["quality_ab.py", *argv])
        with pytest.raises(Parsed):
            main(argv) if main is quality_ab.main else main()
    return seen


def test_flags_equal_jax_but_out_width_and_seed(jax_tool):
    argv = ["--steps", "7", "--archs", "nafnet_w32", "--n-train", "3"]
    want = _defaults(jax_tool.main, argv)
    got = _defaults(quality_ab.main, argv)
    assert want.pop("out") == "quality_ab.json"
    assert got.pop("out") == "quality_ab_torch.json"
    assert got.pop("width") is None and got.pop("device") == "cuda"
    build_opt_seed = jax_tool.build_opt.__defaults__[0]
    assert got.pop("seed") == build_opt_seed == 7
    assert got == want


def test_with_width_sets_each_arch_width():
    for name, net in quality_ab.ARCHS.items():
        cut = quality_ab.with_width(net, 8)
        assert (cut.get("nafnet_params") or cut)["width"] == 8
        assert (net.get("nafnet_params") or net)["width"] == 32, name


@pytest.fixture
def lpips_alex_npz(tmp_path, monkeypatch):
    """One LPIPS-alex weight file for both packages (the port's random
    trunk, heads redrawn) through ``$LLIE_LPIPS_NPZ``, for one test."""
    module, _ = load_lpips(net="alex")
    rng = np.random.default_rng(16)
    arrays = {k: (rng.uniform(0, 0.2, v.numel()).astype(np.float32)
                  if k.startswith("lin") else v.numpy())
              for k, v in module.state_dict().items()}
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **arrays)
    monkeypatch.setenv("LLIE_LPIPS_NPZ", str(path))
    return path


def _small(net_opt):
    """Width 8, one block a level, fp32 activations (``NAFNetTPU``
    defaults to bf16 in both packages, whatever ``enable_amp`` says),
    same type."""
    net = copy.deepcopy(net_opt)
    sub = net.get("nafnet_params") or net
    sub.update(width=8, enc_blk_nums=[1, 1], middle_blk_num=1,
               dec_blk_nums=[1, 1])
    net["dtype"] = "float32"
    return net


@pytest.fixture(scope="module", params=["nafnet_w32", "nafnet_tpu_w64"])
def ab_runs(request, data_root, tmp_path_factory):
    """The tool's recipe for one architecture (cut by ``_small``, fp32)
    through the JAX and the port's Trainer, ``ITERS`` iterations each,
    the port from the JAX initial params."""
    name = request.param
    opt = quality_ab.build_opt(name, _small(quality_ab.ARCHS[name]),
                               data_root, str(tmp_path_factory.mktemp("ab")),
                               ITERS, 2, 32)
    opt["train"]["enable_amp"] = False
    jtrainer = JaxTrainer(copy.deepcopy(opt))
    init = _jax_tree(jtrainer.state.params)
    jlosses = []
    step = jtrainer.step_fn

    def recording(state, batch):
        state, logs = step(state, batch)
        jlosses.append(float(logs["l_total"]))
        return state, logs

    jtrainer.step_fn = recording
    jtrainer.train()
    trainer = Trainer(copy.deepcopy(opt), device="cpu")
    trainer.net.load_state_dict(bridge_for(trainer.net)(init,
                                                        model=trainer.net))
    trainer.train()
    return dict(opt=opt, jtrainer=jtrainer, jlosses=jlosses, trainer=trainer)


def _jax_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def test_recipe_trains_as_jax(ab_runs):
    """The tool's raw options dict (no ``parse``) trains in the port's
    Trainer as in JAX's: ``l_total`` of every iteration to rtol 1e-4."""
    hist = ab_runs["trainer"].history
    assert [h["iter"] for h in hist] == list(range(1, ITERS + 1))
    assert len(ab_runs["jlosses"]) == ITERS
    np.testing.assert_allclose([h["l_total"] for h in hist],
                               ab_runs["jlosses"], rtol=RTOL)


def test_evaluate_full_equals_jax(jax_tool, ab_runs, lpips_alex_npz):
    """Both tools' ``evaluate_full`` on the JAX Trainer's final params
    (bridged into the port's Trainer)."""
    jtrainer, trainer, opt = (ab_runs["jtrainer"], ab_runs["trainer"],
                              ab_runs["opt"])
    want = jax_tool.evaluate_full(jtrainer, opt)
    trainer.net.load_state_dict(bridge_for(trainer.net)(
        _jax_tree(jtrainer.state.params), model=trainer.net))
    got = quality_ab.evaluate_full(trainer, opt)
    assert set(got) == set(want) == {"psnr", "ssim", "deltae", "lpips",
                                     "phys_mae", "lpips_pretrained"}
    assert got.pop("lpips_pretrained") is want.pop("lpips_pretrained") is True
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)


def _structure(tree):
    """Keys and nesting of a JSON tree, leaves replaced by their type."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return "bool" if isinstance(tree, bool) else type(tree).__name__


def test_main_both_archs_end_to_end(data_root, tmp_path, capsys,
                                    monkeypatch):
    monkeypatch.delenv("LLIE_LPIPS_NPZ", raising=False)
    out = tmp_path / "ab.json"
    got = quality_ab.main([
        "--archs", "nafnet_w32", "nafnet_tpu_w64", "--width", "8",
        "--steps", "2", "--crop", "32", "--size", "64", "--n-train", "2",
        "--data-root", data_root, "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    for name in quality_ab.ARCHS:     # the per-architecture sub-runs' files
        assert (tmp_path / f"ab.json.{name}.json").exists()
    ref = json.loads((REPO / "quality_ab.json").read_text())
    assert _structure(got) == _structure(ref)
    assert got["protocol"]["steps"] == 2 and got["protocol"]["crop"] == 32
    for name, res in got["archs"].items():
        assert res["metrics"]["lpips_pretrained"] is False, name
        assert all(np.isfinite(v) for k, v in res["metrics"].items()
                   if k != "lpips_pretrained"), name
