"""The port's tools (``lowlight_image_enhancement_tpu_torch/tools``) against
the JAX tools of ``tools/`` on the CPU, through ``main(argv)``:

- ``create_sid_pack``: packs byte-equal to the JAX tool's over
  ``tests/test_offline_tools.py``'s PNG tree, with
  ``--placeholder-on-corrupt`` too (both in this process: the placeholder
  is seeded by ``hash(key)``);
- ``evaluate``: the report on ``configs/debug/sid_newbp_mono_debug.yml``
  equal to the JAX tool's within 1e-4, on the same data and weights (an
  orbax checkpoint for JAX, the same params as ``.npz`` for the port, one
  LPIPS-vgg file for both), and with ``--identity``;
- ``debug_losses``: every term, total and gradient norm to rtol 1e-4 (the
  JAX tool's values recorded as it runs; one VGG19 file for both);
- ``debug_overfit``: the first three ``l_total`` of each phase to rtol
  1e-4 from the JAX tool's initial weights, and both phases fall;
- ``profile_train``: the first-step ``l_total`` of its four loss subsets
  at width 8 on 2x32^2 against the JAX loss of the same forward, 1e-4;
- ``profile_step_families``: a non-empty summary (host operators here);
- ``make_niqe_params``: features and the fitted model equal to the JAX
  tool's (1e-6), the fit ranks noise worse, ``--synthetic``;
- ``debug_dataset``: the JAX tool's printed lines on the same packs;
- ``bench_input_pipeline`` / ``train_pipeline_e2e``: their keys at tiny
  sizes; ``convert_sid_raw_to_png``: the ``rawpy`` gate and the PNGs it
  writes through a stand-in ``rawpy``;
- ``utils/backend_probe``: the JAX probe's tests with a faked subprocess;
- reference checkpoints need no converter in the port: a seeded port
  NAFNet, Baseline, UNetSID and SwinIR through ``tools/convert_torch_*``
  and back through ``weights.bridge_for`` give the same bits, and
  ``demo.load_weights`` loads the result from a ``.pth`` strictly.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.data import make_debug_sid as jax_make_debug_sid
from lowlight_image_enhancement_tpu.losses import HybridLossPlus as JaxHybrid
from lowlight_image_enhancement_tpu.metrics.lpips_metric import (
    LPIPSMetric as JLPIPSMetric,
)
from lowlight_image_enhancement_tpu.models import create_newbp_net as jax_newbp
from lowlight_image_enhancement_tpu.ops.psf import (
    create_crosstalk_psf as jax_psf,
)
from lowlight_image_enhancement_tpu.training.train_step import (
    hybrid_batch_kwargs as jax_batch_kwargs,
)
from lowlight_image_enhancement_tpu_torch.demo import load_weights
from lowlight_image_enhancement_tpu_torch.metrics import lpips_metric
from lowlight_image_enhancement_tpu_torch.metrics.niqe import calculate_niqe
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.models.lpips import load_lpips
from lowlight_image_enhancement_tpu_torch.models.vgg import load_vgg19_features
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.tools import (
    bench_input_pipeline,
    convert_sid_raw_to_png,
    create_sid_pack,
    debug_dataset,
    debug_losses,
    debug_overfit,
    evaluate,
    make_niqe_params,
    profile_step_families,
    profile_train,
    train_pipeline_e2e,
)
from lowlight_image_enhancement_tpu_torch.utils import backend_probe, imgio
from lowlight_image_enhancement_tpu_torch.weights import bridge_for

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tools' networks here are many small ops: one intra-op thread,
    so that a run beside other test workers does not wait on idle
    threads' barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
DEBUG_CONFIG = str(REPO / "configs" / "debug" / "sid_newbp_mono_debug.yml")
RTOL = 1e-4


def _load_tool(name):
    """A JAX tool of ``tools/`` as a module (its siblings importable)."""
    sys.path.insert(0, str(TOOLS))
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tool_{name}", TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(TOOLS))
    return mod


def _run_jax_main(mod, monkeypatch, *argv):
    """The JAX tool's ``main()`` on ``argv``; returns its stdout."""
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def _flat(params):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}


def _seeded_nafnet_params(net, seed):
    """Seeded weights for a port ``NAFNet`` (every leaf, so no block is an
    identity), saved as a ``.pth``, and the same leaves as the JAX params
    tree (through ``tools/convert_torch_nafnet.py``, which the reference
    checkpoints take): no JAX ``init`` needed."""
    gen = torch.Generator().manual_seed(seed)
    sd = {k: 0.2 * torch.randn(v.shape, generator=gen)
          for k, v in net.state_dict().items()}
    net.load_state_dict(sd)
    conv = _load_tool("convert_torch_nafnet")
    return sd, conv.flat_to_tree(conv.convert_state_dict(sd))


# --- create_sid_pack -------------------------------------------------------

@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    """``tests/test_offline_tools.py``'s tree and its manifest."""
    root = tmp_path_factory.mktemp("sid_png")
    rng = np.random.default_rng(0)
    for sub in ("short", "long"):
        os.makedirs(root / sub)
    for pid in ("00001", "00002", "00003"):
        long_img = rng.integers(0, 65535, (64, 64, 3)).astype(np.uint16)
        imgio.imwrite(str(root / "long" / f"{pid}_00_10s.png"), long_img)
        for seq, expo in (("00", "0.1s"), ("01", "0.04s")):
            imgio.imwrite(str(root / "short" / f"{pid}_{seq}_{expo}.png"),
                          (long_img // 100).astype(np.uint16))
    manifest = root / "manifest.json"
    subprocess.run([sys.executable, str(TOOLS / "prepare_sid_manifest.py"),
                    "--root", str(root), "--output", str(manifest),
                    "--val-fraction", "0.34", "--test-fraction", "0"],
                   check=True, capture_output=True)
    return root, manifest


@pytest.mark.parametrize("corrupt", [False, True])
def test_create_sid_pack_bytes_equal_jax(png_tree, tmp_path, monkeypatch,
                                         capsys, corrupt):
    root, manifest = png_tree
    if corrupt:
        root = Path(shutil.copytree(root, tmp_path / "tree"))
        next((root / "short").glob("00002*")).write_bytes(b"not a png")
    flags = ["--manifest", str(manifest), "--root", str(root)]
    flags += ["--placeholder-on-corrupt"] if corrupt else []
    jax_out = _run_jax_main(_load_tool("create_sid_pack"), monkeypatch,
                            *flags, "--output", str(tmp_path / "jax"))
    written = create_sid_pack.main(flags + ["--output",
                                            str(tmp_path / "port")])
    assert capsys.readouterr().out.splitlines()[-1].split(" -> ")[0] == \
        jax_out.splitlines()[-1].split(" -> ")[0]
    assert set(written) == {"train", "val"}
    for name in ("train_short", "train_long", "val_short", "val_long"):
        assert (tmp_path / "port" / f"{name}.pack").read_bytes() == \
            (tmp_path / "jax" / f"{name}.pack").read_bytes(), name
    if corrupt:
        assert "placeholder" in jax_out
        with pytest.raises(OSError):
            create_sid_pack.main(flags[:4] + ["--output",
                                              str(tmp_path / "bad")])


# --- evaluate --------------------------------------------------------------

@pytest.fixture(scope="module")
def debug_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("debug_sid")
    jax_make_debug_sid(str(root))
    old = os.environ.get("DEBUG_SID_ROOT")
    os.environ["DEBUG_SID_ROOT"] = str(root)
    yield str(root)
    if old is None:
        os.environ.pop("DEBUG_SID_ROOT", None)
    else:
        os.environ["DEBUG_SID_ROOT"] = old


@pytest.fixture(scope="module")
def lpips_vgg_npz(tmp_path_factory):
    """One LPIPS-vgg weight file for both packages (the port's random
    trunk, heads redrawn), through ``$LLIE_LPIPS_NPZ``, with both metric
    caches emptied for this module."""
    module, _ = load_lpips(net="vgg")
    rng = np.random.default_rng(14)
    arrays = {k: (rng.uniform(0, 0.2, v.numel()).astype(np.float32)
                  if k.startswith("lin") else v.numpy())
              for k, v in module.state_dict().items()}
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz"
    np.savez(path, **arrays)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLIE_LPIPS_NPZ", str(path))
        mp.setattr(JLPIPSMetric, "_CACHE", {})
        mp.setattr(lpips_metric, "_CACHE", {})
        yield path


@pytest.fixture(scope="module")
def debug_weights(debug_root, tmp_path_factory):
    """Seeded width-8 ``NewBPNAFNet`` params: an orbax checkpoint (the JAX
    tool's ``--checkpoint``) and the same leaves as a flat ``.npz``."""
    import orbax.checkpoint as ocp

    opt = parse(DEBUG_CONFIG, is_train=False)
    _, tree = _seeded_nafnet_params(
        define_network(dict(opt["network_g"]), device="cpu"), 5)
    root = tmp_path_factory.mktemp("weights")
    ocp.PyTreeCheckpointer().save(str(root / "orbax"), tree)
    np.savez(root / "params.npz", **_flat(tree))
    return str(root / "orbax"), str(root / "params.npz")


@pytest.mark.parametrize("identity", [False, True])
def test_evaluate_matches_jax(debug_weights, lpips_vgg_npz, tmp_path,
                              monkeypatch, identity):
    orbax_dir, npz = debug_weights
    jflags = ["--identity"] if identity else ["--checkpoint", orbax_dir]
    flags = ["--identity"] if identity else ["--checkpoint", npz]
    want = json.loads(_run_jax_main(_load_tool("evaluate"), monkeypatch,
                                    "-opt", DEBUG_CONFIG, *jflags))
    out = tmp_path / "report.json"
    got = evaluate.main(["-opt", DEBUG_CONFIG, *flags, "--device", "cpu",
                         "--output", str(out)])
    assert json.loads(out.read_text()) == got
    for k in ("split", "dataset", "num_items"):
        assert got[k] == want[k], k
    assert got["model"].split(" @ ")[0] == want["model"].split(" @ ")[0]
    assert set(got["metrics"]) == set(want["metrics"])
    assert {"lpips", "phys_mae"} <= set(got["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=RTOL, err_msg=k)


def test_evaluate_refuses_orbax_and_missing_split(debug_weights):
    with pytest.raises(ValueError, match="orbax"):
        evaluate.main(["-opt", DEBUG_CONFIG, "--checkpoint",
                       debug_weights[0], "--device", "cpu", "--no-lpips"])
    with pytest.raises(SystemExit):
        evaluate.main(["-opt", DEBUG_CONFIG, "--split", "test",
                       "--device", "cpu"])


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        debug_losses.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["-opt", DEBUG_CONFIG, "--identity"])


# --- debug_losses ----------------------------------------------------------

@pytest.fixture
def vgg19_npz(tmp_path, monkeypatch):
    """One random VGG19 trunk for both packages (``$LLIE_VGG19_NPZ``)."""
    module, _ = load_vgg19_features()
    path = tmp_path / "vgg19.npz"
    np.savez(path, **{k: v.numpy() for k, v in module.state_dict().items()})
    monkeypatch.setenv("LLIE_VGG19_NPZ", str(path))
    return path


def test_debug_losses_matches_jax(vgg19_npz, monkeypatch, capsys):
    """The JAX tool's values, recorded as it computes them: each concrete
    ``HybridLossPlus`` call and each gradient."""
    calls, grads = [], []
    orig_call, orig_grad = JaxHybrid.__call__, jax.grad

    def record_call(self, *a, **k):
        out = orig_call(self, *a, **k)
        if not isinstance(out[0], jax.core.Tracer):
            calls.append(out)
        return out

    def record_grad(fn, *a, **k):
        g = orig_grad(fn, *a, **k)

        def wrapped(*x):
            out = g(*x)
            grads.append(float(jnp.linalg.norm(out)))
            return out
        return wrapped

    monkeypatch.setattr(JaxHybrid, "__call__", record_call)
    monkeypatch.setattr(jax, "grad", record_grad)
    _run_jax_main(_load_tool("debug_losses"), monkeypatch)
    monkeypatch.undo()

    got = debug_losses.main(["--device", "cpu"])
    assert "[OK] perceptual" in capsys.readouterr().out
    assert len(got) == len(calls) == len(grads) == 7
    for (name, res), (total, logs), gnorm in zip(got.items(), calls, grads):
        assert res["ok"], name
        np.testing.assert_allclose(res["total"], float(total), rtol=RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(res["grad_norm"], gnorm, rtol=RTOL,
                                   err_msg=name)
        assert set(res["terms"]) == set(logs), name
        for k, v in logs.items():
            np.testing.assert_allclose(res["terms"][k], float(v), rtol=RTOL,
                                       atol=1e-7, err_msg=f"{name} {k}")


# --- debug_overfit ---------------------------------------------------------

def test_debug_overfit_matches_jax(tmp_path, monkeypatch):
    """Three steps of each phase of the JAX tool (its initial params and
    ``l_total`` recorded at its train step), then the port's tool from
    those params."""
    import lowlight_image_enhancement_tpu.training as jtraining

    orig_make = jtraining.make_train_step
    runs = []

    def record_make(*a, **k):
        step = orig_make(*a, **k)
        run = {"params": None, "l_total": []}
        runs.append(run)

        def wrapped(state, batch):
            if run["params"] is None:
                run["params"] = jax.device_get(state.params)
            state, logs = step(state, batch)
            run["l_total"].append(float(logs["l_total"]))
            return state, logs
        return wrapped

    monkeypatch.setattr(jtraining, "make_train_step", record_make)
    tool = _load_tool("debug_overfit")
    with contextlib.redirect_stdout(io.StringIO()):
        tool.run("l1", 3, 32)
        tool.run("hybrid", 3, 32)
    flat = [_flat(r["params"]) for r in runs]
    assert all(np.array_equal(flat[0][k], flat[1][k]) for k in flat[0])
    np.savez(tmp_path / "init.npz", **flat[0])

    got = debug_overfit.main(["--steps", "3", "--device", "cpu",
                              "--weights", str(tmp_path / "init.npz")])
    for phase, run in zip(("l1", "hybrid"), runs):
        np.testing.assert_allclose(got[phase], run["l_total"], rtol=RTOL,
                                   err_msg=phase)
        assert got[phase][-1] < got[phase][0], phase


# --- profile_train / profile_step_families ---------------------------------

def test_profile_train_first_step_matches_jax(tmp_path):
    """Width 8 on the tool's seeded 2x32^2 batch, fp32: the JAX loss of
    each subset on the JAX forward of the same params."""
    kw = dict(img_channel=3, width=8, enc_blk_nums=(2, 2, 4, 8),
              middle_blk_num=12, dec_blk_nums=(2, 2, 2, 2))
    jnet = jax_newbp(nafnet_params=kw, dtype=jnp.float32)
    n, s = 2, 32
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32)
    short = rng.uniform(0, 0.2, (n, s, s, 3)).astype(np.float32)
    batch = {"lq": x, "gt": gt, "short_raw": short, "long_raw": gt,
             "short_obs": short, "expo_ratio": np.full((n,), 5.0)}
    sd, params = _seeded_nafnet_params(
        define_network({"type": "NewBPNAFNet", "nafnet_params": kw},
                       device="cpu"), 8)
    torch.save(sd, tmp_path / "w.pth")
    out = jax.jit(lambda p, a: jnet.apply({"params": p}, a))(params, x)
    jkw = jax_batch_kwargs(out, {k: jnp.asarray(v) for k, v in batch.items()})
    no = dict(use_perc=False, use_ssim=False)
    losses = {
        "l1_only": JaxHybrid(**no, use_deltaE=False, use_phys=False),
        "l1+phys": JaxHybrid(**no, use_deltaE=False,
                             physics_psf_module=jax_psf("mono")),
        "l1+deltaE": JaxHybrid(**no, use_deltaE=True, use_phys=False),
        "full": JaxHybrid(**no, use_deltaE=True,
                          physics_psf_module=jax_psf("mono")),
    }
    got = profile_train.main([
        "--device", "cpu", "--width", "8", "--size", "32", "--dtype",
        "float32", "--runs", "1", "--weights", str(tmp_path / "w.pth"),
        "--only", ",".join(losses)])
    assert set(got["train_step_ms"]) == set(losses)
    assert got["calls"] == {k: 4 for k in losses}
    for name, loss in losses.items():
        want = float(loss(**jkw)[0])
        np.testing.assert_allclose(got["first_l_total"][name], want,
                                   rtol=RTOL, err_msg=name)


def test_profile_train_fwd_and_gl1(capsys):
    got = profile_train.main(["--device", "cpu", "--width", "8", "--size",
                              "32", "--runs", "1", "--only", "fwd,gl1"])
    out = capsys.readouterr().out
    assert "forward b2 32^2 (chained):" in out and "grad(L1)" in out
    assert got["calls"] == {"fwd": 4, "gl1": 4}
    assert got["forward_ms"] > 0 and got["grad_l1_ms"] > 0
    assert got["train_step_ms"] == {}


def test_profile_step_families_prints_a_summary(tmp_path, capsys):
    got = profile_step_families.main([
        "--device", "cpu", "--width", "8", "--size", "32", "--top", "6",
        "--logdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "host (cpu_op) total over 5 steps" in out
    assert 0 < len(got["families_ms_per_step"]) <= 6
    assert got["ms_per_step"] > 0 and np.isfinite(got["l_total"])
    assert any("nafblock" in k.lower() for k in got["families_ms_per_step"])


# --- make_niqe_params ------------------------------------------------------

def _smooth_image(seed):
    r = np.random.default_rng(seed)
    base = r.uniform(50, 200, (6, 6))
    img = np.kron(base, np.ones((32, 32)))
    return img + r.normal(0, 2.0, img.shape)


def test_make_niqe_params_matches_jax_and_ranks_noise(tmp_path):
    jtool = _load_tool("make_niqe_params")
    images = [_smooth_image(s) for s in range(6)]
    feats = [make_niqe_params.features_of_image(im) for im in images]
    for im, f in zip(images, feats):
        np.testing.assert_allclose(f, jtool.features_of_image(im), rtol=1e-6,
                                   atol=1e-9)
    rgb = np.random.default_rng(3).uniform(0, 1, (200, 300, 3))
    np.testing.assert_allclose(make_niqe_params.features_of_image(rgb),
                               jtool.features_of_image(rgb), rtol=1e-6)
    stacked = np.concatenate(feats, axis=0)
    mu, cov = make_niqe_params.fit_pristine_model(stacked)
    jmu, jcov = jtool.fit_pristine_model(stacked)
    np.testing.assert_allclose(mu, jmu, rtol=1e-6)
    np.testing.assert_allclose(cov, jcov, rtol=1e-6, atol=1e-12)

    path = str(tmp_path / "pris.npz")
    np.savez(path, mu_pris_param=mu, cov_pris_param=cov)
    clean = _smooth_image(99)
    noisy = clean + np.random.default_rng(1).normal(0, 60, clean.shape)
    assert calculate_niqe(noisy, pris_params_path=path) > \
        calculate_niqe(clean, pris_params_path=path)


def test_make_niqe_params_cli(tmp_path):
    jtool = _load_tool("make_niqe_params")
    out = tmp_path / "syn.npz"
    got = make_niqe_params.main(["--synthetic", "1", "--output", str(out)])
    jmu, jcov = jtool.make_synthetic_params(1)
    np.testing.assert_allclose(np.load(out)["mu_pris_param"], jmu, rtol=1e-6)
    np.testing.assert_allclose(got["cov"], jcov, rtol=1e-6, atol=1e-12)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for s in range(2):
        imgio.imwrite(str(folder / f"{s}.png"),
                      np.clip(_smooth_image(s), 0, 255).astype(np.uint8))
    got = make_niqe_params.main(["--images", str(folder), "--output",
                                 str(tmp_path / "f.npz")])
    assert got["images"] == 2 and got["blocks"] == 2 * 4
    assert np.isfinite(got["mu"]).all()


# --- debug_dataset ---------------------------------------------------------

def test_debug_dataset_prints_the_jax_lines(tmp_path, capsys):
    paths = jax_make_debug_sid(str(tmp_path), n_pairs=3)
    args = (paths["manifest"], paths["train_short"], paths["train_long"],
            "train")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        _load_tool("debug_dataset").check(*args)
    got = debug_dataset.check(*args)
    assert capsys.readouterr().out == buf.getvalue()
    assert got["aligned_err"] < 1e-6 and not got["missing_short"]
    assert got["batch_lq_shape"] == [2, 32, 32, 3]
    assert debug_dataset.main(["--synthetic"])["records"] == 6
    with pytest.raises(SystemExit):
        debug_dataset.main([])


# --- input pipeline tools --------------------------------------------------

def test_bench_input_pipeline_rows(capsys):
    rows = bench_input_pipeline.main(["--size", "64", "--patch", "32",
                                      "--pairs", "2", "--batches", "2",
                                      "--workers", "0", "2"])
    assert [(r["comp"], r["workers"]) for r in rows] == [
        (c, w) for c in ("none", "zlib", "zlib_band") for w in (0, 2)]
    assert all(r["img_per_s"] > 0 for r in rows)
    assert "frame 64^2 uint16, patch 32, batch 2" in capsys.readouterr().out


def test_train_pipeline_e2e_keys(tmp_path, capsys):
    out = tmp_path / "e2e.json"
    got = train_pipeline_e2e.main([
        "--device", "cpu", "--steps", "2", "--patch", "32", "--frame-size",
        "64", "--pairs", "2", "--width", "8", "--json", str(out)])
    assert json.loads(capsys.readouterr().out) == json.loads(
        out.read_text()) == got
    keys = {"host_only_steps_per_sec", "host_only_items_per_sec",
            "host_decoded_mb_per_sec", "device_only_steps_per_sec",
            "end_to_end_steps_per_sec", "wall_over_device",
            "wall_over_bound", "bound"}
    assert keys <= set(got) and got["protocol"]["device"] == "cpu"
    assert got["bound"] in ("host", "device")
    assert all(got[k] > 0 for k in keys - {"bound"})
    np.testing.assert_allclose(
        got["wall_over_device"],
        got["end_to_end_steps_per_sec"] / got["device_only_steps_per_sec"])


# --- convert_sid_raw_to_png ------------------------------------------------

def test_convert_sid_raw_gates_on_rawpy(monkeypatch):
    monkeypatch.setitem(sys.modules, "rawpy", None)
    with pytest.raises(SystemExit, match="rawpy is required"):
        convert_sid_raw_to_png.main(["--input", "x", "--output", "y"])


def test_convert_sid_raw_writes_16bit_pngs(tmp_path, monkeypatch):
    frames = {}
    rng = np.random.default_rng(0)

    class Raw:
        def __init__(self, path):
            self.path = path

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def postprocess(self, use_camera_wb, no_auto_bright, output_bps):
            assert use_camera_wb and no_auto_bright and output_bps == 16
            return frames[os.path.basename(self.path)]

    monkeypatch.setitem(sys.modules, "rawpy",
                        types.SimpleNamespace(imread=Raw))
    for split, names in (("short", ["00001_00_0.1s.ARW", "00002_00_0.1s.arw"]),
                         ("long", ["00001_00_10s.ARW"])):
        (tmp_path / "in" / split).mkdir(parents=True)
        for name in names:
            (tmp_path / "in" / split / name).write_bytes(b"raw")
            frames[name] = rng.integers(0, 65535, (12, 10, 3)).astype(
                np.uint16)
    got = convert_sid_raw_to_png.main(["--input", str(tmp_path / "in"),
                                       "--output", str(tmp_path / "out")])
    assert got == {"short": 2, "long": 1}
    for name, frame in frames.items():
        split = "long" if "_10s" in name else "short"
        png = tmp_path / "out" / split / (os.path.splitext(name)[0] + ".png")
        np.testing.assert_array_equal(imgio.imread(str(png)), frame)


# --- backend_probe ---------------------------------------------------------

class TestBackendProbe:
    def test_parses_platform(self, monkeypatch):
        class FakeProc:
            returncode = 0
            stdout = "warnings...\ncuda\n"
            stderr = ""

        monkeypatch.setattr(backend_probe.subprocess, "run",
                            lambda *a, **k: FakeProc())
        assert backend_probe.probe_backend(attempts=1) == "cuda"

    def test_timeout_returns_none(self, monkeypatch):
        def hang(*a, **k):
            raise backend_probe.subprocess.TimeoutExpired(
                cmd="python", timeout=1)

        monkeypatch.setattr(backend_probe.subprocess, "run", hang)
        assert backend_probe.probe_backend(attempts=2, timeout_s=1) is None

    def test_env_overrides(self, monkeypatch):
        calls = []

        def fake_run(cmd, capture_output, text, timeout):
            calls.append(timeout)
            raise backend_probe.subprocess.TimeoutExpired(
                cmd="python", timeout=timeout)

        monkeypatch.setattr(backend_probe.subprocess, "run", fake_run)
        monkeypatch.setenv("LLIE_PROBE_ATTEMPTS", "2")
        monkeypatch.setenv("LLIE_PROBE_TIMEOUT_S", "0.25")
        assert backend_probe.probe_backend(attempts=5,
                                           timeout_s=99.0) is None
        assert calls == [0.25, 0.25]

    def test_failed_child_counts_as_an_attempt(self, monkeypatch):
        calls = []

        class Failed:
            returncode = 1
            stdout = ""
            stderr = "boom"

        def fake_run(*a, **k):
            calls.append(1)
            return Failed()

        monkeypatch.setattr(backend_probe.subprocess, "run", fake_run)
        assert backend_probe.probe_backend(attempts=3) is None
        assert len(calls) == 3

    def test_real_child_reports_cpu_under_the_force_knob(self,
                                                            monkeypatch):
        monkeypatch.setenv("LLIE_BENCH_FORCE_CPU", "1")
        assert backend_probe.probe_backend(attempts=1, timeout_s=120) == "cpu"


# --- reference checkpoints need no converter -------------------------------

ARCHS = {
    "NAFNet": ("convert_torch_nafnet", "convert_state_dict",
               dict(type="NAFNet", img_channel=3, width=8, middle_blk_num=1,
                    enc_blk_nums=[1, 1], dec_blk_nums=[1, 1])),
    "Baseline": ("convert_torch_baseline", "convert_state_dict",
                 dict(type="Baseline", img_channel=3, width=8,
                      middle_blk_num=1, enc_blk_nums=[1, 1],
                      dec_blk_nums=[1, 1], dw_expand=1, ffn_expand=2)),
    "UNetSID": ("convert_torch_unet", "convert_unet_state_dict",
                dict(type="UNetSID", in_channels=3, out_channels=3,
                     depths=[8, 16, 32], bilinear=False)),
    "SwinIR": ("convert_torch_swinir", "convert_state_dict",
               dict(type="SwinIR", img_channel=3, embed_dim=12,
                    depths=[2, 2], num_heads=[2, 2], window_size=4,
                    mlp_ratio=2.0)),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reference_checkpoint_needs_no_converter(arch, tmp_path):
    tool, fn, opt = ARCHS[arch]
    gen = torch.Generator().manual_seed(len(arch))
    model = define_network(opt, device="cpu")
    sd = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
          if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd, strict=True)
    flat = getattr(_load_tool(tool), fn)(model.state_dict())
    tree = _load_tool("convert_torch_nafnet").flat_to_tree(flat)
    back = bridge_for(model)(tree, model=model)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    torch.save(back, tmp_path / "net.pth")
    fresh = define_network(opt, device="cpu")
    load_weights(fresh, str(tmp_path / "net.pth"))
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
