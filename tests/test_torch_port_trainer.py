"""The port's training entry point against the JAX package's, on the CPU
(fp32), on ``configs/debug/sid_newbp_mono_debug.yml``:

- the port's ``Trainer`` and the JAX ``Trainer`` train the config's 16
  iterations on the same synthetic debug packs; the port starts from the
  JAX ``Trainer``'s initial params (``params_from_jax``), and the logged
  ``l_total`` agrees at every iteration to rtol 1e-4;
- ``validate`` of the port on the JAX ``Trainer``'s final params (bridged)
  and the port's val loader against the JAX ``Trainer.validate``: rtol
  1e-4;
- checkpoints: ``save_training_state`` -> ``restore_training_state`` gives
  equal bits (params, ``mu``, ``nu``, ``count``, step), the next step after
  a restore gives the logs of the step without it, ``auto_resume`` picks
  the largest step, and a resumed ``Trainer`` has the ``count`` and lr of
  the resumed JAX ``Trainer``; ``save_network``'s files load through
  ``demo.load_weights``;
- the ``${DEBUG_SID_ROOT}`` self-provisioning writes the JAX package's
  fixture bytes; a training mesh of several devices in one process
  raises (``train.zero1`` in one process trains unsharded);
- ``train.main`` and ``test.main`` with ``--device cpu``.

The JAX loader runs with ``num_workers=0``; the port's Trainer loads
ahead on its thread pool (its crop draws stay in item order), and no
pool thread outlives ``train()``.
"""

import os
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch
import yaml

from lowlight_image_enhancement_tpu.data import make_debug_sid as jax_make_debug_sid
from lowlight_image_enhancement_tpu.training.config import parse as jax_parse
from lowlight_image_enhancement_tpu.training.trainer import Trainer as JaxTrainer
from lowlight_image_enhancement_tpu_torch import test as port_test
from lowlight_image_enhancement_tpu_torch import train as port_train
from lowlight_image_enhancement_tpu_torch.demo import load_weights
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.training import checkpoint as ckpt
from lowlight_image_enhancement_tpu_torch.training import config as port_config
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    make_eval_step,
)
from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer
from lowlight_image_enhancement_tpu_torch.training.validation import validate
from lowlight_image_enhancement_tpu_torch.weights import params_from_jax

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "debug",
                      "sid_newbp_mono_debug.yml")
ITERS = 16


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


def _jax_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


@pytest.fixture(scope="module")
def runs(debug_root, tmp_path_factory):
    """The JAX and the port's Trainer over the config's 16 iterations, the
    port from the JAX initial params."""
    jroot = tmp_path_factory.mktemp("jax_exp")
    jopt = jax_parse(CONFIG, is_train=True, root_dir=str(jroot))
    jtrainer = JaxTrainer(jopt)
    init = _jax_tree(jtrainer.state.params)
    jlosses = []
    step = jtrainer.step_fn

    def recording(state, batch):
        state, logs = step(state, batch)
        jlosses.append(float(logs["l_total"]))
        return state, logs

    jtrainer.step_fn = recording
    jtrainer.train()

    root = tmp_path_factory.mktemp("port_exp")
    opt = parse(CONFIG, is_train=True, root_dir=str(root))
    trainer = Trainer(opt, device="cpu")
    trainer.net.load_state_dict(params_from_jax(init, model=trainer.net))
    trainer.train()
    return dict(jopt=jopt, jtrainer=jtrainer, jlosses=jlosses, opt=opt,
                trainer=trainer)


def test_trainer_logs_match_jax(runs):
    hist = runs["trainer"].history
    assert [h["iter"] for h in hist] == list(range(1, ITERS + 1))
    got = [h["l_total"] for h in hist]
    assert len(runs["jlosses"]) == ITERS
    np.testing.assert_allclose(got, runs["jlosses"], rtol=1e-4)
    assert int(runs["trainer"].state.step) == ITERS
    # the JAX schedule runs in fp32, the port's in Python floats
    lrs = [h["lr"] for h in hist]
    np.testing.assert_allclose(
        lrs, [float(runs["jtrainer"].schedule(i)) for i in range(1, ITERS + 1)],
        rtol=1e-5)
    assert all(h["data_time"] >= 0 and h["time"] > 0 for h in hist)


def test_train_loader_decodes_ahead_and_ends_its_pool(runs):
    loader = runs["trainer"].train_loader
    assert loader.num_workers == min(
        2, max(len(os.sched_getaffinity(0)) // 4, 1))
    assert not [t for t in threading.enumerate()
                if t.name.startswith("loader_")]


def test_validate_matches_jax_on_bridged_weights(runs):
    trainer = runs["trainer"]
    net = define_network(dict(runs["opt"]["network_g"]), device="cpu")
    net.load_state_dict(params_from_jax(
        _jax_tree(runs["jtrainer"].state.params), model=net))
    metrics_opt = runs["opt"]["val"]["metrics"]
    got = validate(make_eval_step(net), trainer.val_loader, metrics_opt,
                   device="cpu")
    want = runs["jtrainer"].validate()
    assert set(got) == set(want) == {"psnr_linear", "ssim_linear"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    # tiled: one 64x64 val image in 32x32 tiles of the same network
    tiled = validate(make_eval_step(net), trainer.val_loader, metrics_opt,
                     device="cpu", tile_size=32, max_images=1)
    assert np.isfinite(tiled["psnr_linear"])


def _state_tensors(state):
    opt = state.optimizer
    return ([p.detach().clone() for p in opt.params]
            + [t.clone() for t in opt.mu] + [t.clone() for t in opt.nu])


def test_checkpoint_round_trip_is_bit_equal(runs, tmp_path):
    trainer = runs["trainer"]
    path = ckpt.save_training_state(str(tmp_path), trainer.state)
    assert os.path.basename(path) == f"{ITERS:08d}.pth"
    fresh = Trainer(dict(runs["opt"], path={}), device="cpu")
    assert fresh.state.optimizer.count == 0
    ckpt.restore_training_state(path, fresh.state)
    assert fresh.state.step == ITERS and fresh.state.optimizer.count == ITERS
    for a, b in zip(_state_tensors(trainer.state),
                    _state_tensors(fresh.state)):
        assert torch.equal(a, b)

    # the next step after the restore gives the logs of the step without it
    batch = next(iter(fresh.train_loader))
    nchw = {k: torch.from_numpy(np.ascontiguousarray(
        np.transpose(v, (0, 3, 1, 2)) if np.ndim(v) == 4 else v))
        for k, v in batch.items() if k not in ("pair_id", "key")}
    _, logs_restored = fresh.step_fn(fresh.state, nchw)
    _, logs_kept = trainer.step_fn(trainer.state, nchw)
    assert set(logs_restored) == set(logs_kept)
    for k in logs_kept:
        assert float(logs_restored[k]) == float(logs_kept[k]), k


def test_auto_resume_and_resumed_schedule_match_jax(runs):
    opt, jopt = runs["opt"], runs["jopt"]
    states = opt["path"]["training_states"]
    assert sorted(os.listdir(states)) == ["00000008.pth", "00000016.pth"]
    assert ckpt.latest_training_state(states).endswith("00000016.pth")
    assert ckpt.latest_training_state(os.path.join(states, "none")) is None
    resumed = Trainer(opt, device="cpu")
    jresumed = JaxTrainer(jopt)
    assert resumed.start_iter == jresumed.start_iter == ITERS
    count = resumed.state.optimizer.count
    assert count == int(jax.device_get(jresumed.state.step)) == ITERS
    assert resumed.schedule(count) == pytest.approx(
        float(jresumed.schedule(count)), rel=1e-5)
    # the params came back from the file written at step 16
    saved = torch.load(os.path.join(states, "00000016.pth"),
                       weights_only=True)["params"]
    for k, v in resumed.net.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_save_network_files_load_in_demo(runs, tmp_path):
    models = runs["opt"]["path"]["models"]
    assert {"net_g_00000008.pth", "net_g_00000016.pth",
            "net_g_latest.pth"} <= set(os.listdir(models))
    net = define_network(dict(runs["opt"]["network_g"]), device="cpu")
    load_weights(net, os.path.join(models, "net_g_latest.pth"))
    saved = torch.load(os.path.join(runs["opt"]["path"]["training_states"],
                                    "00000016.pth"),
                       weights_only=True)["params"]
    for k, v in net.state_dict().items():
        assert torch.equal(v, saved[k]), k
    # non-strict: a missing and a mis-shaped entry keep net's values
    sd = dict(net.state_dict())
    name = next(iter(sd))
    sd.pop(name)
    path = str(tmp_path / "partial.pth")
    torch.save(sd, path)
    with pytest.warns(UserWarning, match="non-strict"):
        ckpt.restore_network(path, net, strict=False)
    with pytest.raises(RuntimeError):
        ckpt.restore_network(path, net, strict=True)


def test_debug_root_self_provisioning_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("DEBUG_SID_ROOT", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    opt = parse(CONFIG, is_train=True, root_dir=str(tmp_path / "exp"))
    root = os.environ["DEBUG_SID_ROOT"]
    assert os.path.dirname(root) == str(tmp_path)
    assert opt["datasets"]["train"]["manifest_path"] == \
        f"{root}/manifest_sid_debug.json"
    jax_make_debug_sid(str(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        with open(os.path.join(root, name), "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    # a second parse reuses the set
    mtime = os.path.getmtime(os.path.join(root, "train_short.pack"))
    parse(CONFIG, is_train=True, root_dir=str(tmp_path / "exp"))
    assert os.path.getmtime(os.path.join(root, "train_short.pack")) == mtime
    assert "train:" in port_config.dict2str(opt)


def test_zero1_raises(runs):
    """``train.zero1`` shards over the ranks of a torch.distributed world
    (tests/test_torch_port_zero1.py); a training mesh of several devices
    in one process raises, and one process trains unsharded."""
    from lowlight_image_enhancement_tpu_torch.parallel import create_mesh

    opt = dict(runs["opt"], path={})
    opt["train"] = dict(opt["train"], zero1=True)
    with pytest.raises(ValueError, match="one process per device"):
        Trainer(opt, device="cpu", mesh=create_mesh(devices=["cpu", "cpu"]))
    trainer = Trainer(opt, device="cpu")
    assert trainer.mesh is None and trainer._zero1_shardings is None


def test_train_and_test_cli_on_cpu(debug_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port_train.main(["-opt", CONFIG, "--device", "cpu"])
    models = tmp_path / "experiments" / "sid_newbp_mono_debug" / "models"
    assert (models / "net_g_latest.pth").exists()
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["path"]["pretrain_network_g"] = str(models / "net_g_latest.pth")
    with open(tmp_path / "eval.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    results = port_test.main(["-opt", str(tmp_path / "eval.yml"),
                              "--device", "cpu"])
    assert set(results) == {"SID-debug-val"}
    assert set(results["SID-debug-val"]) == {"psnr_linear", "ssim_linear"}
    assert all(np.isfinite(v) for v in results["SID-debug-val"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_train.main(["-opt", CONFIG])


def test_message_logger_format_matches_jax(tmp_path):
    import logging

    from lowlight_image_enhancement_tpu.training import logging_utils as jlog
    from lowlight_image_enhancement_tpu_torch.training import (
        logging_utils as plog)

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.msgs = []

        def emit(self, record):
            self.msgs.append(record.getMessage())

    opt = {"name": "exp", "logger": {"print_freq": 1},
           "train": {"total_iter": 20}}
    got = []
    for mod in (plog, jlog):
        logger = mod.get_root_logger(str(tmp_path / f"{mod.__name__}.log"))
        keep = Keep()
        logger.addHandler(keep)
        try:
            mod.MessageLogger(opt, 1)({"iter": 12, "epoch": 3,
                                       "lrs": [2.5e-4], "l_total": 0.125,
                                       "m_psnr": 31.5})
        finally:
            logger.removeHandler(keep)
        got.append(keep.msgs)
    assert got[0] == got[1] and len(got[0]) == 1
    assert got[0][0].startswith("[exp][epoch:  3, iter:      12, lr:(2.500e-04)]")
