"""Evaluation CLI::

    python -m lowlight_image_enhancement_tpu_torch.test -opt <yaml> \
        [--device cuda|cpu]

Counterpart of ``lowlight_image_enhancement_tpu/test.py`` (reference
``basicsr/test.py:19-70``): parse the config with ``is_train=False``,
build the network, load ``path.pretrain_network_g`` through
``demo.load_weights`` (a ``.pth`` state_dict or a ``.npz`` of JAX
params), and validate every ``datasets.test_*`` / ``datasets.val*``
split with the config's ``val.metrics``. Returns the results by split.
"""

from __future__ import annotations

import argparse
from typing import Dict

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.data import (
    create_dataset,
    create_loader,
)
from lowlight_image_enhancement_tpu_torch.demo import load_weights
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.logging_utils import (
    get_root_logger,
)
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    make_eval_step,
)
from lowlight_image_enhancement_tpu_torch.training.validation import validate


def main(argv=None) -> Dict[str, Dict[str, float]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    opt = parse(args.opt, is_train=False)
    dev = resolve_device(args.device)
    logger = get_root_logger()

    net = define_network(dict(opt["network_g"]), device=dev)
    pretrain = (opt.get("path") or {}).get("pretrain_network_g")
    if pretrain:
        load_weights(net, pretrain)
        logger.info("loaded network from %s", pretrain)
    forward = make_eval_step(net)

    val_opt = opt.get("val") or {}
    results = {}
    for phase, ds_opt in (opt.get("datasets") or {}).items():
        if not phase.startswith(("test", "val")):
            continue
        loader = create_loader(create_dataset(ds_opt), ds_opt)
        name = ds_opt.get("name", phase)
        results[name] = validate(forward, loader,
                                 val_opt.get("metrics") or {}, device=dev,
                                 tile_size=val_opt.get("crop_size"))
        logger.info("[%s] %s", name, results[name])
    return results


if __name__ == "__main__":
    main()
