"""Stereo-image demo CLI, counterpart of ``lowlight_image_enhancement_tpu/
demo_ssr.py`` (reference ``basicsr/demo_ssr.py``)::

    python -m lowlight_image_enhancement_tpu_torch.demo_ssr -opt <yaml> \
        --input_l_path l.png --input_r_path r.png \
        --output_l_path out_l.png --output_r_path out_r.png \
        [--weights net.pth|.npz] [--device cuda|cpu]

Reads the left and right views, concatenates them on the channel axis
(the NAFSSR input), builds ``network_g``, loads ``--weights`` or
``path.pretrain_network_g`` as ``demo.py`` does (a ``.pth`` state_dict or
a ``.npz`` of JAX params), runs the eval forward and writes both views of
the output. Runs on the card unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.demo import (
    load_weights,
    read_image,
    write_image,
)
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    make_eval_step,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True)
    parser.add_argument("--input_l_path", required=True)
    parser.add_argument("--input_r_path", required=True)
    parser.add_argument("--output_l_path", required=True)
    parser.add_argument("--output_r_path", required=True)
    parser.add_argument("--weights", default=None,
                        help=".pth state_dict or .npz of JAX params")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    opt = parse(args.opt, is_train=False)
    dev = resolve_device(args.device)

    img_l = read_image(args.input_l_path)
    img_r = read_image(args.input_r_path)
    if img_l.shape != img_r.shape:
        raise ValueError(
            f"left/right shapes differ: {img_l.shape} vs {img_r.shape}")
    x = torch.from_numpy(np.concatenate([img_l, img_r], axis=-1))
    x = x.to(dev).permute(0, 3, 1, 2).contiguous()        # [1, 2C, H, W]

    net = define_network(dict(opt["network_g"]), device=dev)
    weights = args.weights or (opt.get("path") or {}).get(
        "pretrain_network_g")
    if weights:
        load_weights(net, weights)
    out = make_eval_step(net)(x).permute(0, 2, 3, 1).cpu().numpy()
    c = out.shape[-1] // 2
    write_image(args.output_l_path, out[..., :c])
    write_image(args.output_r_path, out[..., c:])
    print(f"inference {args.input_l_path} .. finished. "
          f"saved to {args.output_l_path}")
    print(f"inference {args.input_r_path} .. finished. "
          f"saved to {args.output_r_path}")


if __name__ == "__main__":
    main()
