"""Single-image demo CLI, counterpart of ``lowlight_image_enhancement_tpu/
demo.py``::

    python -m lowlight_image_enhancement_tpu_torch.demo -opt <yaml> \
        --input_path in.png --output_path out.png [--weights net.pth|.npz]

Builds the network from the YAML's ``network_g``, optionally loads a
PyTorch ``state_dict`` (``.pth``) or the JAX parameters saved as ``.npz``
(flat ``path/to/param`` keys, as ``tools/convert_torch_nafnet.py`` writes
them), runs the (optionally tiled) forward and writes the result.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.validation import (
    tiled_inference,
)
from lowlight_image_enhancement_tpu_torch.utils import imgio
from lowlight_image_enhancement_tpu_torch.weights import bridge_for


def read_image(path: str) -> np.ndarray:
    """-> float32 [0,1] NHWC (N=1), RGB."""
    img = imgio.imread(path)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    return imgio.to_float01(img[..., :3])[None]


def write_image(path: str, img: np.ndarray) -> None:
    """NHWC float [0,1] -> 8-bit PNG."""
    imgio.imwrite(path, imgio.to_uint8(np.asarray(img)[0]))


def _flat_to_tree(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def load_weights(net: torch.nn.Module, path: str) -> None:
    """Load a ``.pth`` state_dict or a ``.npz`` of JAX params (through the
    bridge of ``net``'s architecture, :func:`...weights.bridge_for`) into
    ``net``."""
    if path.endswith(".npz"):
        sd = bridge_for(net)(_flat_to_tree(dict(np.load(path))), model=net)
    elif path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("params", sd)
    else:
        raise ValueError(
            f"unsupported weights {path!r}: pass a .pth state_dict or a .npz "
            "of JAX params (orbax checkpoints are not read by the port yet)")
    net.load_state_dict(sd, strict=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--tile", type=int, default=None,
                        help="tile size for grids inference")
    parser.add_argument("--weights", default=None,
                        help=".pth state_dict or .npz of JAX params")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    opt = parse(args.opt, is_train=False)
    dev = resolve_device(args.device)

    net = define_network(dict(opt["network_g"]), device=dev).eval()
    weights = args.weights or (opt.get("path", {}) or {}).get(
        "pretrain_network_g")
    if weights:
        load_weights(net, weights)

    def forward(z: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(z).to(dev).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            return net(x).permute(0, 2, 3, 1).cpu().numpy()

    x = read_image(args.input_path)
    out = tiled_inference(forward, x, args.tile) if args.tile else forward(x)
    write_image(args.output_path, out)
    print(f"wrote {args.output_path}")


if __name__ == "__main__":
    main()
