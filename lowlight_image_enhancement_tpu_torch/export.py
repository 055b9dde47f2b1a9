"""Ahead-of-time export for serving: one ``torch.export`` program per
bucket. Counterpart of ``lowlight_image_enhancement_tpu/export.py``.

The artifact is a directory:

- ``manifest.json``: format version, buckets, batch, platforms (the one
  device type the programs were exported for), the device they were
  exported on, network options, torch version;
- ``bucket_{B}x{H}x{W}.pt2``: one ``torch.export.save`` program per
  bucket, taking ``(params, x[B, H, W, 3] float32)`` -> the forward
  clipped to [0, 1], float32 NHWC (NCHW inside, the net's own dtype);
- ``params.npz``: the flat ``{name: array}`` of the network's parameters,
  kept OUTSIDE the programs, so one file serves every bucket and can be
  swapped without exporting again.

The fused NAFBlock's K1/K2 and the LayerNorm's K5 are registered ops
(``llie_torch::nafblock_a``, ``nafblock_b``, ``ln_fwd``): every program
holds one node per kernel call and, on the card, launches the kernels.

:class:`ExportedModel` serves from the artifact alone: it imports the two
modules that register those ops (``ops/nafblock.py``,
``ops/layernorm.py``) and no model code. Bucket choice, zero padding and
crop-back are JAX's.

Sharded export (``mesh=``, an in-process mesh of ``n`` local devices):
``batch`` must divide by ``n``; each program takes the per-device batch
``batch / n`` and the manifest records ``"mesh": {"axis": ..., "size":
n}``. :class:`ExportedModel` of such an artifact needs ``n`` devices: it
loads the programs and the parameters on each and splits every
``batch`` across them, in order. A program names the device it was
exported on in its graph; one loaded on another device is moved there
(``torch.export.passes.move_to_device_pass``).

CLI::

    python -m lowlight_image_enhancement_tpu_torch.export -opt <yaml> \\
        --out <dir> --buckets 256,512x768 [--batch 1] [--mesh N] \\
        [--device cuda] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the modules that register the kernels' ops, which the programs call
import lowlight_image_enhancement_tpu_torch.ops.layernorm  # noqa: F401
import lowlight_image_enhancement_tpu_torch.ops.nafblock  # noqa: F401
from lowlight_image_enhancement_tpu_torch import resolve_device

_FORMAT_VERSION = 1
_SEP = "//"  # flat param-path separator (param names may contain '/')
KIND = "lowlight_image_enhancement_tpu_torch.export"


# ---------------------------------------------------------------------------
# param tree <-> flat npz
# ---------------------------------------------------------------------------

def flatten_params(params: Any) -> Dict[str, np.ndarray]:
    """Nested param dict -> flat ``{'a//b//w': ndarray}``."""
    out: Dict[str, np.ndarray] = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, prefix + [str(k)])
        else:
            out[_SEP.join(prefix)] = np.asarray(node)

    rec(params, [])
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_params`."""
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

class ClippedForward(torch.nn.Module):
    """``forward(params, x[B, H, W, 3] fp32)`` -> ``clip(net(x), 0, 1)``
    fp32 NHWC, with ``net``'s parameters taken from ``params`` through
    ``torch.func.functional_call``. ``net`` is held outside the module's
    state, so an exported program embeds no weight."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self._net = (net,)

    def forward(self, params: Dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
        y = torch.func.functional_call(
            self._net[0], params, (x.permute(0, 3, 1, 2).contiguous(),))
        return y.float().clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def net_state(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The network's parameters and buffers by name, detached."""
    state = dict(net.named_parameters())
    state.update(net.named_buffers())
    return {k: v.detach() for k, v in state.items()}


def export_model(
    net: torch.nn.Module,
    out_dir: str,
    buckets: Sequence[Tuple[int, int]] = ((256, 256), (512, 512)),
    batch: int = 1,
    device: Any = "cuda",
    network_opt: Optional[dict] = None,
    mesh=None,
) -> str:
    """Export the clipped forward of ``net`` at each static bucket shape
    on ``device`` (the programs run there only). With ``mesh`` (an
    in-process mesh) the programs take ``batch / mesh.size`` images and
    are exported on the mesh's first device. Returns ``out_dir``."""
    per = batch
    if mesh is not None:
        if mesh.distributed:
            raise ValueError("export takes an in-process mesh of local "
                             "devices (create_mesh(devices=[...]))")
        if batch % mesh.size:
            raise ValueError(
                f"batch {batch} not divisible by mesh size {mesh.size}")
        per = batch // mesh.size
        device = mesh.devices[0]
    dev = resolve_device(device)
    made_on = _placed(dev)
    os.makedirs(out_dir, exist_ok=True)
    net = net.to(dev).eval()
    state = net_state(net)
    np.savez(os.path.join(out_dir, "params.npz"),
             **flatten_params({k: v.cpu().numpy() for k, v in state.items()}))
    forward = ClippedForward(net)
    bucket_files = {}
    for h, w in buckets:
        x = torch.zeros((per, int(h), int(w), 3), device=dev)
        with torch.no_grad():
            program = torch.export.export(forward, (state, x), strict=False)
        program.example_inputs = None   # else saved with the program
        name = f"bucket_{per}x{int(h)}x{int(w)}.pt2"
        torch.export.save(program, os.path.join(out_dir, name))
        bucket_files[f"{int(h)}x{int(w)}"] = name

    manifest = {
        "format_version": _FORMAT_VERSION,
        "kind": KIND,
        "batch": int(batch),
        "buckets": sorted([list(map(int, b)) for b in buckets]),
        "bucket_files": bucket_files,
        "platforms": [dev.type],
        "device": made_on,
        "torch_version": torch.__version__,
        "network_opt": network_opt or {},
        "mesh": ({"axis": mesh.axis_name, "size": mesh.size}
                 if mesh is not None else None),
        "io": "forward(params, x[B,H,W,3] float32 RGB [0,1]) -> "
              "float32 clipped [0,1]",
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return out_dir


# ---------------------------------------------------------------------------
# load + serve
# ---------------------------------------------------------------------------

class ExportedModel:
    """Load an export directory and serve images from its programs.

    Runs on the device the manifest names (``device`` may only name the
    same) and raises where it is absent. Bucket choice, zero padding and
    crop-back are those of the JAX ``ExportedModel``. A sharded artifact
    runs on ``devices`` (default: the first ``n`` CUDA devices, or ``n``
    times the CPU), ``mesh`` then being their in-process mesh."""

    def __init__(self, path: str, device: Any = None,
                 devices: Optional[Sequence[Any]] = None):
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported export format "
                f"{self.manifest.get('format_version')!r} "
                f"(this loader speaks {_FORMAT_VERSION})")
        platform = self.manifest["platforms"][0]
        self.device = resolve_device(platform if device is None else device)
        if self.device.type != platform:
            raise ValueError(f"the export at {path} runs on {platform}, "
                             f"not on {self.device}")
        self.batch = int(self.manifest["batch"])
        self.mesh = None
        devs = [self.device]
        mesh_info = self.manifest.get("mesh")
        if mesh_info:
            from lowlight_image_enhancement_tpu_torch.parallel.mesh import (
                create_mesh,
            )

            n = int(mesh_info["size"])
            if devices is None and platform == "cuda":
                if torch.cuda.device_count() < n:
                    raise ValueError(
                        f"sharded export needs {n} devices, "
                        f"{torch.cuda.device_count()} visible")
                devices = [f"cuda:{i}" for i in range(n)]
            elif devices is None:
                devices = [platform] * n
            self.mesh = create_mesh(n, mesh_info["axis"], devices)
            devs = list(self.mesh.devices)
            if len(devs) != n or any(d.type != platform for d in devs):
                raise ValueError(f"the export at {path} runs on {n} "
                                 f"{platform} devices, not on {devs}")
            self.device = devs[0]
        # artifacts without "device" were all exported on the first card
        made_on = self.manifest.get(
            "device", "cuda:0" if platform == "cuda" else platform)
        with np.load(os.path.join(path, "params.npz")) as flat:
            host = {k: torch.from_numpy(flat[k]) for k in flat.files}
        # (device, params, {bucket: program}) per device of the mesh
        self._replicas: List[Tuple[torch.device, Dict[str, torch.Tensor],
                                   Dict[Tuple[int, int], Any]]] = []
        files = {tuple(map(int, key.split("x"))): os.path.join(path, fname)
                 for key, fname in self.manifest["bucket_files"].items()}
        if not files:
            raise ValueError(f"export at {path} contains no buckets")
        for dev in devs:
            # each device loads its own programs: the move changes the
            # program it is given
            self._replicas.append((
                dev, {k: v.to(dev) for k, v in host.items()},
                {b: _on_device(torch.export.load(f), dev, made_on).module()
                 for b, f in files.items()}))
        self.params = self._replicas[0][1]
        self._fns = self._replicas[0][2]

    @property
    def buckets(self) -> List[Tuple[int, int]]:
        return sorted(self._fns)

    def _pick_bucket(self, h: int, w: int) -> Tuple[int, int]:
        fits = [(bh, bw) for bh, bw in self.buckets if bh >= h and bw >= w]
        if not fits:
            raise ValueError(
                f"input {h}x{w} exceeds every exported bucket "
                f"{self.buckets}; re-export with a larger bucket or use "
                f"the live RestorationServer tiled path")
        return min(fits, key=lambda b: b[0] * b[1])

    def _call(self, bucket: Tuple[int, int], x: np.ndarray) -> np.ndarray:
        """``x`` (``batch`` images) split in order over the devices."""
        parts = np.split(x, len(self._replicas))
        ys = []
        with torch.no_grad():
            for (dev, params, fns), part in zip(self._replicas, parts):
                ys.append(fns[bucket](params, torch.from_numpy(part).to(dev)))
        return np.concatenate([y.cpu().numpy() for y in ys])

    def predict(self, img: np.ndarray) -> np.ndarray:
        """float [0,1] HWC RGB -> restored float32 HWC, same H x W."""
        img = np.asarray(img, np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"expected HWC RGB, got {img.shape}")
        h, w = img.shape[:2]
        bh, bw = self._pick_bucket(h, w)
        x = np.zeros((self.batch, bh, bw, 3), np.float32)
        x[0, :h, :w, :] = img
        return self._call((bh, bw), x)[0, :h, :w, :]

    def predict_batch(self, imgs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Serve many images, packing ``batch`` per call (one shared
        bucket per chunk: the one that fits the chunk's largest)."""
        imgs = [np.asarray(im, np.float32) for im in imgs]
        out: List[np.ndarray] = []
        for start in range(0, len(imgs), self.batch):
            chunk = imgs[start:start + self.batch]
            bh, bw = self._pick_bucket(max(im.shape[0] for im in chunk),
                                       max(im.shape[1] for im in chunk))
            x = np.zeros((self.batch, bh, bw, 3), np.float32)
            for i, im in enumerate(chunk):
                x[i, :im.shape[0], :im.shape[1], :] = im
            y = self._call((bh, bw), x)
            out.extend(y[i, :im.shape[0], :im.shape[1], :]
                       for i, im in enumerate(chunk))
        return out


def _placed(dev: torch.device) -> str:
    """The device a tensor put on ``dev`` lies on (``cuda`` names the
    current card by its index)."""
    return str(torch.empty(0, device=dev).device)


def _on_device(program, dev: torch.device, made_on: str):
    """``program``, exported on ``made_on``, with every device its graph
    names moved to ``dev`` (in place); as it is where ``dev`` is
    ``made_on``."""
    target = _placed(dev)
    if target == made_on:
        return program
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, target)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def parse_buckets(spec: str) -> List[Tuple[int, int]]:
    """``"256,512x768"`` -> ``[(256, 256), (512, 768)]``: square sides or
    ``HxW`` pairs."""
    out = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        if "x" in tok:
            h, w = tok.split("x")
            out.append((int(h), int(w)))
        else:
            out.append((int(tok), int(tok)))
    if not out:
        raise ValueError(f"no buckets in {spec!r}")
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="Export a network to per-bucket torch.export programs")
    ap.add_argument("-opt", required=True, help="network/eval yaml")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--buckets", default="256,512")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--mesh", type=int, default=None,
                    help="shard each batch over N local devices (the "
                         "first N CUDA devices; N times the CPU with "
                         "--device cpu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="reload the artifact and check it against the "
                         "live forward (1e-5)")
    args = ap.parse_args(argv)

    from lowlight_image_enhancement_tpu_torch.demo import load_weights
    from lowlight_image_enhancement_tpu_torch.models import define_network
    from lowlight_image_enhancement_tpu_torch.training.config import parse

    opt = parse(args.opt, is_train=False)
    network_opt = dict(opt["network_g"])
    dev = resolve_device(args.device)
    torch.manual_seed(0)
    net = define_network(dict(network_opt), device=dev).eval()
    pretrain = (opt.get("path") or {}).get("pretrain_network_g")
    if pretrain:
        load_weights(net, pretrain)
    buckets = parse_buckets(args.buckets)
    mesh = None
    if args.mesh:
        from lowlight_image_enhancement_tpu_torch.parallel.mesh import (
            create_mesh,
        )

        mesh = create_mesh(args.mesh, devices=(
            [dev] * args.mesh if dev.type == "cpu" else None))
    export_model(net, args.out, buckets=buckets, batch=args.batch,
                 device=dev, network_opt=network_opt, mesh=mesh)
    sizes = {f: os.path.getsize(os.path.join(args.out, f))
             for f in sorted(os.listdir(args.out))}
    print(f"exported {len(buckets)} bucket(s) -> {args.out} "
          f"({sum(sizes.values()) / 1e6:.1f} MB): "
          + ", ".join(f"{f} {s / 1e6:.1f}MB" for f, s in sizes.items()))

    if args.smoke:
        model = ExportedModel(args.out)
        h, w = model.buckets[0]
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 1, (h - 3, w - 5, 3)).astype(np.float32)
        got = model.predict(img)
        x = np.zeros((args.batch, h, w, 3), np.float32)
        x[0, :img.shape[0], :img.shape[1]] = img
        with torch.no_grad():
            want = ClippedForward(net)(net_state(net),
                                       torch.from_numpy(x).to(dev))
        want = want.cpu().numpy()[0, :img.shape[0], :img.shape[1]]
        err = float(np.max(np.abs(got - want)))
        print(f"smoke: max|exported - live| = {err:.3e}")
        if err > 1e-5:
            raise SystemExit("smoke FAILED (tolerance 1e-5)")
    return args.out


if __name__ == "__main__":
    main()
