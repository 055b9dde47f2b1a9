"""Download utilities (stock BasicSR ``download_util`` parity).

The port's own copy of ``lowlight_image_enhancement_tpu/utils/
download_util.py``.

``download_file_from_url`` with resume support, progress reporting, and
sha256 verification; ``load_file_from_url`` caches into a local model zoo
directory. Pure-stdlib (urllib); in an offline environment these raise the
usual URLErrors — the cache-hit path still works.
"""

from __future__ import annotations

import hashlib
import os
import sys
import urllib.request
from typing import Optional


def sha256_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def download_file_from_url(
    url: str,
    dest: str,
    expected_sha256: Optional[str] = None,
    resume: bool = True,
    progress: bool = True,
) -> str:
    """Download ``url`` to ``dest`` (atomic via .part file, byte-range
    resume when the server supports it). Returns ``dest``."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    part = dest + ".part"
    start = os.path.getsize(part) if (resume and os.path.exists(part)) else 0

    req = urllib.request.Request(url)
    if start:
        req.add_header("Range", f"bytes={start}-")
    with urllib.request.urlopen(req) as resp:
        total = resp.headers.get("Content-Length")
        total = int(total) + start if total else None
        mode = "ab" if start and resp.status == 206 else "wb"
        if mode == "wb":
            start = 0
        done = start
        with open(part, mode) as f:
            while True:
                block = resp.read(1 << 16)
                if not block:
                    break
                f.write(block)
                done += len(block)
                if progress and total:
                    pct = 100.0 * done / total
                    sys.stderr.write(f"\r{os.path.basename(dest)}: "
                                     f"{pct:5.1f}%")
        if progress and total:
            sys.stderr.write("\n")

    if expected_sha256:
        got = sha256_of(part)
        if got != expected_sha256:
            os.remove(part)
            raise ValueError(
                f"sha256 mismatch for {url}: got {got}, "
                f"expected {expected_sha256}"
            )
    os.replace(part, dest)
    return dest


def load_file_from_url(
    url: str,
    model_dir: Optional[str] = None,
    file_name: Optional[str] = None,
    expected_sha256: Optional[str] = None,
) -> str:
    """Cached download: returns the local path, downloading only on miss
    (reference ``load_file_from_url``)."""
    model_dir = model_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "llie_torch", "weights"
    )
    name = file_name or os.path.basename(url.split("?")[0])
    dest = os.path.join(model_dir, name)
    if os.path.exists(dest):
        if expected_sha256 and sha256_of(dest) != expected_sha256:
            os.remove(dest)
        else:
            return dest
    return download_file_from_url(url, dest,
                                  expected_sha256=expected_sha256)
