"""Bounded CUDA-backend reachability probe.

Counterpart of ``lowlight_image_enhancement_tpu/utils/backend_probe.py``
(which probes ``jax.devices()``). A card that does not answer can make the
first CUDA call hang rather than raise, which would wedge any caller that
touches the device first. The probe therefore asks
``torch.cuda.is_available()`` and starts one tiny kernel in a SUBPROCESS
under a hard timeout; the parent never initializes CUDA itself.

``probe_backend`` reports the platform the child would run on: ``cuda``
when the card answered, ``cpu`` when CUDA is absent or when
``$LLIE_BENCH_FORCE_CPU`` is set (the smoke-test knob). A caller that needs
the card compares the result with ``"cuda"``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional

_PROBE_CODE = (
    "import os, torch\n"
    "if os.environ.get('LLIE_BENCH_FORCE_CPU') "
    "or not torch.cuda.is_available():\n"
    "    print('cpu', flush=True)\n"
    "else:\n"
    "    torch.ones(1, device='cuda').add_(1)\n"
    "    torch.cuda.synchronize()\n"
    "    print('cuda', flush=True)\n"
)


def probe_backend(attempts: int = 3,
                  timeout_s: float = 240.0) -> Optional[str]:
    """Return the platform string (``cuda`` or ``cpu``), or None if the
    probe hangs or fails in each of ``attempts`` bounded tries.

    ``$LLIE_PROBE_ATTEMPTS`` / ``$LLIE_PROBE_TIMEOUT_S`` override the
    caller's values (the smoke tests drive the dead-backend path in
    seconds with them)."""
    attempts = int(os.environ.get("LLIE_PROBE_ATTEMPTS", attempts))
    timeout_s = float(os.environ.get("LLIE_PROBE_TIMEOUT_S", timeout_s))
    for _ in range(attempts):
        try:
            p = subprocess.run(
                [sys.executable, "-c", _PROBE_CODE],
                capture_output=True, text=True, timeout=timeout_s,
            )
        except subprocess.TimeoutExpired:
            continue
        if p.returncode == 0 and p.stdout.strip():
            return p.stdout.strip().splitlines()[-1]
    return None
