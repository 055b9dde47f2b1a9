"""The program's own spans and counters, as the metric readers see them.

The measured package records named host-time spans and counters while a
profiler runs (``lowlight_image_enhancement_tpu_torch.utils.profiling``:
``record()``). The harness's profiler runs only over the ``--trace 1``
tail, so after a run the record holds exactly the traced calls or
steps. A package without the recorder, or a run that recorded nothing,
gives every reader None.
"""

from __future__ import annotations

from typing import Iterable, Optional

# the program's top-level span of one unit: a served call, a training step
UNIT_SPAN = {"serve": "serving.predict", "train": "trainer.step"}


def record() -> Optional[dict]:
    """``record()`` of the measured package, or None where it has none."""
    try:
        from lowlight_image_enhancement_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "record", None)
    return read() if callable(read) else None


def ms_per_unit(run, names: Iterable[str]) -> Optional[float]:
    """Host ms of the spans named ``names``, summed, over the number of
    recorded units (``serving.predict`` or ``trainer.step`` spans)."""
    rec = record()
    if rec is None or run.kind not in UNIT_SPAN:
        return None
    names = set(names)
    units = sum(s.name == UNIT_SPAN[run.kind] for s in rec["spans"])
    mine = [s.t1 - s.t0 for s in rec["spans"] if s.name in names]
    if not units or not mine:
        return None
    return 1e3 * sum(mine) / units


def counter_share(part: str, whole: str) -> Optional[float]:
    """Percent: counter ``part`` over counter ``whole``."""
    rec = record()
    if rec is None or not rec["counters"].get(whole):
        return None
    return 100.0 * rec["counters"].get(part, 0) / rec["counters"][whole]
