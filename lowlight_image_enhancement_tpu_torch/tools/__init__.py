"""The system's tools on the port, counterparts of the repository's
``tools/*.py`` that import the JAX package. Each runs as::

    python -m lowlight_image_enhancement_tpu_torch.tools.<name> [flags]

with its JAX tool's flags, defaults and output, plus ``--device`` (``cuda``
unless the caller asks for ``cpu``, which runs the plain versions of the
kernels), and exposes ``main(argv=None)``, which returns what it prints.

- ``evaluate`` -- the metric suite over a config's split, a JSON report;
- ``profile_train`` -- forward, ``grad(L1)`` and the train step per loss
  subset, chained and synchronized;
- ``profile_step_families`` -- device time per kernel family of the
  flagship step from a ``torch.profiler`` trace;
- ``debug_losses`` / ``debug_overfit`` / ``debug_dataset`` -- the
  debug-first harnesses;
- ``create_sid_pack`` / ``convert_sid_raw_to_png`` /
  ``make_niqe_params`` -- the offline data and NIQE-model tools;
- ``bench_input_pipeline`` / ``train_pipeline_e2e`` -- the host loader's
  rate, and the loader against the card's step.

The tools that import no package (``prepare_sid_manifest.py``, the
``convert_*_weights.py`` converters, ``fetch_pretrained_weights.py``) serve
the port as they are.
"""
