"""The port's example CLIs: ``python -m gelly_torch.examples.<name>``.

Each is ``gelly_tpu``'s ``examples/<name>.py`` on ``gelly_torch``: the same
positional arguments, flags, refusals and stdout, plus ``--device=DEV``
(default ``cuda``; a CUDA request on a machine without a card raises,
it never falls back to the CPU). ``main(args)`` is the entry point
tests and ``chip_smoke.py`` call in process.
"""
