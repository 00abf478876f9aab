"""The port's numbered scripts, one per reference script, run by
``python -m tsr_tpu_torch <command>`` (``tsr_tpu_torch/__main__.py``).

Each file has a ``main(argv=None)``, so callers can also run a script in
process; the shared flags and helpers are in :mod:`._common`.
"""
