"""The benchmark's yardstick: spec loading, traffic generation, weights,
operation counts and peaks, trace reduction, the plain reference and the
comparison that decides ``correct``.

Nothing here imports ``jax``, ``vit_tpu`` or ``vit_tpu_torch`` at module
level; only the drivers (``benchmark/drivers/``) call into the program.
"""
