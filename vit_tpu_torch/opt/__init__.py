"""Hyperparameter search: the LR/scheduler grid (:mod:`.parallel_sweep`)
and the W&B sweep agent (:mod:`.agent`)."""
