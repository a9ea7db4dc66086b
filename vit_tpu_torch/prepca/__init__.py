"""prepca of the vit_tpu_torch port."""
