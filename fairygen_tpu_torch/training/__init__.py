"""Single-card LoRA training of the Wan DiT (port of fairygen_tpu/training)."""
