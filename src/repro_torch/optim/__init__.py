"""Per-stage optimizers over tensor dicts."""
