"""Model configs and the dense decoder as plain functions over tensor dicts."""
