"""Stream sources the trainer consumes."""
