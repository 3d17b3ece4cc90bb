"""Online continual learning: streams and algorithms."""
