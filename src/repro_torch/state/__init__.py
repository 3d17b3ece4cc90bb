"""The engine's live state."""
