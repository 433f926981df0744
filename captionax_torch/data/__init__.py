"""Data-side constants of the port (its own copies; nothing of captionax)."""
