"""Training-side helpers of the port (slice 1: theta synthesis only)."""
