"""Training-side helpers of the port (slice 1: theta synthesis and style ids)."""
