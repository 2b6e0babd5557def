"""Workflows of the port from end to end (counterparts of the repository's
examples/): end_to_end_synthetic."""
