"""Logical-axis sharding rules and the layout autotuner (host-only)."""
