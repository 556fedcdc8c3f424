"""Deterministic host-side data sources and their prefetcher."""
