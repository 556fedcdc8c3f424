"""Paged-KV serving: host allocator, scheduler, telemetry and the engine."""
