"""Host-side runtime policy: failure and straggler detectors."""
