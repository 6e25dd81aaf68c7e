"""Host-side utilities: meters and profiling."""
