"""Host-side image transforms."""
