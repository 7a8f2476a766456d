"""Host utilities (prefetch threading)."""
