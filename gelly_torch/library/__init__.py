"""One-pass graph algorithms."""
