"""Union-find, scatter ops and the hand-written Hopper kernels."""
