"""Device operators with hand-written CUDA kernels (B1 histogram, B2 split)."""
