"""Hand-written CUDA kernels (K1-K4), their plain torch versions and the drain pipeline."""
