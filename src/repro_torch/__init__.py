"""PyTorch + CUDA port of the GF-DiT serving system (the JAX package
``repro`` is the reference it is checked against)."""
