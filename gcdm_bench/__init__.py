"""GCDM benchmark of the PyTorch and CUDA port (``bio_diffusion_torch``) on an H100."""
