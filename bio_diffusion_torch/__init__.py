"""bio_diffusion_torch: the PyTorch/CUDA port of bio_diffusion_tpu for NVIDIA Hopper.

The JAX package ``bio_diffusion_tpu`` stays the reference; this package
mirrors its module names, serves QM9 unconditional generation with the
GCPNet denoiser, trains it on QM9 files on disk with checkpoints and
resume, and samples and evaluates what it trained.  Each hand-written CUDA kernel (``csrc/``)
runs on CUDA tensors and its plain PyTorch version on CPU tensors.  Nothing
here imports jax or anything of the JAX package: the port keeps its own
copies of the configuration and chemistry code it needs.
"""

__version__ = "0.1.0"
