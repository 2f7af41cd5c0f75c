"""bio_diffusion_torch: the PyTorch/CUDA port of bio_diffusion_tpu for NVIDIA Hopper.

The JAX package ``bio_diffusion_tpu`` stays the reference; this package
mirrors its module names and serves QM9 unconditional generation with the
GCPNet denoiser.  Each message-passing layer runs the hand-written CUDA
kernel in ``csrc/message_layer.cu`` on CUDA tensors and its plain PyTorch
version on CPU tensors.  Nothing here imports jax.
"""

__version__ = "0.1.0"
