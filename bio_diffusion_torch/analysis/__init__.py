"""Offline analysis: aggregation, bust comparisons, plots, QM recomputation
(the PyTorch package's copies of ``bio_diffusion_tpu/analysis``)."""
