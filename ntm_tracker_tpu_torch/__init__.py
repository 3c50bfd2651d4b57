"""PyTorch/CUDA port of ntm_tracker_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths. Imports torch and numpy only.
Entry points run on cuda unless the caller passes device="cpu".
"""
