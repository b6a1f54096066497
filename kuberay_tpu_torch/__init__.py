"""PyTorch/CUDA port of kuberay_tpu's compute half, for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``models/``, ``parallel/``,
``serve/``, ``train/``, ``utils/``) and public names; imports ``torch`` and
never ``jax`` or ``kuberay_tpu``.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""
