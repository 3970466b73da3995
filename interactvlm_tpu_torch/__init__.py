"""PyTorch/CUDA port of InteractVLM-TPU for NVIDIA Hopper GPUs.

A second package beside ``interactvlm_tpu`` (the JAX reference, which it
never imports). Plain tensor code is PyTorch; the TPU's Pallas attention
kernels are hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use. Entry points run on the GPU unless the caller
passes ``device="cpu"``, where every kernel's plain version runs instead.
"""
