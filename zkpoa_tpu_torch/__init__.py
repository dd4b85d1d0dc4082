"""zkpoa_tpu_torch: the proof-of-assets Groth16 stack on PyTorch and CUDA.

A port of `zkpoa_tpu` (JAX/Pallas on a TPU) to an NVIDIA Hopper card. The
hot kernels are CUDA C++ under `csrc/`, built with nvcc at first use
(`_build.py`); every kernel has a plain torch twin that CPU tensors take.
The port shares the JAX package's pure-Python modules (fields, circuit
frontend, host pairing verifier, serde) and never imports `jax`.
"""
