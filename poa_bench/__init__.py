"""The benchmark of zkpoa_tpu_torch: Groth16 proofs of the protocol's layer
circuits on an NVIDIA card, driven by data files (`python -m poa_bench.run`)."""
