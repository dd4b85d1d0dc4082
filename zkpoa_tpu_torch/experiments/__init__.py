"""Measurement harnesses of the port (run as modules, e.g.
`python -m zkpoa_tpu_torch.experiments.msm_stages`)."""
