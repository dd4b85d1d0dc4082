"""Device kernels and their torch plumbing."""
