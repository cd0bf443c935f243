"""testing of the PyTorch port: the seeded fault-injection seams
(``testing/faults.py``), with the JAX package's site names."""
