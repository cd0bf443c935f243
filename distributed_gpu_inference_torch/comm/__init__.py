"""Data-plane transport of the PyTorch port: the KV handoff and migration
routes on the standard library (``data_plane.py``)."""
