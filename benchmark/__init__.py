"""The benchmark of the PyTorch port (``audioset_convnext_inf_torch``) on
the card: see ``benchmark/run.py``."""
