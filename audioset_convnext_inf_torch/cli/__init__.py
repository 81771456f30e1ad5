"""Command-line entry points: ``python -m audioset_convnext_inf_torch.cli.<name>``
with ``demo``, ``evaluate``, ``extract_embeddings``, ``convert``, ``serve``,
``train`` or ``export_serving``. Each runs on the card unless given
``--device cpu``."""
