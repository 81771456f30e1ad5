"""Command-line entry points: ``python -m audioset_convnext_inf_torch.cli.<name>``
with ``demo``, ``evaluate``, ``extract_embeddings``, ``convert``, ``serve``,
``train``, ``export_serving`` or ``inference`` (the PANN zoo's tagging and
sound event detection). Each runs on the card unless given
``--device cpu``."""
