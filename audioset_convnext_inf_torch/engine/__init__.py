"""Engine: evaluation (metrics, the evaluator on one device or several),
inference front ends (tagging, long audio, embedding extraction), the
tagging service, AOT serving bundles (``aot_export``: ``export_serving``,
``export_serving_shared``, ``save_bundle``, ``load_bundle``,
``ServingBundle``, ``BundleModel``), and training (losses, optimizer and
schedules, the trainer on one card or data-parallel)."""
