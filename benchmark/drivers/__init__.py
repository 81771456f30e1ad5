"""Per-traffic-kind drivers of the benchmark."""
