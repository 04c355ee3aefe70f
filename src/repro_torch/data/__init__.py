"""The deterministic, host-shardable synthetic data pipeline."""
