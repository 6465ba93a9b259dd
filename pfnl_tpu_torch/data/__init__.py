"""Dataset helpers of the port: manifests, frame stores, the training pipeline."""
