"""Training of the port: every family's Trainer, and EasyFlow pre-training."""
