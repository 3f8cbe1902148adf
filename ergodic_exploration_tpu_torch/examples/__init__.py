"""Runnable examples of the port (``python -m ergodic_exploration_tpu_torch.examples.<name>``)."""
