"""The port's quality tools (``python -m ergodic_exploration_tpu_torch.tools.<name>``):
the config-4 closed-loop quality run (``quality``) and its plateau
diagnosis (``diag_plateau``)."""
