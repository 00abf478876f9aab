"""Training: the unified ResUNet step (``common``) and its trainer
(``loops``)."""
