"""Training: the BaF protocol (``baf_trainer``) and checkpoints."""
