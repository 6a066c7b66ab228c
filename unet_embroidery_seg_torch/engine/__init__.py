"""Step functions and checkpoints."""
