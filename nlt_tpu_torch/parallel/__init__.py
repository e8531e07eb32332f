"""Training steps of the port (parallel/train.py)."""
