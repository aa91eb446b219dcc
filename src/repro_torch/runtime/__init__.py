"""Fault tolerance: the training loop's restarts from checkpoints,
straggler monitor and failure injection, and the serving chaos injector."""
