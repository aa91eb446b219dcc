"""The training loop's fault tolerance: restarts from checkpoints,
straggler monitor, failure injection."""
