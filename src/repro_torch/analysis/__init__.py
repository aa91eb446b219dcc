"""Concurrency contracts of the serving stack (`contracts.py`): the lock
and owner annotations the lock checker reads, and the REPRO_TSAN runtime
shim."""
