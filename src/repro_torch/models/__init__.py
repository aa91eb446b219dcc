"""The dense decoder model: layers, attention, transformer, model API."""
