"""Optimizer (AdamW with f32 state and master weights) and ternary
gradient compression with error feedback."""
