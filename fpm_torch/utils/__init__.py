"""Outputs, metrics logging, checkpoints and phase timers."""
