"""Checkpoints and quantized artifacts (counterpart of ``repro/training``;
the trainer, optimizer and data pipeline come with ROADMAP Queue A step 9)."""
