"""Pipelines: the G2 frame processor, detector and streaming pipeline."""
