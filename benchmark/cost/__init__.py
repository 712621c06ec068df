"""Frozen work counts and the card's peaks (``work.py``, ``peaks.json``)."""
