"""Semantic speaker analysis: BERT dialogue detection and speaker-turn
detection."""
