"""Utilities: terminal narration."""
