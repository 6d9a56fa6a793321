"""Synthetic corpus generation."""
