"""Streaming inference over frame sequences (video)."""
