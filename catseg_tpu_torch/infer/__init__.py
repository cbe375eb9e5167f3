"""Sliding-window inference."""
