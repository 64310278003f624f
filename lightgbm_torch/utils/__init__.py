"""Logging and errors."""
