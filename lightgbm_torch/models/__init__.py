"""Boosting engines."""
