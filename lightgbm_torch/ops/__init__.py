"""Tree traversal on binned data."""
