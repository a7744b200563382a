"""The spatial filters' plain passes."""
