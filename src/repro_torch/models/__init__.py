"""Model definitions (the split CNN)."""
