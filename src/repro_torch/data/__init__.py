"""Data plane: synthetic corpora and MinHash near-duplicate detection."""
