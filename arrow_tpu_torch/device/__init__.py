"""Device-resident columns and batches."""
