"""CLIP encoders, the cost aggregator and the CAT-Seg model."""
