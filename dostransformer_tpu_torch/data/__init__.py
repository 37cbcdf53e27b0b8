"""Batch-leading padded graph data: samples, collation, npz io, loader."""
