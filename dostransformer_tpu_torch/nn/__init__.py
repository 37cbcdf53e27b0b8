"""Torch modules and initialisers of the eDOS model."""
