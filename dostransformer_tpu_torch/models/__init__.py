"""Models, registry and weight import."""
