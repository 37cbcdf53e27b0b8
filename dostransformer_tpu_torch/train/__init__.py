"""Training: loss, metrics, AdamW, the train/eval steps and run helpers."""
