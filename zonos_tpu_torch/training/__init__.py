"""Training: the train step, LoRA fine-tuning and the data pipeline."""
