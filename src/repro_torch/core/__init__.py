"""ML-ECS technique code of the port: LoRA handling and the multimodal
connector."""
