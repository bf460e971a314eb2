"""The plain PyTorch reference of the federated round."""
