"""Model code of the port: layers, the dense transformer, the paged serving
contract and the model factory."""
