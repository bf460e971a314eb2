"""Model configurations (the port's own copy of ``repro.configs``)."""
