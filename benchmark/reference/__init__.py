"""Plain float32 references of the configurations' networks."""
