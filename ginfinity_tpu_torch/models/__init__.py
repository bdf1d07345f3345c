"""GINE model configuration, parameters and checkpoint I/O."""
