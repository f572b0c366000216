"""Plain references, one module per family of configurations (a config
file names its module under "reference")."""
