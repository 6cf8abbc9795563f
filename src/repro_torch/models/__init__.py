"""Paper models (PyTorch port of `repro.models.nn` / `repro.models.small`)."""
